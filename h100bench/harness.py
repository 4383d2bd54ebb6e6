"""One run of one cell: set-up, warm-up, the measured window, the trace,
the comparison with the reference, and the result line.

The window is a closed loop of one caller: each step issues the
configuration's calls on the next input block of the ring and waits for
them (``torch.cuda.synchronize()``) before the next step.  Each step's
time is read on the card: a CUDA event recorded before its first call and
one after its last.  Outputs of a sample of the window's steps, drawn from
the seed (reservoir sampling), are kept and compared with the plain
reference once the window has closed.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import random
import sys
import time

import torch

from h100bench import check, device as dev, peaks, spec, trace, traffic


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: spec.Cell
    setup_s: float = 0.0
    steps: int = 0
    window_s: float = 0.0
    step_ms: list[float] = dataclasses.field(default_factory=list)
    host_ns: int = 0
    work_bytes: int = 0
    work_flops: float = 0.0
    timeline: trace.Timeline | None = None
    scratch: dict = dataclasses.field(default_factory=dict)


class _Timer:
    """A step's time: CUDA events on the card, the host clock otherwise
    (the harness's tests on the CPU)."""

    def __init__(self, device: str):
        self.cuda = device == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t0 = time.perf_counter_ns()

    def stop(self):
        if self.cuda:
            self.b.record()

    def ms(self) -> float:
        """After a synchronize."""
        if self.cuda:
            return self.a.elapsed_time(self.b)
        return (time.perf_counter_ns() - self.t0) / 1e6


class _Parts:
    """Set-up's parts, each timed from the end of the one before."""

    def __init__(self, t_process: int):
        self.last, self.parts = t_process, []

    def mark(self, name: str):
        now = time.perf_counter_ns()
        self.parts.append((name, (now - self.last) / 1e9))
        self.last = now

    def line(self) -> str:
        return ", ".join(f"{n} {v:.3f}" for n, v in self.parts)


def _sync(device: str):
    if device == "cuda":
        torch.cuda.synchronize()


def _attr(path: str):
    """``"module:attribute"`` of the program."""
    mod, _, name = path.partition(":")
    return getattr(importlib.import_module(mod), name)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: str, t_process: int, step=None) -> dict:
    """Run ``cell`` once and return its result line.  ``t_process`` is the
    ``perf_counter_ns`` at process start; ``step`` replaces the program's
    step (the control, or a fault planted in a test)."""
    t = cell.traffic
    run = Run(cell=cell)
    parts = _Parts(t_process)
    parts.mark("imports and the look for a card")
    if device == "cuda":
        torch.zeros(1, device=device)
        _sync(device)
        parts.mark("CUDA context")
    run.work_bytes = cell.work.step_bytes(t)
    run.work_flops = cell.work.step_flops(t)
    least, bound = peaks.least_seconds(run.work_bytes, run.work_flops)
    log(f"cell {cell.name}: {t['rows']} rows of {t['n']} a call, "
        f"{t['blocks']} input blocks; a step moves {run.work_bytes} bytes "
        f"and {run.work_flops:.6g} fp32 operations; least time "
        f"{least * 1e3:.6f} ms, bound by {bound}")

    if step is None:
        step = traffic.Step(cell.config, t)
    parts.mark("the program's import")
    if device == "cuda" and "load" in cell.config["program"]:
        _attr(cell.config["program"]["load"])()
        built = _attr(cell.config["program"]["build_seconds"])
        log("kernel library: " + (f"built in {built:.1f} s" if built
                                  else "loaded from its build cache"))
        parts.mark("kernel library")
    inputs = traffic.make_inputs(cell.config, t, seed, device)
    _sync(device)
    parts.mark("inputs")
    nb, k = len(inputs), int(t["sampled_steps"])

    # warm-up: every shape of the window, with as many outputs alive at
    # once as the window holds (the sample, and the step in flight)
    kept = []
    for i in range(max(int(t["warmup_steps"]), k + 1)):
        outs = step(inputs[i % nb])
        if len(kept) < k:
            kept.append(outs)
        del outs
    _sync(device)
    del kept
    parts.mark("warm-up")

    readers = cell.per_layer if traced else cell.end_to_end
    for m in readers:
        if hasattr(m.reader, "start"):
            m.reader.start(run)
    profile = trace.Profile(device) if traced else None
    if profile is not None:
        profile.__enter__()
        _sync(device)
    step.marks.clear()
    # what set-up made stays out of the collector's full passes
    gc.collect()
    gc.freeze()
    timer = _Timer(device)
    rng = random.Random(f"sample {seed}")
    sample: list[tuple[int, dict]] = []
    clock = time.perf_counter_ns
    offset = time.time_ns() - clock()
    t_begin = clock()
    run.setup_s = (t_begin - t_process) / 1e9
    parts.mark("trace and collector" if traced else "collector")
    log("set-up parts (s): " + parts.line())
    deadline = t_begin + int(seconds * 1e9)
    i = 0
    while True:
        b = i % nb
        timer.start()
        outs = step(inputs[b])
        timer.stop()
        _sync(device)
        t2 = clock()
        run.step_ms.append(timer.ms())
        if i < k:
            sample.append((b, outs))
        else:
            j = rng.randrange(i + 1)
            if j < k:
                sample[j] = (b, outs)
        del outs
        i += 1
        if t2 >= deadline:
            break
    run.steps = i
    run.window_s = (t2 - t_begin) / 1e9
    marks = step.marks
    run.host_ns = sum(marks[1::2]) - sum(marks[0::2])
    log(f"host time inside the public calls: {run.host_ns / i / 1e6:.6f} "
        f"ms a step ({'traced' if traced else 'untraced'})")
    for m in readers:
        if hasattr(m.reader, "stop"):
            m.reader.stop(run)
    breakdown = None
    if profile is not None:
        profile.__exit__(None, None, None)
        run.timeline = profile.timeline(t_begin + offset, t2 + offset)
        ops = run.timeline.ops
        if ops:
            log(f"trace: {len(ops)} device operations; the first starts "
                f"{(ops[0][1] - run.timeline.start_ns) / 1e3:.1f} us into "
                f"the window, the last ends "
                f"{(run.timeline.end_ns - max(e for _, _, e in ops)) / 1e3:.1f}"
                " us before its end")
            breakdown = {
                "device_ops": [[n, v / 1e9]
                               for n, v in run.timeline.by_name()[:10]],
                "idle_gaps": [[n, v / 1e9]
                              for n, v in run.timeline.idle_between()[:10]]}
        else:
            log("trace: the profiler recorded no device operation")

    metrics = {}
    for m in readers:
        v = m.reader.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    device_info = dev.describe(device, cell.chips)
    device_info["memory_peak_bytes"] = dev.memory_peak(device)
    if run.timeline is not None:
        device_info["busy_s"] = run.timeline.busy_ns() / 1e9
        device_info["window_s"] = run.window_s
    log(f"window: {run.steps} steps in {run.window_s:.6f} s; set-up "
        f"{run.setup_s:.3f} s")

    # the comparison, once the program's state is freed
    del step, profile
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    per_step = [check.readings(cell.reference, inputs[b], outs,
                               int(t["check_rows"]))
                for b, outs in sample]
    del sample
    limits = t["limits"]
    worst, failed = check.judge(per_step, limits)
    correct = bool(per_step) and failed == 0
    checks = {name: {"value": _finite(worst.get(name)), "limit": limit}
              for name, limit in limits.items()}
    for name, c in checks.items():
        log(f"check {name} = {c['value']} (limit {c['limit']}) over "
            f"{len(per_step)} sampled steps")
    result = {"correct": correct, "attempted": run.steps, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _finite(v):
    return v if v is not None and math.isfinite(v) else None
