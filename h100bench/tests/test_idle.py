"""The split of the card's idle time by what the host was doing
(``idle.py``, ``idle_*_ms``) on hand-made records and device timelines,
where each value is known."""

from __future__ import annotations

import pytest

from h100bench import harness, idle, spec, trace
from h100bench.tests.conftest import run_tiny, tiny_cell
from h100bench.tests.test_spans import records

BULK = ["c2c.n1024.bulk", "real.n1024.bulk", "real.n4096.bulk",
        "rfftlarge.n2e23.bulk", "fft2.n16384.wlayer", "fdas.z200.n2e23"]
LAYER = {"api": "device, waiting on the API",
         "op": "device, waiting on the op",
         "launch": "device, waiting on the launch",
         "caller": "device, waiting on the caller"}
C = "c2c_kernel<1024, false>"    # the profiler's name of a C2C kernel


class Host:
    """Rows for ``records``: spans opened in order on one thread."""

    def __init__(self):
        self.rows = []

    def span(self, name, start, end, parent=-1):
        self.rows.append((name, start, end, parent, 0))
        return len(self.rows) - 1

    def launch(self, kernel, start, end, parent):
        """``launch:<kernel>`` over [start, end], its ``alloc``, ``tables``
        and ``call`` each a third of it."""
        i = self.span(f"launch:{kernel}", start, end, parent)
        third = (end - start) // 3
        self.span("alloc", start, start + third, i)
        self.span("tables", start + third, start + 2 * third, i)
        self.span("call", start + 2 * third, end, i)
        return i

    def fft(self, t, copy=False):
        """A ``call:fft`` at ``t``: its own time 50 before and 20 after
        the op, the op's own 50 before the launch (30 of them a ``copy``
        where ``copy``) and 30 after it, the launch 150: it returns at
        t + 250."""
        c = self.span("call:fft", t, t + 300)
        o = self.span("op:ordered_c2c", t + 50, t + 280, c)
        if copy:
            self.span("copy", t + 60, t + 90, o)
        self.launch("c2c", t + 100, t + 250, o)
        return t + 250


def run_of(host, ops, lo, hi, steps=1):
    run = harness.Run(cell=spec.cell("c2c.n1024.bulk"), steps=steps)
    run.timeline = trace.Timeline(ops, lo, hi)
    run.scratch["spans"] = records(host.rows)
    return run


def read(name, run):
    return spec.load_module(spec.ROOT / "layers" / f"{name}.py").read(run)


def idle_ns(run):
    tl = run.timeline
    return tl.end_ns - tl.start_ns - tl.busy_ns()


def two_steps():
    """Two steps of one ``fft``, the second's op copying first: its launch
    returns at 250 and 1350, its kernels run 260-1000 and 1420-2000, the
    window is [0, 2100)."""
    host = Host()
    e1 = host.fft(0)
    e2 = host.fft(1100, copy=True)
    assert (e1, e2) == (250, 1350)
    ops = [(C, 260, 1000), (C, 1420, 2000)]
    return host, ops


def test_a_gap_between_steps_is_split_by_the_innermost_span():
    # gap 1: [0, 260) on the card, laid back onto [-10, 250]: 10 before
    # the window and the whole first call (api 50, op 50, launch 150);
    # gap 2: [1000, 1420), 420, laid onto [930, 1350]: the caller 170
    # (the loop), the call's own 50, the op's own 10 and its copy 30
    # and its own 10 again, the launch 150; the tail [2000, 2100) is the
    # caller's
    host, ops = two_steps()
    run = run_of(host, ops, 0, 2100, steps=2)
    assert idle.split(run) == {"api": 100, "op": 100, "launch": 300,
                               "caller": 10 + 170 + 100}
    assert sum(idle.split(run).values()) == idle_ns(run) == 780
    for layer, ns in idle.split(run).items():
        assert read(f"idle_{layer}_ms", run) == pytest.approx(ns / 2 / 1e6)


def test_a_launch_child_and_a_copy_take_their_parents_layer():
    # a gap of 80 laid onto [170, 250]: the launch's tables and call; one
    # of 120 onto [130, 250]: its alloc too
    host = Host()
    host.fft(0)
    for end_gap, want in ((80, {"launch": 80}), (120, {"launch": 120})):
        run = run_of(host, [(C, end_gap, 400)], 0, 400)
        got = idle.split(run)
        assert {k: v for k, v in got.items() if v and k != "caller"} == want
    host = Host()
    c = host.span("call:fft", 0, 300)
    o = host.span("op:ordered_c2c", 10, 290, c)
    host.span("copy", 20, 100, o)
    host.launch("c2c", 100, 250, o)
    got = idle.split(run_of(host, [(C, 570, 600)], 0, 600))
    # [0, 570) idle, laid onto [-320, 250]: before the window 320, the
    # call's own 10, the op's own 10 and its copy 80, the launch 150
    assert got == {"api": 10, "op": 90, "launch": 150, "caller": 320}


def test_a_kernel_queued_before_the_one_ahead_ended_has_no_gap():
    # a step of rfft then irfft: the second launch returns at 500 while
    # the first kernel runs to 1000; the second starts as it ends
    host = Host()
    c = host.span("call:rfft", 0, 300)
    o = host.span("op:rfft", 50, 280, c)
    host.launch("r2c", 100, 250, o)
    c = host.span("call:irfft", 300, 600)
    o = host.span("op:irfft", 350, 580, c)
    host.launch("c2r", 400, 500, o)
    ops = [("r2c_kernel<512, false>", 260, 1000),
           ("c2r_kernel<512, false>", 1000, 1600)]
    got = idle.split(run_of(host, ops, 0, 1700))
    # only the first kernel's gap (260, laid onto [-10, 250]) and the tail
    assert got == {"api": 50, "op": 50, "launch": 150, "caller": 10 + 100}


def test_two_steps_with_a_gap_inside_each():
    # each step: pass 1 (returns at t + 250, runs t + 260 .. t + 400),
    # then the tail's launch in the same op (t + 300 .. t + 450), which
    # starts at t + 460: an in-step gap of 60, laid onto [t + 390, t +
    # 450], the tail's launch alone
    host = Host()
    for t in (0, 1000):
        c = host.span("call:rfft_large", t, t + 500)
        o = host.span("op:rfft_large", t + 50, t + 480, c)
        host.launch("fourstep_pass", t + 100, t + 250, o)
        host.launch("fourstep_pass", t + 300, t + 450, o)
    pass1, tail = ("fourstep_pass_kernel<512, false>",
                   "fourstep_pass_kernel<128, 128, false, true, true>")
    ops = [(pass1, 260, 400), (tail, 460, 900),
           (pass1, 1260, 1400), (tail, 1460, 1900)]
    run = run_of(host, ops, 0, 2000, steps=2)
    got = idle.split(run)
    # the gaps before pass 1: 260 laid onto [-10, 250] (10 before the
    # window, api 50, op 50, launch 150); 360 laid onto [890, 1250]:
    # caller 110 (900-1000), api 50, op 50, launch 150
    assert got == {"api": 100, "op": 100, "launch": 300 + 2 * 60,
                   "caller": 10 + 110 + 100}
    assert sum(got.values()) == idle_ns(run)


def test_the_window_edges_go_to_the_caller():
    # the window opens 1000 before the first call: the first gap's image
    # covers those 1000, no span, and 10 before the window; the idle
    # after the last kernel to the window's end is the caller's too
    host = Host()
    host.fft(1000)
    got = idle.split(run_of(host, [(C, 1260, 1500)], 0, 1800))
    assert got == {"api": 50, "op": 50, "launch": 150,
                   "caller": 1260 - 250 + 300}
    # a window that opens after the first call began: the image's part
    # before it is the caller's
    got = idle.split(run_of(host, [(C, 1260, 1500)], 1150, 1800))
    assert got == {"api": 0, "op": 0, "launch": 100,
                   "caller": 10 + 300}


@pytest.mark.parametrize("case", ["launch without a kernel",
                                  "kernel without a launch",
                                  "names disagree", "a prefix only",
                                  "no device operation", "no records",
                                  "no names from the program"])
def test_no_split_where_the_match_does_not_hold(case, monkeypatch):
    host, ops = two_steps()
    lo, hi = 0, 2100
    if case == "launch without a kernel":
        ops = ops[:1]
    elif case == "kernel without a launch":
        ops = ops + [(C, 2010, 2050)]
    elif case == "names disagree":
        ops = [ops[0], ("r2c_kernel<512, false>", 1420, 2000)]
    elif case == "a prefix only":
        ops = [ops[0], ("c2c_multiple_kernel<1024, false>", 1420, 2000)]
    elif case == "no device operation":
        ops = []
    elif case == "no names from the program":
        monkeypatch.setattr(idle, "launched", lambda: None)
    run = run_of(host, ops, lo, hi, steps=2)
    if case == "no records":
        del run.scratch["spans"]
    assert idle.split(run) is None
    for layer in idle.LAYERS:
        assert read(f"idle_{layer}_ms", run) is None
        assert read(f"idle_{layer}_ms.blocks", run) is None


US = 1000                       # ns


def _long_window():
    """20 steps of one ``fft`` every 900 us from 2 ms on (the window opens
    2 ms before the first call and closes 2 ms after the last kernel): the
    host path in us as ``Host.fft`` has it in ns units, each kernel 600 us
    long, 40 us after its launch returned."""
    host, ops = Host(), []
    for s in range(20):
        t = (2000 + 900 * s) * US
        c = host.span("call:fft", t, t + 300 * US)
        o = host.span("op:ordered_c2c", t + 50 * US, t + 280 * US, c)
        host.launch("c2c", t + 100 * US, t + 250 * US, o)
        ops.append((C, t + 290 * US, t + 890 * US))
    return host, ops, 0, ops[-1][2] + 2000 * US


def test_the_four_sum_to_device_idles_idle():
    host, ops, lo, hi = _long_window()
    run = run_of(host, ops, lo, hi, steps=20)
    got = idle.split(run)
    idle_share = read("device_idle", run) / 100
    total = sum(read(f"idle_{layer}_ms", run) for layer in idle.LAYERS)
    assert total * 20 * 1e6 == pytest.approx(idle_share * (hi - lo))
    assert sum(got.values()) == idle_ns(run)
    # each gap laid onto [e - g, e] covers its call whole: its own 50 us
    # before the op, the op's own 50, the launch 150
    assert got == {"api": 20 * 50 * US, "op": 20 * 50 * US,
                   "launch": 20 * 150 * US, "caller": got["caller"]}


@pytest.mark.parametrize("shift,stretch", [(1_500_000, 0.0),
                                           (-1_500_000, 0.0),
                                           (0, 1.5e-3), (1_500_000, 1.5e-3)])
def test_a_device_clock_off_the_hosts_changes_no_reading(shift, stretch):
    """The device's timeline moved by 1.5 ms and stretched by 1.5e-3
    against the spans (the profiler's device clock against the host's, as
    far apart as they have been seen): every gap is read on the device clock and laid back
    from its launch's return, so what the card waited on inside the
    program does not move, and the caller's share moves only by what the
    stretch does to the window's idle time, which ``device_idle`` reads
    too (a pure shift inside the window moves nothing)."""
    host, ops, lo, hi = _long_window()
    base_run = run_of(host, ops, lo, hi)
    base = idle.split(base_run)
    mid = (lo + hi) // 2
    moved = [(n, round(mid + (a - mid) * (1 + stretch)) + shift,
              round(mid + (b - mid) * (1 + stretch)) + shift)
             for n, a, b in ops]
    run = run_of(host, moved, lo, hi)
    got = idle.split(run)
    for layer in ("api", "op", "launch"):
        assert got[layer] == base[layer]
    assert got["caller"] - base["caller"] == idle_ns(run) - idle_ns(base_run)
    if not stretch:
        assert got == base


def test_a_tiny_cpu_run_reads_no_split():
    """On the CPU the profiler traces no device operation: no split."""
    result = run_tiny(tiny_cell("c2c.n1024.bulk"), traced=True)
    assert result["correct"] is True
    assert not any(name.startswith("idle_") for name in result["metrics"])
    assert "api_ms" in result["metrics"]


def test_a_kernel_is_named_by_its_function_and_template():
    assert idle.runs("c2c_kernel<1024, false>", "c2c_kernel")
    assert not idle.runs("c2c_multiple_kernel<1024, false>", "c2c_kernel")
    assert not idle.runs("conv_plane_kernel<2048, false>", "conv_kernel")
    # a name that runs on past another's is not it
    assert not idle.runs("c2c_kernel_tail<1024>", "c2c_kernel")
    assert idle.launched()["launch:conv_plane"] == "conv_plane_kernel"


def test_the_eight_entries():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for layer, name in LAYER.items():
        base = f"idle_{layer}_ms"
        assert entries[base] == {
            "name": base, "unit": "ms", "better": "lower",
            "source": "device_trace", "layer": name,
            "moves": "gbps" if layer == "caller" else "step_ms.p95",
            "workloads": BULK}
        assert entries[f"{base}.blocks"] == {
            "name": f"{base}.blocks", "unit": "ms", "better": "lower",
            "source": "device_trace", "layer": name, "moves": "gbps.blocks",
            "workloads": ["c2c.n1024.blocks"]}
        one = spec.load_module(spec.ROOT / "layers" / f"{base}.py")
        blocks = spec.load_module(spec.ROOT / "layers" / f"{base}.blocks.py")
        assert one.start is blocks.start and one.stop is blocks.stop
        assert one.read.__code__ is blocks.read.__code__
