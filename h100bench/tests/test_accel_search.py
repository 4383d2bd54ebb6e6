"""The cell ``fdas.z200.n2e23`` (configuration ``accel_search``) on the
CPU: its files, its work counts, the readers ``plane_bytes`` and
``plane_roofline``, and whole runs cut to a size the CPU holds (2 trials
of 2^13 samples, zmax 8), in which the control and planted faults read
``correct`` false."""

from __future__ import annotations

import math
import sys
import types

import pytest

from h100bench import control, harness, peaks, spec, traffic
from h100bench.tests.conftest import run_tiny
from h100bench.trace import Timeline

CELL = "fdas.z200.n2e23"


def _tiny() -> spec.Cell:
    """The cell at 2 trials of 2^13 samples a call, checked a trial at a
    time, against 9 templates (zmax 8) in the program and the reference
    alike."""
    cell = spec.cell(CELL)
    cell.traffic.update(n=1 << 13, rows=2, blocks=2, warmup_steps=1,
                        sampled_steps=2, check_rows=1)
    cell.config["step"][1]["kwargs"]["zmax"] = 8
    cell.reference.ZMAX = 8
    return cell


def _reader(name: str):
    return spec.load_module(spec.ROOT / "layers" / f"{name}.py")


def test_the_configuration_and_traffic_load():
    t = spec.read_traffic(CELL)
    assert (t["n"], t["rows"], t["blocks"]) == (1 << 23, 2, 2)
    assert (t["warmup_steps"], t["sampled_steps"], t["check_rows"]) == (
        4, 3, 1)
    assert set(t["limits"]) == {"rfft_large_err", "plane_err"}
    cell = spec.cell(CELL)
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert cell.config["program"]["api"] == "smfft_tpu_torch"
    assert [c["call"] for c in cell.config["step"]] == ["rfft_large",
                                                       "accel_plane"]
    kwargs = cell.config["step"][1]["kwargs"]
    assert (kwargs["zmax"], kwargs["dz"]) == (cell.reference.ZMAX,
                                              cell.reference.DZ) == (
        cell.work.ZMAX, cell.work.DZ) == (200, 2)
    assert (cell.config["templates"], cell.config["template_taps"]) == (
        cell.work.templates(), cell.work.taps()) == (201, 233)
    names = {m.name for m in cell.per_layer}
    assert {"plane_bytes", "plane_roofline", "kernel_roofline"} <= names
    assert "pass_roofline" not in names
    assert {m.name for m in cell.end_to_end} == {"gbps", "step_ms.p95",
                                                 "setup_s"}


def test_work_counts_at_the_cells_size():
    """Per trial: 2^23 float32 samples in (32 MiB), the spectrum of 2^22 +
    1 complex64 bins out and in again, and a plane of 201 (2^22 + 1)
    float32; 2310 segments of 2048 (hop 1816), each 5 N log2 N + 201 (5 N
    log2 N + 6 N) = 25 223 168 operations."""
    cell = spec.cell(CELL)
    t = cell.traffic
    n, bins = 1 << 23, (1 << 22) + 1
    assert cell.work.plane_bytes(t) == 2 * (8 * bins + 4 * 201 * bins)
    assert cell.work.step_bytes(t) == 2 * (4 * n + 8 * bins) + \
        cell.work.plane_bytes(t) == 6_945_769_064
    assert cell.work.plane_flops(t) == 2 * 2310 * 25_223_168
    assert cell.work.step_flops(t) == 2 * 2.5 * n * 23 + \
        cell.work.plane_flops(t)
    least, bound = peaks.least_seconds(cell.work.step_bytes(t),
                                       cell.work.step_flops(t))
    assert bound == "bytes" and least == pytest.approx(2.0734e-3, rel=1e-4)
    # the plane alone: its bytes (2.033 ms) over its operations (1.739 ms)
    assert cell.work.plane_floor_s(t) == pytest.approx(
        cell.work.plane_bytes(t) / peaks.BYTES_PER_S, rel=1e-12)
    assert cell.work.plane_flops(t) / peaks.FP32_PER_S == pytest.approx(
        1.7393e-3, rel=1e-4)


def _run_with(ops, steps=1) -> harness.Run:
    run = harness.Run(cell=spec.cell(CELL), steps=steps)
    run.timeline = Timeline(ops, 0, 10**9)
    return run


def test_plane_roofline_reads_nothing_without_an_operation_of_the_plane():
    read = _reader("plane_roofline").read
    assert read(_run_with([])) is None
    assert read(_run_with([("fourstep_pass_kernel<512, false>", 0, 500),
                           ("real_huge_kernel<float2>", 600, 900)])) is None
    run = _run_with([("conv_kernel<2048, false, true>", 0, 500)])
    run.timeline = None
    assert read(run) is None
    # a work module without plane_floor_s (the other configurations)
    run = harness.Run(cell=spec.cell("rfftlarge.n2e23.bulk"), steps=1)
    run.timeline = Timeline([("conv_kernel<2048, false, true>", 0, 500)],
                            0, 1000)
    assert read(run) is None


def test_plane_roofline_is_100_when_the_plane_takes_its_floor():
    """Two steps whose operations other than rfft_large's sum to twice the
    floor read 100 %; rfft_large's passes do not count; twice as long, 50
    %."""
    read = _reader("plane_roofline").read
    floor = spec.cell(CELL).work.plane_floor_s(
        spec.read_traffic(CELL))
    total = round(2 * floor * 1e9)
    parts = [("conv_kernel<2048, false, true>", 0.3),
             ("at::native::vectorized_elementwise_kernel<4, hypot>", 0.5),
             ("at::native::vectorized_elementwise_kernel<4, pow>", 0.2)]
    ops, t = [], 0
    for name, share in parts:
        d = round(share * total)
        ops.append((name, t, t + d))
        t += d + 1000
    ops.append(("fourstep_pass_kernel<128, 128, false, true, true>", t,
                t + 10**6))
    assert math.isclose(read(_run_with(ops, steps=2)), 100.0, rel_tol=1e-6)
    slow = [(n, a, a + 2 * (b - a)) for n, a, b in ops]
    assert math.isclose(read(_run_with(slow, steps=2)), 50.0, rel_tol=1e-6)


def test_plane_bytes_reads_nothing_without_the_counter(monkeypatch):
    """A program whose launch counters' module has no ``plane_bytes`` (the
    parent of the counter) reports nothing, and does not raise."""
    bare = types.ModuleType("h100bench_no_plane_counter")
    bare.counts = lambda: {}
    monkeypatch.setitem(sys.modules, bare.__name__, bare)
    reader = _reader("plane_bytes")
    run = harness.Run(cell=spec.cell(CELL), steps=4)
    run.cell.config["program"]["launch_counts"] = f"{bare.__name__}:counts"
    reader.start(run)
    reader.stop(run)
    assert reader.read(run) is None


def test_plane_bytes_is_the_counters_rise_over_the_steps(monkeypatch):
    fake = types.ModuleType("h100bench_fake_plane_counter")
    fake.counts = lambda: {}
    fake.value = 1000
    fake.plane_bytes = lambda: fake.value
    monkeypatch.setitem(sys.modules, fake.__name__, fake)
    reader = _reader("plane_bytes")
    run = harness.Run(cell=spec.cell(CELL), steps=4)
    run.cell.config["program"]["launch_counts"] = f"{fake.__name__}:counts"
    reader.start(run)
    fake.value += 4 * 46 * 2**30           # 4 steps of 46 GiB
    reader.stop(run)
    assert reader.read(run) == 46.0


def test_a_tiny_run_is_correct_and_reports_its_metrics():
    cell = _tiny()
    result = run_tiny(cell)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"gbps", "step_ms.p95", "setup_s"}
    for name in ("rfft_large_err", "plane_err"):
        c = result["checks"][name]
        assert 0 < c["value"] <= c["limit"] / 10


def test_a_tiny_traced_run_reports_the_planes_bytes():
    """On the CPU no device operation is traced (``plane_roofline``,
    ``kernel_roofline`` and ``device_idle`` read nothing there; the
    hand-made timelines above hold the roofline) and the plain versions
    launch nothing; the plane's bytes are counted there too."""
    cell = _tiny()
    result = run_tiny(cell, traced=True)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"host_ms", "launches_per_step",
                                      "api_ms", "op_ms", "plane_bytes"}
    # 2 trials of 4097 bins, 9 templates of 41 taps, 256-point segments
    # (hop 216, 19 a trial): frame, bank, crop and power
    rows, bins, m, nf, frames = 2, 4097, 9, 256, 19
    frame = 8 * rows * (bins + (frames - 1) * 216 + nf + 2 * frames * nf)
    conv = 8 * (rows * frames * nf * (1 + m) + m * nf)
    plane = 20 * rows * m * bins
    assert result["metrics"]["plane_bytes"]["value"] == (
        frame + conv + plane) / 2**30


def test_the_control_is_not_correct():
    cell = _tiny()
    result = run_tiny(cell, step=control.control_step(cell))
    assert result["correct"] is False and result["failed"] >= 1
    for name in ("rfft_large_err", "plane_err"):
        c = result["checks"][name]
        assert c["value"] > c["limit"]


def _planted(cell, fault):
    step = traffic.Step(cell.config, cell.traffic)

    def run(x):
        out = step(x)
        plane = out["plane"].clone()
        if fault == "zero":
            plane.zero_()
        elif fault == "half":
            plane[plane.shape[0] // 2:] = 0
        elif fault == "bin":
            plane[1, 3, 1234] += 0.05 * plane.square().mean().sqrt()
        else:
            plane = plane[..., :-1]
        return {"rfft_large": out["rfft_large"], "plane": plane}
    return traffic.Replaced(step.names, run)


@pytest.mark.parametrize("fault", ["zero", "half", "bin", "misshapen"])
def test_a_planted_fault_is_not_correct(fault):
    """The plane left zero, the second trial's plane left out, one bin of
    one template off by 5 % of the plane's rms, or the plane one bin
    short."""
    cell = _tiny()
    result = run_tiny(cell, step=_planted(cell, fault))
    assert result["correct"] is False and result["failed"] >= 1
