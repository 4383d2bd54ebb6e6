"""The cell ``rfftlarge.n2e23.bulk`` (configuration ``periodicity_search``)
on the CPU: its files, its work counts, the reader ``pass_roofline`` on a
hand-made timeline, and whole runs cut to a size the CPU holds, in which
the control and planted faults read ``correct`` false."""

from __future__ import annotations

import math

import pytest

from h100bench import control, harness, peaks, spec, traffic
from h100bench.tests.conftest import run_tiny
from h100bench.trace import Timeline

CELL = "rfftlarge.n2e23.bulk"


def _tiny() -> spec.Cell:
    """The cell at 4 trials of 2^15 samples (pair mode, two passes)."""
    cell = spec.cell(CELL)
    cell.traffic.update(n=1 << 15, rows=4, blocks=2, warmup_steps=1,
                        sampled_steps=2, check_rows=2)
    return cell


def _reader(name: str):
    return spec.load_module(spec.ROOT / "layers" / f"{name}.py")


def test_traffic_loads_and_names_the_compared_output():
    t = spec.read_traffic(CELL)
    assert (t["n"], t["rows"], t["blocks"]) == (1 << 23, 128, 2)
    assert set(t["limits"]) == {"rfft_large_err"}
    cell = spec.cell(CELL)
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert [c["call"] for c in cell.config["step"]] == ["rfft_large"]
    assert "pass_roofline" in {m.name for m in cell.per_layer}


def test_work_counts_at_the_cells_size():
    cell = spec.cell(CELL)
    t = cell.traffic
    rows, n = 128, 1 << 23
    assert cell.work.step_bytes(t) == rows * (4 * n + 8 * (n // 2 + 1))
    assert cell.work.step_bytes(t) == 2**33 + 1024          # 8.59 GB
    assert cell.work.step_flops(t) == rows * 2.5 * n * 23
    assert cell.work.sweep_bytes(t) == 8 * rows * n       # 2^33
    least, bound = peaks.least_seconds(cell.work.step_bytes(t),
                                       cell.work.step_flops(t))
    assert bound == "bytes" and least == pytest.approx(2.5642e-3, rel=1e-4)


def _run_with(ops, traffic_: dict) -> harness.Run:
    run = harness.Run(cell=spec.cell(CELL), steps=1)
    run.cell.traffic.update(traffic_)
    run.timeline = Timeline(ops, 0, 10**9)
    return run


def test_pass_roofline_reads_nothing_without_a_pass():
    read = _reader("pass_roofline").read
    t = {"rows": 128, "n": 1 << 23}
    assert read(_run_with([], t)) is None
    assert read(_run_with([("c2c_kernel<1024, false>", 0, 500)], t)) is None
    run = _run_with([("fourstep_pass_kernel<256, false>", 0, 500)], t)
    run.timeline = None
    assert read(run) is None
    # a work module without sweep_bytes (the other configurations)
    run = harness.Run(cell=spec.cell("real.n1024.bulk"), steps=1)
    run.timeline = Timeline([("real_huge_kernel<float2>", 0, 500)], 0, 1000)
    assert read(run) is None


def test_pass_roofline_is_100_when_each_launch_lasts_its_floor():
    """rows = 1675, n = 1024: a sweep of 8 * 1675 * 1024 bytes at 3.35
    TB/s takes 4096 ns.  Launches of other kernels do not count."""
    read = _reader("pass_roofline").read
    t = {"rows": 1675, "n": 1024}
    floor = 4096
    names = ["fourstep_pass_kernel<256, false>",
             "fourstep_pass_kernel<128, false>",
             "real_huge_kernel<float2>"]
    ops = [(name, 10_000 * i, 10_000 * i + floor)
           for i, name in enumerate(names)]
    ops.append(("Memcpy DtoD (Device -> Device)", 50_000, 90_000))
    assert math.isclose(read(_run_with(ops, t)), 100.0, rel_tol=1e-12)
    # twice the floor each: 50 %
    slow = [(name, a, a + 2 * floor) for name, a, _ in ops[:3]]
    assert math.isclose(read(_run_with(slow, t)), 50.0, rel_tol=1e-12)


def test_a_tiny_run_is_correct_and_reports_its_metrics():
    cell = _tiny()
    result = run_tiny(cell)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {m.name for m in cell.end_to_end} == {
        "gbps", "step_ms.p95", "setup_s"}
    c = result["checks"]["rfft_large_err"]
    assert 0 < c["value"] <= c["limit"] / 10


def test_a_tiny_traced_run_reports_the_host_side_layers():
    """On the CPU no device operation is traced: ``pass_roofline``,
    ``kernel_roofline`` and ``device_idle`` report nothing."""
    result = run_tiny(_tiny(), traced=True)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"host_ms", "launches_per_step",
                                      "api_ms", "op_ms"}


def test_the_control_is_not_correct():
    cell = _tiny()
    result = run_tiny(cell, step=control.control_step(cell))
    assert result["correct"] is False and result["failed"] >= 1
    assert result["checks"]["rfft_large_err"]["value"] > \
        result["checks"]["rfft_large_err"]["limit"]


def _planted(cell, fault):
    step = traffic.Step(cell.config, cell.traffic)

    def run(x):
        y = step(x)["rfft_large"].clone()
        if fault == "zero":
            y.zero_()
        elif fault == "half":
            y[y.shape[0] // 2:] = 0
        else:
            y[1, 12345] += 0.05 * y.abs().square().mean().sqrt()
        return {"rfft_large": y}
    return traffic.Replaced(step.names, run)


@pytest.mark.parametrize("fault", ["zero", "half", "bin"])
def test_a_planted_fault_is_not_correct(fault):
    """The spectrum left zero, half the trials left out, or one bin of one
    trial off by 5 % of the spectrum's rms."""
    cell = _tiny()
    result = run_tiny(cell, step=_planted(cell, fault))
    assert result["correct"] is False and result["failed"] >= 1
