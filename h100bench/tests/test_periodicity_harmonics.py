"""The cell ``hsum.h32.n2e23`` (configuration ``periodicity_harmonics``) on
the CPU: its files, its work counts, the readers ``harmonic_bytes`` and
``harmonic_roofline``, and whole runs cut to a size the CPU holds (4 trials
of 2^12 samples), in which the control and planted faults read ``correct``
false."""

from __future__ import annotations

import math
import sys
import types

import pytest

from h100bench import control, harness, peaks, spec, traffic
from h100bench.tests.conftest import run_tiny
from h100bench.trace import Timeline

CELL = "hsum.h32.n2e23"


def _tiny() -> spec.Cell:
    """The cell at 4 trials of 2^12 samples a call, checked 2 trials at a
    time, at its 32 harmonics."""
    cell = spec.cell(CELL)
    cell.traffic.update(n=1 << 12, rows=4, blocks=2, warmup_steps=1,
                        sampled_steps=2, check_rows=2)
    return cell


def _reader(name: str):
    return spec.load_module(spec.ROOT / "layers" / f"{name}.py")


def test_the_configuration_and_traffic_load():
    t = spec.read_traffic(CELL)
    assert (t["n"], t["rows"], t["blocks"]) == (1 << 23, 128, 2)
    assert (t["warmup_steps"], t["sampled_steps"], t["check_rows"]) == (
        4, 3, 8)
    assert set(t["limits"]) == {"rfft_large_err", "snr_err"}
    assert t["limits"]["rfft_large_err"] == 2e-4
    cell = spec.cell(CELL)
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert cell.config["program"]["api"] == "smfft_tpu_torch"
    assert [c["call"] for c in cell.config["step"]] == ["rfft_large",
                                                       "harmonic_sum"]
    assert cell.config["step"][1]["kwargs"] == {"harmonics": 32,
                                                "precision": "highest"}
    assert cell.config["harmonics"] == cell.reference.HARMONICS == \
        cell.work.HARMONICS == 32
    assert cell.config["interbinned_points"] == cell.work.points(t)
    names = {m.name for m in cell.per_layer}
    assert {"harmonic_bytes", "harmonic_roofline", "kernel_roofline",
            "launches_per_step", "idle_caller_ms", "pass_roofline",
            "copy_bytes"} <= names
    assert not names & {"plane_bytes", "plane_roofline"}
    assert {m.name for m in cell.end_to_end} == {"gbps", "step_ms.p95",
                                                 "setup_s"}


def test_work_counts_at_the_cells_size():
    """Per trial: 2^23 float32 samples in (32 MiB), the spectrum of 2^22 +
    1 complex64 bins out and in again, and 2^23 + 1 float32 SNRs out: 16
    GiB a step; 32 + sum_h floor(2^23 / h) harmonic terms a trial."""
    cell = spec.cell(CELL)
    t = cell.traffic
    n, bins, m = 1 << 23, (1 << 22) + 1, (1 << 23) + 1
    assert cell.work.harmonic_bytes(t) == 128 * (8 * bins + 4 * m)
    assert cell.work.step_bytes(t) == 128 * (4 * n + 8 * bins) + \
        cell.work.harmonic_bytes(t) == 17_179_871_744
    terms = cell.work.terms(t)
    assert terms == 32 + sum((m - 1) // h for h in range(1, 33))
    # a brute count over the fundamentals at a small size
    small = dict(t, n=1000)
    brute = 32 + sum(min(32, 1000 // i) for i in range(1, 1001))
    assert cell.work.terms(small) == brute
    assert cell.work.harmonic_flops(t) == 128 * (8.0 * bins + 4.0 * terms)
    assert cell.work.step_flops(t) == 128 * 2.5 * n * 23 + \
        cell.work.harmonic_flops(t)
    least, bound = peaks.least_seconds(cell.work.step_bytes(t),
                                       cell.work.step_flops(t))
    assert bound == "bytes" and least == pytest.approx(5.1283e-3, rel=1e-4)
    # the harmonic sum alone: its bytes (2.564 ms) over its operations
    assert cell.work.harmonic_floor_s(t) == pytest.approx(
        cell.work.harmonic_bytes(t) / peaks.BYTES_PER_S, rel=1e-12)
    assert cell.work.harmonic_floor_s(t) == pytest.approx(2.5642e-3,
                                                          rel=1e-4)
    assert cell.work.harmonic_flops(t) / peaks.FP32_PER_S < 0.15 * \
        cell.work.harmonic_floor_s(t)
    # one huge-N pass: the 2^22 complex points of each of 128 trials, read
    # and written once
    assert cell.work.sweep_bytes(t) == 128 * (1 << 22) * 8 * 2


def _run_with(ops, steps=1) -> harness.Run:
    run = harness.Run(cell=spec.cell(CELL), steps=steps)
    run.timeline = Timeline(ops, 0, 10**9)
    return run


def test_harmonic_roofline_reads_nothing_without_an_operation_of_the_sum():
    read = _reader("harmonic_roofline").read
    assert read(_run_with([])) is None
    assert read(_run_with([("fourstep_pass_kernel<512, false>", 0, 500),
                           ("real_huge_kernel<float2>", 600, 900)])) is None
    run = _run_with([("harmonic_sum_kernel<false>", 0, 500)])
    run.timeline = None
    assert read(run) is None
    # a work module without harmonic_floor_s (the other configurations)
    run = harness.Run(cell=spec.cell("fdas.z200.n2e23"), steps=1)
    run.timeline = Timeline([("harmonic_sum_kernel<false>", 0, 500)], 0,
                            1000)
    assert read(run) is None


def test_harmonic_roofline_is_100_when_the_sum_takes_its_floor():
    """Two steps whose operations other than rfft_large's sum to twice the
    floor read 100 %; rfft_large's passes do not count; twice as long, 50
    %."""
    read = _reader("harmonic_roofline").read
    floor = spec.cell(CELL).work.harmonic_floor_s(spec.read_traffic(CELL))
    total = round(2 * floor * 1e9)
    parts = [("interbin_kernel<false>", 0.3),
             ("harmonic_sum_kernel<false>", 0.7)]
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


def test_harmonic_bytes_reads_nothing_without_the_counter(monkeypatch):
    """A program whose launch counters' module has no ``harmonic_bytes``
    (the parent of the counter) reports nothing, and does not raise."""
    bare = types.ModuleType("h100bench_no_harmonic_counter")
    bare.counts = lambda: {}
    monkeypatch.setitem(sys.modules, bare.__name__, bare)
    reader = _reader("harmonic_bytes")
    run = harness.Run(cell=spec.cell(CELL), steps=4)
    run.cell.config["program"]["launch_counts"] = f"{bare.__name__}:counts"
    reader.start(run)
    reader.stop(run)
    assert reader.read(run) is None


def test_harmonic_bytes_is_the_counters_rise_over_the_steps(monkeypatch):
    fake = types.ModuleType("h100bench_fake_harmonic_counter")
    fake.counts = lambda: {}
    fake.value = 1000
    fake.harmonic_bytes = lambda: fake.value
    monkeypatch.setitem(sys.modules, fake.__name__, fake)
    reader = _reader("harmonic_bytes")
    run = harness.Run(cell=spec.cell(CELL), steps=4)
    run.cell.config["program"]["launch_counts"] = f"{fake.__name__}:counts"
    reader.start(run)
    fake.value += 4 * 16 * 2**30           # 4 steps of 16 GiB
    reader.stop(run)
    assert reader.read(run) == 16.0


def test_a_tiny_run_is_correct_and_reports_its_metrics():
    cell = _tiny()
    result = run_tiny(cell)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"gbps", "step_ms.p95", "setup_s"}
    for name in ("rfft_large_err", "snr_err"):
        c = result["checks"][name]
        assert 0 < c["value"] <= c["limit"] / 10


def test_a_tiny_traced_run_reports_the_sums_bytes(monkeypatch):
    """On the CPU no device operation is traced (``harmonic_roofline``,
    ``kernel_roofline`` and the idle split read nothing there) and the
    plain versions launch nothing; the harmonic sum's bytes are counted
    there too.  ``harmonic_bytes`` reads the rise of the program's counter
    (``parallel.dryrun.harmonic_bytes``) over the window, over its steps,
    and at least what the work module counts: the spectrum read and the SNR
    written.  What the program hands from pass to pass is its own."""
    from smfft_tpu_torch.parallel import dryrun
    counter, seen = dryrun.harmonic_bytes, []

    def logged():
        seen.append(counter())
        return seen[-1]
    monkeypatch.setattr(dryrun, "harmonic_bytes", logged)
    cell = _tiny()
    result = run_tiny(cell, traced=True)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"host_ms", "launches_per_step",
                                      "api_ms", "op_ms", "harmonic_bytes",
                                      "copy_bytes"}
    assert result["metrics"]["copy_bytes"]["value"] == 0
    assert len(seen) == 2 and result["attempted"] >= 1
    got = result["metrics"]["harmonic_bytes"]["value"]
    assert got == (seen[1] - seen[0]) / result["attempted"] / 2**30
    assert got * 2**30 >= cell.work.harmonic_bytes(cell.traffic)
    assert result["metrics"]["launches_per_step"]["value"] == 0


def test_the_control_is_not_correct():
    cell = _tiny()
    result = run_tiny(cell, step=control.control_step(cell))
    assert result["correct"] is False and result["failed"] >= 1
    for name in ("rfft_large_err", "snr_err"):
        c = result["checks"][name]
        assert c["value"] > c["limit"]


def _planted(cell, fault):
    step = traffic.Step(cell.config, cell.traffic)

    def run(x):
        out = step(x)
        snr = out["snr"].clone()
        if fault == "zero":
            snr.zero_()
        elif fault == "half":
            snr[snr.shape[0] // 2:] = 0
        elif fault == "point":
            snr[1, 1234] += 0.05 * snr.square().mean().sqrt()
        elif fault == "single":
            # one harmonic where the configuration asks for 32
            snr = step.calls[1][0](out["rfft_large"], harmonics=1)
        else:
            snr = snr[..., :-1]
        return {"rfft_large": out["rfft_large"], "snr": snr}
    return traffic.Replaced(step.names, run)


@pytest.mark.parametrize("fault", ["zero", "half", "point", "single",
                                   "misshapen"])
def test_a_planted_fault_is_not_correct(fault):
    """The SNR left zero, the second half of the trials left out, one
    fundamental off by 5 % of the SNR's rms, the SNR of one harmonic in
    place of 32, or the SNR one point short."""
    cell = _tiny()
    result = run_tiny(cell, step=_planted(cell, fault))
    assert result["correct"] is False and result["failed"] >= 1
