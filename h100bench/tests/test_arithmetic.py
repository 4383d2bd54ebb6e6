"""The harness's own arithmetic: work counts, percentiles, spreads, the
device timeline and the metric readers, on numbers worked by hand."""

from __future__ import annotations

import math
import statistics

import pytest
import torch

from h100bench import harness, peaks, stats, traffic
from h100bench.tests.conftest import tiny_cell
from h100bench.trace import Timeline, short_name


def test_work_counts_by_hand():
    c2c = tiny_cell("c2c.n1024.bulk")
    t = dict(c2c.traffic, rows=524288, n=1024)
    assert c2c.work.step_bytes(t) == 2**29 * 16          # 8.59 GB
    assert c2c.work.step_flops(t) == 2**19 * 5 * 1024 * 10
    real = tiny_cell("real.n1024.bulk")
    t = dict(real.traffic, rows=2**20, n=1024)
    assert real.work.step_bytes(t) == 2**20 * 2 * (4096 + 8 * 513)
    assert real.work.step_flops(t) == 2**20 * 2 * 2.5 * 1024 * 10


def test_work_bytes_are_the_public_calls_tensors(cell_name):
    """A step's bytes are each public call's input and output tensors."""
    cell = tiny_cell(cell_name)
    step = traffic.Step(cell.config, cell.traffic)
    x = traffic.make_inputs(cell.config, cell.traffic, 3, "cpu")[0]
    outs = step(x)
    values = {"x": x, **outs}
    nbytes = sum(values[c["input"]].nbytes + values[c["output"]].nbytes
                 for c in cell.config["step"])
    assert nbytes == cell.work.step_bytes(cell.traffic)


def test_inputs_follow_the_seed():
    cell = tiny_cell("c2c.n1024.bulk")
    a = traffic.make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    b = traffic.make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    c = traffic.make_inputs(cell.config, cell.traffic, 2**31 + 6, "cpu")
    assert len(a) == cell.traffic["blocks"]
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].dtype == torch.complex64 and a[0].is_contiguous()
    assert a[0].real.abs().max() <= 1.0


def test_percentile_is_nearest_rank_over_all_values():
    values = list(range(1, 201))                 # 1..200
    assert stats.percentile(values, 95) == 190
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 95) == 3
    assert stats.percentile(list(range(100, 0, -1)), 95) == 95
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_uses_statistics_quartiles():
    values = [10.0, 10.2, 9.9, 10.1, 10.0, 10.4]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx(
        (q3 - q1) / statistics.median(values))


def test_union():
    busy = stats.union([(5, 10), (0, 3), (8, 12), (20, 30)], 1, 25)
    assert busy == [(1, 3), (5, 12), (20, 25)]
    assert stats.union([], 0, 4) == []


def test_idle_time_by_the_operations_around_it():
    """Two steps of r2c then c2r: the gap inside a step, the gaps between
    steps and the window's edges, each named by the operations beside it;
    an operation that overlaps the one before closes no gap."""
    ops = [("r2c", 10, 40), ("c2r", 45, 80), ("r2c", 100, 130),
           ("c2r", 132, 170), ("copy", 150, 160)]
    tl = Timeline(ops, 0, 200)
    assert tl.idle_between() == [
        ("c2r -> window end", 30), ("c2r -> r2c", 20),
        ("window start -> r2c", 10), ("r2c -> c2r", 5 + 2)]
    assert sum(v for _, v in tl.idle_between()) == 200 - tl.busy_ns()
    assert Timeline([], 0, 50).idle_between() == [
        ("window start -> window end", 50)]


def test_timeline_busy_idle_and_names():
    ops = [("k1", 100, 400), ("k2", 300, 500), ("k1", 700, 800)]
    tl = Timeline(ops, 0, 1000)
    assert tl.busy == [(100, 500), (700, 800)]
    assert tl.busy_ns() == 500
    assert tl.op_ns() == 300 + 200 + 100
    assert tl.by_name() == [("k1", 400), ("k2", 200)]


def test_short_kernel_names():
    assert short_name("void (anonymous namespace)::c2c_kernel<1024, false>"
                      "(float2 const*, float2*, long)") == \
        "c2c_kernel<1024, false>"
    assert short_name("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD (Device -> Device)"


def _run(cell, **kw):
    run = harness.Run(cell=cell)
    run.work_bytes = cell.work.step_bytes(cell.traffic)
    run.work_flops = cell.work.step_flops(cell.traffic)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def _reader(cell, name):
    return {m.name: m.reader for m in cell.end_to_end + cell.per_layer}[name]


def test_readers_on_a_synthetic_window():
    cell = tiny_cell("c2c.n1024.bulk")
    cell.traffic.update(rows=524288)
    least, bound = peaks.least_seconds(cell.work.step_bytes(cell.traffic),
                                       cell.work.step_flops(cell.traffic))
    assert bound == "bytes" and least == pytest.approx(8589934592 / 3.35e12)
    # 4 steps, each a 3.2 ms kernel in a 3.4 ms step
    ops = [("c2c_kernel", int(i * 3.4e6), int(i * 3.4e6 + 3.2e6))
           for i in range(4)]
    run = _run(cell, steps=4, window_s=4 * 3.4e-3, host_ns=4 * 80_000,
               step_ms=[3.4, 3.3, 3.5, 3.45],
               timeline=Timeline(ops, 0, int(4 * 3.4e6)))
    assert _reader(cell, "gbps").read(run) == pytest.approx(
        8589934592 / 3.4e-3 / 1e9)
    assert _reader(cell, "step_ms.p95").read(run) == 3.5
    assert _reader(cell, "host_ms").read(run) == pytest.approx(0.08)
    assert _reader(cell, "kernel_roofline").read(run) == pytest.approx(
        100 * least / 3.2e-3)
    assert _reader(cell, "device_idle").read(run) == pytest.approx(
        100 * 0.2 / 3.4)


def test_device_readers_read_nothing_without_device_operations():
    cell = tiny_cell("c2c.n1024.bulk")
    run = _run(cell, steps=4, window_s=1.0, timeline=Timeline([], 0, 10))
    assert _reader(cell, "kernel_roofline").read(run) is None
    assert _reader(cell, "device_idle").read(run) is None
    run.timeline = None
    assert _reader(cell, "device_idle").read(run) is None


def test_roofline_cannot_pass_100_for_a_kernel_at_the_bound():
    cell = tiny_cell("real.n4096.bulk")
    cell.traffic.update(rows=262144)
    least, _ = peaks.least_seconds(cell.work.step_bytes(cell.traffic),
                                   cell.work.step_flops(cell.traffic))
    ops = [("r2c", 0, math.ceil(least * 1e9))]
    run = _run(cell, steps=1, window_s=least,
               timeline=Timeline(ops, 0, math.ceil(least * 1e9)))
    assert _reader(cell, "kernel_roofline").read(run) <= 100.0
