"""The readers of the program's spans (``spans.py``, ``api_ms``,
``op_ms``) on hand-made records, where each value is known."""

from __future__ import annotations

import numpy as np
import pytest

from h100bench import harness, spans, spec, trace
from smfft_tpu_torch.trace import Records

NEW = {"api_ms": ("ms", "API, on the host", "step_ms.p95"),
       "op_ms": ("ms", "op", "step_ms.p95")}
BULK = ["c2c.n1024.bulk", "real.n1024.bulk", "real.n4096.bulk"]


def records(rows) -> Records:
    """``rows``: (name, start, end, parent index or -1, thread), in the
    order they opened; the attributes are left empty."""
    names = sorted({r[0] for r in rows})
    parent = [r[3] for r in rows]
    root = []
    for i, p in enumerate(parent):
        root.append(i if p < 0 else root[p])
    col = lambda v: np.array(v, np.int64)  # noqa: E731
    return Records(names=names, attrs=[{}],
                   name=col([names.index(r[0]) for r in rows]),
                   attr=col([0] * len(rows)),
                   start=col([r[1] for r in rows]),
                   end=col([r[2] for r in rows]),
                   parent=col(parent), root=col(root),
                   thread=col([r[4] for r in rows]))


def make_run(rows, lo=0, hi=1000, steps=1):
    run = harness.Run(cell=spec.cell("c2c.n1024.bulk"), steps=steps)
    run.timeline = trace.Timeline([], lo, hi)
    run.scratch["spans"] = records(rows)
    return run


def read(name, run):
    return spec.load_module(spec.ROOT / "layers" / f"{name}.py").read(run)


def test_self_time_of_nested_calls_and_ops():
    # call 100-400 holds op 150-250 and a nested call 260-380 holding op
    # 270-370 (its launch inside): api = 300 - 100 - 100 = 100, op = 200
    run = make_run([("call:fft_large", 100, 400, -1, 0),
                    ("op:large_c2c", 150, 250, 0, 0),
                    ("call:fft", 260, 380, 0, 0),
                    ("op:ordered_c2c", 270, 370, 2, 0),
                    ("launch:c2c", 280, 360, 3, 0)], steps=2)
    assert spans.host(run) == {"api_ns": 100, "op_ns": 200}
    assert read("api_ms", run) == pytest.approx(100 / 2 / 1e6)
    assert read("op_ms", run) == pytest.approx(200 / 2 / 1e6)


def test_self_time_when_ops_overlap():
    # two op spans of one call that overlap (120-200, 180-260): their union,
    # 140, is counted once
    run = make_run([("call:fft", 100, 300, -1, 0),
                    ("op:a", 120, 200, 0, 0),
                    ("op:b", 180, 260, 0, 0)])
    assert spans.host(run) == {"api_ns": 60, "op_ns": 140}


def test_self_time_on_two_threads():
    # thread 0's call (0-500) holds nothing; thread 1's op (100-300) is a
    # tree of its own (a backward), so it lowers no call's self time
    run = make_run([("call:fft", 0, 500, -1, 0),
                    ("op:ordered_c2c", 100, 300, -1, 1)])
    assert spans.host(run) == {"api_ns": 500, "op_ns": 200}


def test_spans_are_clipped_to_the_window():
    run = make_run([("call:fft", 50, 300, -1, 0),
                    ("op:ordered_c2c", 80, 280, 0, 0),
                    ("call:fft", 900, 1200, -1, 0)], lo=100, hi=1000)
    assert spans.host(run) == {"api_ns": 20 + 100, "op_ns": 180}


def test_without_records_every_reader_reads_nothing():
    """A program without spans (the parent of this reader): ``None``."""
    run = harness.Run(cell=spec.cell("c2c.n1024.blocks"), steps=3)
    run.timeline = trace.Timeline([], 0, 1000)
    for name in ("api_ms", "op_ms", "api_ms.blocks", "op_ms.blocks"):
        assert read(name, run) is None


def test_the_four_entries():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name, (unit, layer, moves) in NEW.items():
        assert entries[name] == {
            "name": name, "unit": unit, "better": "lower",
            "source": "program_span", "layer": layer, "moves": moves,
            "workloads": BULK}
        blocks = entries[f"{name}.blocks"]
        assert blocks == {
            "name": f"{name}.blocks", "unit": unit, "better": "lower",
            "source": "program_span", "layer": layer,
            "moves": "gbps.blocks", "workloads": ["c2c.n1024.blocks"]}
        base = spec.load_module(spec.ROOT / "layers" / f"{name}.py")
        again = spec.load_module(spec.ROOT / "layers" / f"{name}.blocks.py")
        assert again.start is base.start is spans.start
        assert again.stop is base.stop is spans.stop
        assert (again.read.__code__.co_filename
                == base.read.__code__.co_filename)
