"""Shared helpers: a cell of ``BENCHMARK.json`` cut to a size the CPU
holds, run through the harness on the CPU (the program's plain versions)."""

from __future__ import annotations

import time

import pytest

from h100bench import harness, spec

TINY_ROWS = {"c2c.n1024.bulk": 32, "real.n1024.bulk": 32,
             "real.n4096.bulk": 8, "c2c.n1024.blocks": 32}
CELLS = sorted(TINY_ROWS)


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.cell(name)
    cell.traffic.update(rows=TINY_ROWS[name], blocks=3, warmup_steps=1,
                        sampled_steps=3, check_rows=8)
    return cell


def run_tiny(cell: spec.Cell, traced: bool = False, step=None,
             seconds: float = 0.2) -> dict:
    return harness.run_cell(cell, 2**31 + 11, seconds, traced, "cpu",
                            time.perf_counter_ns(), step=step)


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param
