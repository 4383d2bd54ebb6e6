"""A whole run of each cell, cut to a size the CPU holds, with the look for
a card skipped: the result line's shape, the comparison, and the control
and the faults that the comparison has to catch."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from h100bench import control, spec, traffic
from h100bench.tests.conftest import run_tiny, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line_shape_untraced(cell_name):
    cell = tiny_cell(cell_name)
    result = json.loads(json.dumps(run_tiny(cell)))
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {m.name for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert result["metrics"][m.name]["unit"] == m.unit
        assert result["metrics"][m.name]["value"] > 0
    assert set(result["checks"]) == set(cell.traffic["limits"])
    for name, c in result["checks"].items():
        assert c["limit"] == cell.traffic["limits"][name]
        assert 0 < c["value"] <= c["limit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])


def test_last_line_shape_traced(cell_name):
    """On the CPU the trace holds no device operation: the device readers
    report nothing, the host's and the counters' do."""
    cell = tiny_cell(cell_name)
    result = run_tiny(cell, traced=True)
    assert list(result)[-1] == "checks" and result["correct"] is True
    source = {m["name"]: m["source"] for m in spec.benchmark()["per_layer"]}
    host_side = {m.name for m in cell.per_layer
                 if source[m.name] != "device_trace"}
    assert host_side and set(result["metrics"]) == host_side
    for name in host_side:
        value = result["metrics"][name]["value"]
        assert value == 0 if name.startswith("launches") else value > 0
    assert {"busy_s", "window_s"} <= set(result["device"])


def test_control_is_not_correct(cell_name):
    """The reference in bfloat16 storage, in the program's place."""
    cell = tiny_cell(cell_name)
    result = run_tiny(cell, step=control.control_step(cell))
    assert result["correct"] is False
    assert result["failed"] >= 1
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in result["checks"].values())


def _broken(cell, fault):
    step = traffic.Step(cell.config, cell.traffic)

    def run(x):
        outs = step(x)
        for name, y in outs.items():
            y = y.clone()
            if fault == "unchanged":
                y.zero_()
            elif fault == "half":
                y[y.shape[0] // 2:] = 0
            else:
                y.view(-1)[y.numel() // 3] += 1.0
            outs[name] = y
        return outs
    return traffic.Replaced(step.names, run)


def test_faults_are_not_correct(cell_name):
    """Outputs left unwritten, half the batch left out, and one answer
    altered where it is produced: each makes the run not correct."""
    cell = tiny_cell(cell_name)
    for fault in ("unchanged", "half", "altered"):
        result = run_tiny(cell, step=_broken(cell, fault))
        assert result["correct"] is False, fault
        assert result["failed"] >= 1, fault


def test_a_misshapen_output_is_not_correct():
    cell = tiny_cell("real.n1024.bulk")
    step = traffic.Step(cell.config, cell.traffic)

    def run(x):
        outs = step(x)
        outs["rfft"] = outs["rfft"][:, :-1]
        return outs
    result = run_tiny(cell, step=traffic.Replaced(step.names, run))
    assert result["correct"] is False
    assert result["checks"]["rfft_err"]["value"] is None


def test_without_a_card_the_command_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload",
         "c2c.n1024.bulk", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=spec.REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert done.returncode != 0
    assert "{" not in done.stdout


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = ("from h100bench.tests.conftest import run_tiny, tiny_cell; "
            "from h100bench.run import _jax_loaded; "
            "run_tiny(tiny_cell('real.n1024.bulk'), traced=True); "
            "print(_jax_loaded())")
    done = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"
