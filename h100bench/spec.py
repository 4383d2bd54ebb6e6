"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

  * ``configs/<config>.json``: the configuration as it is run; its plain
    reference ``configs/<config>.py`` sits beside it.
  * ``traffic/<traffic>.json``: the traffic mix and the limits of the
    comparison that decides ``correct``.
  * ``work/<work>.py``: the bytes and operations of one step, from the
    shapes alone (``step_bytes``, ``step_flops``).
  * ``end_to_end/<metric>.py`` and ``layers/<metric>.py``: one reader a
    metric (``read(run)``, optionally ``start(run)`` before the window
    and ``stop(run)`` right after it).

Modules are loaded by path, so a name may hold dots.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# what ``traffic.py`` implements: a closed loop of one caller over a ring
# of ``blocks`` input blocks of (rows, n)
TRAFFIC_KEYS = {"n", "rows", "blocks", "warmup_steps", "sampled_steps",
                "check_rows", "limits"}


def load_module(path: Path) -> ModuleType:
    """Import one file of this directory by its path."""
    name = "h100bench._loaded." + path.relative_to(ROOT).as_posix()
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: ModuleType


@dataclasses.dataclass
class Cell:
    """Everything one run of one cell needs, read from the files."""
    name: str
    chips: int
    config: dict
    traffic: dict
    reference: ModuleType
    work: ModuleType
    end_to_end: list[Metric]
    per_layer: list[Metric]


def benchmark(path: Path | None = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _metrics(entries: list[dict], cell: str, end_to_end: bool):
    folder = ROOT / ("end_to_end" if end_to_end else "layers")
    return [Metric(m["name"], m["unit"],
                   load_module(folder / f"{m['name']}.py"))
            for m in entries if _applies(m, cell)]


def read_traffic(name: str) -> dict:
    """``traffic/<name>.json``; a key that the generator does not implement
    is refused."""
    with open(ROOT / "traffic" / f"{name}.json") as f:
        traffic = json.load(f)
    if set(traffic) != TRAFFIC_KEYS:
        raise ValueError(
            f"traffic {name}: keys {sorted(set(traffic) - TRAFFIC_KEYS)} are "
            f"not implemented, {sorted(TRAFFIC_KEYS - set(traffic))} missing")
    return traffic


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = bench if bench is not None else benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    with open(ROOT / "configs" / f"{w['config']}.json") as f:
        config = json.load(f)
    traffic = read_traffic(w["traffic"])
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        reference=load_module(ROOT / "configs" / f"{w['config']}.py"),
        work=load_module(ROOT / "work" / f"{config['work']}.py"),
        end_to_end=_metrics(bench["end_to_end"], name, True),
        per_layer=_metrics(bench["per_layer"], name, False))
