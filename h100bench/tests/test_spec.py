"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
against a file of this directory."""

from __future__ import annotations

import json
import re

import pytest

from h100bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_tok")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    raw = (spec.REPO / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (spec.REPO / p).is_dir()
    assert 1 <= len(b["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    cells = 24
    assert (2 + 14 * cells) * (b["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200


def test_configs():
    b = spec.benchmark()
    assert 1 <= len(b["configs"]) <= 24
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in b["workloads"]}
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((spec.REPO / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert (spec.ROOT / "configs" / f"{c['name']}.py").is_file()
        assert (spec.ROOT / "work" / f"{data['work']}.py").is_file()


def test_workloads():
    b = spec.benchmark()
    assert 1 <= len(b["workloads"]) <= 24
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (spec.ROOT / "traffic" / f"{w['traffic']}.json").is_file()
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_metrics():
    b = spec.benchmark()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(b["per_layer"]) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    all_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(all_names)) == len(all_names)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        assert (spec.ROOT / "end_to_end" / f"{m['name']}.py").is_file()
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert (spec.ROOT / "layers" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    for cell in cells:
        e = [m for m in b["end_to_end"] if cell in m.get("workloads", cells)]
        p = [m for m in b["per_layer"] if cell in m.get("workloads", cells)]
        assert len(e) >= 2 and p


def test_every_cell_loads():
    for w in spec.benchmark()["workloads"]:
        cell = spec.cell(w["name"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(m.reader.read)
        t = cell.traffic
        assert set(t) == spec.TRAFFIC_KEYS
        assert set(t["limits"]) == {f"{c['output']}_err"
                                    for c in cell.config["step"]}
        assert cell.work.step_bytes(t) > 0 and cell.work.step_flops(t) > 0


def test_a_traffic_key_the_generator_does_not_implement_is_refused(
        tmp_path, monkeypatch):
    """A mix that asks for what the one generator does not do (an open
    loop, several clients) fails to load instead of running unnoticed as a
    closed loop of one caller."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "configs").mkdir()
    t = json.loads((spec.ROOT / "traffic" / "c2c.n1024.bulk.json")
                   .read_text())
    t["clients"] = 4
    (tmp_path / "traffic" / "c2c.n1024.bulk.json").write_text(json.dumps(t))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    with pytest.raises(ValueError, match="clients"):
        spec.read_traffic("c2c.n1024.bulk")
