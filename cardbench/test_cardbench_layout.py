"""Every cell, configuration, traffic mix, entry, metric and limit of
BENCHMARK.json resolves to its files, and the file keeps the contract's
shapes (names, units, bounds)."""
import importlib
import json
import re

import pytest

from cardbench.harness import HERE, ROOT, find_cell, load_json, load_reader

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    _, w = find_cell(cell)
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert len(w["why"]) <= 200
    cfg = load_json(HERE / "configs" / f"{w['config']}.json")
    assert cfg["name"] == w["config"]
    gen = importlib.import_module(f"cardbench.generators.{cfg['generator']}")
    assert callable(gen.make_raw) and callable(gen.to_program)
    assert (ROOT / cfg["reference"]).is_file()
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    assert traffic["name"] == w["traffic"]
    entry = importlib.import_module(f"cardbench.entries.{traffic['entry']}")
    assert callable(entry.run)
    assert 1 <= traffic["check_starts"] <= traffic["n_starts"]
    limits = load_json(HERE / "limits" / f"{cell}.json")
    assert limits and set(limits) <= {"f_gap", "f1_gap", "fac_gap"}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    cfg = load_json(ROOT / c["file"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"] and len(c["source"]) <= 200


@pytest.mark.parametrize("path", sorted((HERE / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_config_file(path):
    cfg = load_json(path)
    assert cfg["name"] == path.stem and len(cfg["source"]) <= 200
    assert cfg["dtype"] == "float32"
    assert cfg["options"]["matmul_precision"] == "default"
    importlib.import_module(f"cardbench.generators.{cfg['generator']}")
    assert set(cfg["reduced"]) <= set(cfg["options"]) | set(cfg["sizes"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    kind = "layer_metrics" if "layer" in m else "end_to_end"
    assert callable(load_reader(kind, m["name"]))
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if kind == "end_to_end":
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        e2e = {e["name"] for e in BENCH["end_to_end"]}
        assert m["moves"] in e2e
