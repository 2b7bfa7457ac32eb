"""BENCHMARK.json, the configurations, the cells and the metric readers
load, name each other, and keep the benchmark's contract of names."""
import json
import re
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_name_is_valid_and_unique():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert all(NAME.match(n) for n in names), names
        assert len(set(names)) == len(names)
    metric_names = [m["name"] for m in METRICS]
    assert len(set(metric_names)) == len(metric_names)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert data["reduced"] == cfg["reduced"] == []
    assert (PKG / "reference" / f"{data['reference']}.py").exists()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_file_loads(cell):
    from portbench import harness
    c = harness.load_cell(cell["name"])
    assert c.traffic["config"] == cell["config"]
    assert c.traffic["traffic"] == cell["traffic"]
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    assert c.traffic["mode"] in ("rounds", "sweep")
    assert c.snrs == sorted(c.snrs) and c.frames > 0
    assert set(c.traffic["check"]["limits"]) == {"tally_gap"}
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_is_well_formed(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert (PKG / "metrics" / f"{metric['name']}.py").exists()
        assert metric["moves"] == "info_bits_per_s"
        assert metric["layer"] and "\n" not in metric["layer"]
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        if "roofline" in metric["name"]:
            assert metric["name"].endswith("_roofline") and metric["unit"] == "%"


def test_no_reader_without_a_metric():
    listed = {m["name"] for m in BENCH["per_layer"]}
    readers = {p.stem for p in (PKG / "metrics").glob("*.py")}
    assert readers == listed
