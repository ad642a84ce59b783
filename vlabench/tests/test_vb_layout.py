"""Every configuration, cell, traffic kind and metric of BENCHMARK.json
loads by name, and the file keeps the contract's shape."""

import json
import re

import pytest

from vlabench import core
from vlabench.tests.vb_tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["vlabench"] and BENCH["command"][1] == "vlabench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    c = core.load_cell(cell, REPO)
    kind = core.load_kind(c)
    assert callable(kind.run)
    assert callable(core.load_system(c).build)
    core.load_reference(c)
    assert c.chips == 1 and NAME.match(c.name) and 1 <= len(c.entry["why"]) <= 200
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("config", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    data = core.load_json(REPO / config["file"])
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"] == []
    assert config["file"].startswith("vlabench/configs/")
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    assert set(data["correctness"]) and all(v > 0 for v in data["correctness"].values())


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=[m["name"] for m in BENCH["per_layer"]])
def test_metric_reader(metric):
    assert callable(core.load_metric(REPO, metric["name"]).read)
    ends = {m["name"] for m in BENCH["end_to_end"]}
    assert metric["moves"] in ends and metric["source"] in ("device_trace", "program_span",
                                                            "program_counter", "host_clock")


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in layer and 1 <= len(layer) <= 200 for layer in layers)
    for m in BENCH["per_layer"]:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
