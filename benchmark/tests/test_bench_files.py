"""BENCHMARK.json against the contract's shape, every file it names, and a
cell added as files alone."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests import cells

ROOT = harness.ROOT
SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    cells = len(SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, cells // 4)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries(group, keys):
    names = [e["name"] for e in SPEC[group]]
    assert len(set(names)) == len(names)
    for e in SPEC[group]:
        assert set(e) == keys, e["name"]
        assert NAME.match(e["name"])
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_metrics_shape():
    spec = SPEC
    cells = [w["name"] for w in spec["workloads"]]
    all_metrics = spec["end_to_end"] + spec["per_layer"]
    names = [m["name"] for m in all_metrics]
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for m in all_metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in cells


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = harness.load_cell(cell)
    assert harness.driver(c.workload["driver"]).setup
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("cell", sorted(cells.LATER))
def test_later_cell_files_load(cell):
    """The files of the cells kept for a later PR: a traffic file naming a
    driver, and a configuration."""
    c = cells.cell(cell)
    assert harness.driver(c.workload["driver"]).setup
    assert c.config["name"] == cells.LATER[cell]


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    data = harness.load_json(os.path.join(ROOT, config["file"]))
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert sorted(data["reduced"]) == sorted(config["reduced"])
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


def test_a_cell_added_as_files_is_found(tmp_path):
    """A later cell needs only a traffic file and an entry: copy the
    benchmark, add both, and the harness finds the cell and its metrics."""
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append(dict(name="velocity.chunked_short", config="velocity_cf2x_e4096",
                                  traffic="velocity.chunked_short", chips=1, why="test"))
    spec["workloads"].append(dict(name="velocity_e4096.chunked_again", config="velocity_cf2x_e4096",
                                  traffic="velocity.chunked", chips=1, why="test"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "velocity.chunked" in m.get("workloads", []):
            m["workloads"].append("velocity.chunked_short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    wl = harness.load_json(os.path.join(harness.BENCH, "workloads", "velocity.chunked.json"))
    wl["traffic"]["control_steps_per_call"] = 480
    (tmp_path / "benchmark" / "workloads" / "velocity.chunked_short.json").write_text(
        json.dumps(wl))
    cell = harness.load_cell("velocity.chunked_short", root=str(tmp_path),
                             bench_dir=str(tmp_path / "benchmark"))
    assert cell.workload["traffic"]["control_steps_per_call"] == 480
    assert {m["name"] for m in cell.end_to_end} == {"drone_steps_per_s", "setup_s"}
    assert "k1_roofline" in {m["name"] for m in cell.per_layer}
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"], cell.bench_dir))
    again = harness.load_cell("velocity_e4096.chunked_again", root=str(tmp_path),
                              bench_dir=str(tmp_path / "benchmark"))
    assert again.workload["traffic"]["control_steps_per_call"] == 4800
