"""The benchmark's files: every cell, configuration and metric loads by
name; names and units keep to their characters; each metric's cells
report what it moves; a new cell and metric come in as files alone."""

import json
import re
import shutil

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_loads_with_its_config_and_driver(cell):
    w = harness.load_json("workloads", cell)
    entry = next(e for e in SPEC["workloads"] if e["name"] == cell)
    assert w["config"] == entry["config"] and w["chips"] == entry["chips"]
    assert w["why"] == entry["why"]
    config = harness.load_json("configs", w["config"])
    assert config["reduced"] == next(
        c for c in SPEC["configs"] if c["name"] == w["config"])["reduced"]
    driver = harness.load_module("drivers", w["driver"])
    assert callable(driver.run) and callable(driver.control_readings)
    assert w["limits"], "a cell compares at least one number"


@pytest.mark.parametrize("metric", sorted(
    p.stem for p in (harness.BENCH_DIR / "metrics").glob("*.py")))
def test_metric_reader_loads(metric):
    mod = harness.load_module("metrics", metric)
    assert mod.read({}) is None     # nothing to read: no number, not 0


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [w["config"] for w in SPEC["workloads"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in SPEC[kind]]
        assert len(seen) == len(set(seen)), kind
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_metric_moves_what_its_cells_report():
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            e2e, layer = harness.cell_metrics(SPEC, cell)
            assert m["moves"] in {e["name"] for e in e2e}, (m, cell)
            assert m["name"] in {x["name"] for x in layer}
    for w in SPEC["workloads"]:
        e2e, layer = harness.cell_metrics(SPEC, w["name"])
        names = {e["name"] for e in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer


def test_contract_numbers():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    runs = 2 + 14 * 24
    budget = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert budget <= 43200, budget
    assert cells <= 24
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_a_cell_and_a_metric_come_in_as_files(tmp_path, monkeypatch):
    """A later change adds a traffic mix and a reader as new files and
    BENCHMARK.json entries; no existing file is edited."""
    root = tmp_path / "repo"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark")
    spec = json.loads(json.dumps(SPEC))
    cell = harness.load_json("workloads", "face.clip")
    cell["traffic"]["frames"] = 120
    cell["why"] = "shorter clips"
    (root / "benchmark" / "workloads" / "face.clip120.json").write_text(
        json.dumps(cell))
    (root / "benchmark" / "metrics" / "frames.clip120.py").write_text(
        "def read(rec):\n    return rec.get('frames')\n")
    spec["workloads"].append({"name": "face.clip120", "config": "face",
                              "traffic": "clip120", "chips": 1,
                              "why": "shorter clips"})
    spec["per_layer"].append({"name": "frames.clip120", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "generator", "moves": "clip_fps",
                              "workloads": ["face.clip120"]})
    spec["end_to_end"][0]["workloads"].append("face.clip120")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "BENCH_DIR", root / "benchmark")
    monkeypatch.setattr(harness, "ROOT", root)
    got = harness.load_json("workloads", "face.clip120")
    assert got["traffic"]["frames"] == 120
    e2e, layer = harness.cell_metrics(harness.benchmark_spec(),
                                      "face.clip120")
    assert [m["name"] for m in layer] == ["frames.clip120"]
    assert {m["name"] for m in e2e} == {"clip_fps", "setup_s"}
    reader = harness.load_module("metrics", "frames.clip120")
    assert reader.read({"frames": 3}) == 3
