"""The benchmark is driven by data: every cell, configuration, driver and
per-layer metric that ``BENCHMARK.json`` names is found by its name from a
file of its own, and every name and unit keeps to the allowed characters."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from benchmark import common, harness

SPEC = json.loads((common.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    assert (common.ROOT / SPEC["command"][1]).is_file()
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    for entry in SPEC[kind]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                    and "\t" not in entry[key]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    workload = common.load_json("workloads", cell)
    assert workload["config"] == entry["config"]
    config = common.load_json("configs", workload["config"])
    assert config["name"] == entry["config"]
    driver = importlib.import_module(f"benchmark.drivers.{workload['driver']}")
    for fn in ("setup", "window", "end_to_end", "work", "check"):
        assert callable(getattr(driver, fn))
    e2e, layer = harness.cell_metrics(SPEC, cell)
    names = {m["name"] for m in e2e}
    assert names == {m["name"] for m in SPEC["end_to_end"]
                     if cell in m.get("workloads", CELLS)}
    assert "setup_s" in names and len(names) >= 2
    assert {m["name"] for m in layer} == {m["name"] for m in SPEC["per_layer"]
                                          if cell in m["workloads"]}
    assert layer, f"{cell} reports no per-layer metric"
    for m in layer:
        assert callable(harness.load_reader(m["name"]))
        assert m["moves"] in names
    assert all(v is not None for v in workload["limits"].values()), "a limit is not set"


def test_every_metric_has_a_reader_and_its_cells_report_what_it_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert (common.BENCH / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        # the device's end-to-end metrics are read from the trace, as a per-layer one is
        assert (m["source"] == "device_trace") == (common.BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_configs_are_files_under_paths():
    for c in SPEC["configs"]:
        path = common.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/configs/")
        assert json.loads(path.read_text())["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
