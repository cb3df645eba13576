"""``BENCHMARK.json`` against the rules the harness and its checker hold
it to, and every name in it against the files the harness finds by it."""

import json
import re
from pathlib import Path

import pytest

from h100_bench.core import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def all_metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", (
    [c["name"] for c in BENCH["configs"]]
    + [w["name"] for w in BENCH["workloads"]]
    + [w["traffic"] for w in BENCH["workloads"]]
    + [m["name"] for m in all_metrics()]
    + [k for c in BENCH["configs"] for k in c["reduced"]]))
def test_names(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", all_metrics(), ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], all_metrics()):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds_and_sources():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_moves_an_end_to_end_metric_of_each_of_its_cells():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
        for cell in m["workloads"]:
            reported = {e["name"] for e in harness.find_cell(
                BENCH, cell).end_to_end}
            assert m["moves"] in reported, (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = harness.find_cell(BENCH, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]


def test_every_config_has_a_cell_and_its_file():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("h100_bench/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
        assert len(c["reduced"]) <= 16


def test_four_chip_cells_within_a_quarter():
    fours = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert len(fours) <= max(1, len(BENCH["workloads"]) // 4)


def test_why_fields_fit():
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200
        assert "\n" not in entry["why"] and "\t" not in entry["why"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cells_files_are_found_by_name(cell):
    c = harness.find_cell(BENCH, cell)
    driver = harness.driver_of(c)
    for fn in ("setup", "window", "trace", "release", "check"):
        assert callable(getattr(driver, fn))
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))
    assert c.check["limits"]
