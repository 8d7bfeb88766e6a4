"""BENCHMARK.json against the files the harness finds by name, and against
the shape its readers expect (names, units, bounds, sources)."""
import json
import re

import pytest

import run
from run import CODE_ROOT, HERE

BENCH = json.loads((CODE_ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        for trace in (False, True):
            cell = run.load_cell(CODE_ROOT, w["name"], trace)
            assert cell.metrics
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    for c in BENCH["configs"]:
        cfg = json.loads((CODE_ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and set(c["reduced"]) == set(cfg["reduced"])
        assert cfg["limits"], "a configuration without limits cannot decide `correct`"


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader_that_agrees(m):
    r = run.load_reader(m["name"])
    assert callable(r.read) and r.UNIT == m["unit"] and NAME.match(m["name"])
    if "layer" in m:
        assert r.LAYER == m["layer"] and m["moves"] == "frames_per_s"
        # which cells report it is BENCHMARK.json's alone: a later cell adds
        # itself there without editing the reader
        assert not hasattr(r, "WORKLOADS")


def test_bounds_and_sources():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        pl = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and pl
