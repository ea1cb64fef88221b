"""BENCHMARK.json against the benchmark's contract, and every file a cell
or metric needs found by its name."""

import json
import os
import re

import pytest

from harness import core

BENCH = core.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert cmd[1].startswith("benchmark/")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60, 180 s a
    # cell to compile, 1200 s spare, for the most cells (24)
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= n <= 24 and 1 <= len(BENCH["configs"]) <= 24
    assert os.path.getsize(os.path.join(core.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/") and PATH.match(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    assert len({c["file"] for c in BENCH["configs"]}) == len(names)
    cells = []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(cells)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(cells) // 4)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in SOURCES
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_and_finds_its_files(cell):
    w = core.cell_of(BENCH, cell)
    conf = [c for c in BENCH["configs"] if c["name"] == w["config"]][0]
    assert conf["file"] == "benchmark/configs/%s.json" % w["config"]
    config = core.read_json("configs", w["config"])
    assert config["name"] == w["config"]
    traffic = core.read_json("traffic", w["traffic"])
    assert os.path.exists(os.path.join(core.BENCH_DIR, "entries",
                                       traffic["entry"] + ".py"))
    e2e = [m["name"] for m in core.metrics_of(BENCH, w, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = core.metrics_of(BENCH, w, True)
    assert layer
    for m in core.metrics_of(BENCH, w, False) + layer:
        assert callable(core.load("metrics", m["name"]).read)
    # a per-layer metric with a cell list moves a metric each cell reports
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", []):
            assert m["moves"] in e2e


def test_config_files_hold_the_run():
    for c in BENCH["configs"]:
        with open(os.path.join(core.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["precision"] == "float32"
