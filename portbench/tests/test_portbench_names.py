"""BENCHMARK.json against the contract's shape, and every part of every
cell found by its name."""

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s: 2 + 14 x 24 runs
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_shape():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_an_e2e_metric_beside_setup_and_a_per_layer_one():
    for cell in CELLS:
        c = harness.load_cell(cell)
        e2e = {m["name"] for m in c.metrics("end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.metrics("per_layer")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.workload["chips"] == 1
    assert c.traffic["nrhs"] >= 1 and c.traffic["matrix"] in ("fresh", "once")
    assert int(c.extra["trace_systems"]) >= 1
    entry = harness.load_module("entries", c.cfg["entry"])
    assert hasattr(entry, "Entry")
    assert hasattr(harness.load_module("matrices", c.cfg["matrix"]), "draw")
    assert hasattr(harness.load_module("reference", c.cfg["reference"]), "solve")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("portbench/configs/")
    body = harness.load_json(os.path.join(harness.ROOT, cfg["file"]))
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    assert body["N"] % body["v"] == 0 and body["accuracy"] > 0
    assert "control" in body and "assumed" in body


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.load_module("metrics", metric["name"]).read)


def test_unknown_names_fail():
    with pytest.raises(KeyError):
        harness.load_cell("no.such.cell")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")


def test_stream_seeds_are_stable_and_distinct():
    a = harness.stream_seed(2**31 + 5, "A", 0)
    assert a == harness.stream_seed(2**31 + 5, "A", 0)
    assert 0 <= a < 2**63
    assert len({harness.stream_seed(s, k, i) for s in (0, 1, -1, 2**40)
                for k in ("A", "b") for i in (-1, 0, 1)}) == 24
