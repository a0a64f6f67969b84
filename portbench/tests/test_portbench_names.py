"""BENCHMARK.json against the contract's names, units and cross-references."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


def all_names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield key, entry["name"]
    for w in BENCH["workloads"]:
        yield "config", w["config"]
        yield "traffic", w["traffic"]
    for c in BENCH["configs"]:
        for key in c["reduced"]:
            yield "reduced", key


@pytest.mark.parametrize("kind,name", list(all_names()))
def test_name_characters(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"} | (
        {"bound"} if metric in BENCH["end_to_end"] else {"layer", "moves"})
    assert set(metric) <= allowed


def test_unique_names():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_bounds_and_window():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    for cell in metric["workloads"]:
        assert metric["moves"] in harness.metric_names(BENCH, cell, "end_to_end")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = harness.metric_names(BENCH, cell, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metric_names(BENCH, cell, "per_layer")


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(layer) <= 200 and "\n" not in layer for layer in layers)
