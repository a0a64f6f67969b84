"""The harness finds configurations, mixes, drivers and metrics by name."""

import pathlib

import pytest

from portbench import harness

BENCH = harness.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_by_name(cell):
    entry, config, mix = harness.cell_files(cell, BENCH)
    assert config["name"] == entry["config"]
    assert (harness.HERE / "drivers" / f"{mix['driver']}.py").is_file()
    assert set(mix["limits"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_by_name(metric):
    module = harness.load_module(harness.HERE / "metrics" / f"{metric}.py")
    assert callable(module.read)


def test_a_new_metric_is_a_new_file(tmp_path: pathlib.Path):
    path = tmp_path / "units.any_cell.py"
    path.write_text("def read(ctx):\n    return float(len(ctx.records))\n")
    ctx = harness.Context([{"seconds": 1.0}] * 3, None, {})
    assert harness.load_module(path).read(ctx) == 3.0


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.cell_files("no_such.cell", BENCH)


def test_config_paths_lie_under_the_benchmark():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert (harness.ROOT / c["file"]).is_file()
