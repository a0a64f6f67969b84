"""Small versions of the benchmark's cells, for tests on the CPU."""

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(name: str, tmp_path: pathlib.Path, n_intervals: int = 4, events: int = 2000, sets: int = 2,
               scan: dict | None = None):
    """(config, mix) of cell ``name`` cut to ``n_intervals`` intervals of
    about ``events`` events each (in the proportions of the configuration's
    column), a 64 x 4 trial grid (its bounds changed by ``scan``) in blocks
    of 16 frequencies, and 32 trials at random."""
    from portbench import harness

    _, config, mix = harness.cell_files(name)
    config = copy.deepcopy(config)
    src = pathlib.Path(config["_dir"]) / config["intervals"]
    lines = src.read_text().splitlines()
    short = tmp_path / "intervals.txt"
    short.write_text("\n".join(lines[: n_intervals + 1]) + "\n")
    config["intervals"] = str(short)
    config["events_total"] = n_intervals * events
    config["scan"] = dict(config["scan"], n_freq=64, n_fdot=4, **(scan or {}))
    z2 = dict(z2_sample=32, z2_stride=16, z2_edge_rows=2) if "z2_sample" in mix else {}
    return config, dict(mix, event_sets=sets, **z2)


@pytest.fixture
def small(tmp_path):
    return lambda name, **kw: small_cell(name, tmp_path, **kw)
