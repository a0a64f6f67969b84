"""The import rule: nothing the benchmark runs loads JAX or the JAX package,
and the plain reference loads nothing of the program."""

import ast
import pathlib
import subprocess
import sys

import pytest

from portbench import harness

BENCH_DIR = harness.HERE
PROGRAM = "crimp_tpu_torch"


def imported_tops(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")) + sorted(
    (BENCH_DIR / "gen").glob("*.py")) + sorted((BENCH_DIR / "counts").glob("*.py")), ids=lambda p: p.name)
def test_yardstick_imports_nothing_of_the_program(path):
    assert not imported_tops(path) & {PROGRAM, "jax", "jaxlib", "flax", "crimp_tpu"}


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_file_imports_jax(path):
    assert not imported_tops(path) & {"jax", "jaxlib", "flax", "crimp_tpu"}


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "crimp_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "crimp_tpu.fake", sys)
    found = harness.forbidden_modules()
    assert "crimp_tpu.fake" in found
    assert not [m for m in found if m.startswith("crimp_tpu_torch")]


def test_a_cpu_run_loads_neither(tmp_path):
    """A whole small run in a fresh process: afterwards no module of JAX or
    of the JAX package is loaded, compared by whole top-level name."""
    code = f"""
import sys
sys.path.insert(0, {str(harness.ROOT)!r})
sys.path.insert(0, {str(pathlib.Path(__file__).parent)!r})
import pathlib
from conftest import small_cell
from portbench import harness
config, mix = small_cell("blind_1e7.z2", pathlib.Path({str(tmp_path)!r}), n_intervals=2, events=300)
harness.run("blind_1e7.z2", 5, 0.1, False, device="cpu", config=config, mix=mix, log=lambda *a, **k: None)
print(",".join(harness.forbidden_modules()) or "none")
print("program" if any(m.split(".")[0] == {PROGRAM!r} for m in sys.modules) else "no program")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["none", "program"]
