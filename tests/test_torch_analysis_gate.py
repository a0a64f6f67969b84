"""The port's graftlint gate: crimp_tpu_torch/ and chip_smoke.py at zero
unwaived findings under all ten rules, every waiver with a reason, valid
SARIF, the real CUDA-graph capture seen by the call graph, the port's own
docs wired in (deleting a row or a lock turns the gate red), and a linter
that imports neither torch nor JAX nor crimp_tpu.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import pytest

import chip_smoke
from crimp_tpu_torch.analysis import engine, sarif
from crimp_tpu_torch.analysis.callgraph import Project
from crimp_tpu_torch.analysis.core import RULES, Config, collect_files, load_source

REPO = pathlib.Path(__file__).resolve().parents[1]
PATHS = [REPO / "crimp_tpu_torch", REPO / "chip_smoke.py"]
DOCS = REPO / "crimp_tpu_torch" / "docs"


@pytest.fixture(scope="module")
def gate_run():
    """One full-rule run over the port and the smoke, shared by the gate
    tests (each asserts a different contract over the same report)."""
    t0 = time.perf_counter()
    rep = engine.run(Config(root=REPO, paths=list(PATHS)))
    return rep, time.perf_counter() - t0


def _cfg(**overrides) -> Config:
    return Config(root=REPO, paths=list(PATHS), **overrides)


class TestGate:
    def test_port_and_smoke_have_zero_unwaived_findings(self, gate_run):
        rep, _ = gate_run
        assert rep.unwaived == [], "\n" + rep.render_text()
        assert rep.files_scanned > 90

    def test_every_waiver_carries_a_reason(self, gate_run):
        rep, _ = gate_run
        waived = [f for f in rep.findings if f.waived]
        assert waived
        for f in waived:
            assert len(f.reason) >= 15, f.render()

    def test_all_ten_rules_are_active(self):
        assert sorted(RULES) == [f"GL{i:03d}" for i in range(11)]
        assert sorted(engine.RULE_FUNCS) == [f"GL{i:03d}" for i in range(1, 11)]

    def test_sarif_of_the_port_validates(self, gate_run):
        rep, _ = gate_run
        doc = sarif.render_sarif(rep, REPO)
        assert sarif.validate_minimal(doc) == []
        suppressed = [r for r in doc["runs"][0]["results"] if r.get("suppressions")]
        assert len(suppressed) == len(rep.findings) - len(rep.unwaived)

    def test_the_lint_fits_the_time_budget(self, gate_run):
        _, wall = gate_run
        assert wall < 30.0, f"full-port lint took {wall:.1f}s"

    def test_the_mcmc_capture_is_an_entry_point(self):
        """The call graph sees ops/mcmc.py's ``with torch.cuda.graph``: its
        body, ``_run_steps`` and ``_half_update`` are captured code; the
        clock reads round the capture are not."""
        files = collect_files([REPO / "crimp_tpu_torch" / "ops" / "mcmc.py"], REPO)
        srcs = [load_source(f, REPO) for f in files]
        traced = Project({s.rel: s.tree for s in srcs}).traced_functions()
        names = {info.qualname for info in traced.values()}
        assert {"_run_steps", "_half_update"} <= names
        assert any(n.startswith("_run_graphed.<capture@") for n in names)
        assert "_run_graphed" not in names and "ensemble_sample_draws" not in names


class TestGateMutations:
    """The port-owned docs, the fingerprint and the locks are load-bearing."""

    def test_removing_a_tools_row_fails(self, tmp_path):
        text = (DOCS / "tools.md").read_text()
        mutated = tmp_path / "tools.md"
        mutated.write_text("\n".join(line for line in text.splitlines() if "CRIMP_TORCH_POLY_TRIG" not in line))
        rep = engine.run(_cfg(rules=("GL003",), tools_md=mutated))
        assert any("CRIMP_TORCH_POLY_TRIG" in f.message for f in rep.unwaived)

    def test_removing_the_poly_trig_fingerprint_key_fails(self, tmp_path):
        text = (REPO / "crimp_tpu_torch" / "ops" / "resumable.py").read_text()
        pruned = "\n".join(line for line in text.splitlines() if '"poly_trig": bool(self.poly)' not in line)
        assert pruned != text
        mutated = tmp_path / "resumable.py"
        mutated.write_text(pruned)
        rep = engine.run(_cfg(rules=("GL003",), resumable_py=mutated))
        assert any("poly_trig" in f.message and "numeric_mode" in f.message for f in rep.unwaived)

    @pytest.mark.parametrize("doc,name,rule", [("robustness.md", "serve_warm_batch", "GL009"),
                                               ("robustness.md", "split_bucket", "GL009"),
                                               ("observability.md", "native_fallbacks", "GL010")])
    def test_redacting_a_doc_row_fails(self, tmp_path, doc, name, rule):
        real = (DOCS / doc).read_text()
        assert name in real
        mutated = tmp_path / doc
        mutated.write_text(real.replace(name, "X" * len(name)))
        key = "robustness_md" if doc == "robustness.md" else "observability_md"
        rep = engine.run(_cfg(rules=(rule,), **{key: mutated}))
        assert any(name in f.message for f in rep.unwaived)

    def test_the_ledger_leg_reads_the_port_metrics(self, tmp_path):
        """obs/ledger.py's annotated ``METRICS`` is read: with no bench
        record its unfed fields are findings (waived at the literal), and a
        bench file that produces every field leaves none."""
        from crimp_tpu_torch.obs import ledger

        rep = engine.run(_cfg(rules=("GL010",)))
        unfed = [f for f in rep.findings if f.path == "crimp_tpu_torch/obs/ledger.py"]
        assert unfed and all(f.waived and "never produces it" in f.message for f in unfed)
        fed = tmp_path / "bench.py"
        fields = [spec["field"] for spec in ledger.METRICS.values()]
        fed.write_text("\n".join(repr(f[-1] if isinstance(f, tuple) else f) for f in fields) + "\n")
        rep = engine.run(_cfg(rules=("GL010",), bench_py=fed))
        assert [f for f in rep.findings if f.path == "crimp_tpu_torch/obs/ledger.py"] == []

    def test_dropping_a_launch_counter_lock_fails(self, tmp_path):
        """ops/z2_grid.py with K2's ``LAUNCHES`` bump taken out of its
        ``with _STATE_LOCK:`` is a GL008 finding."""
        text = (REPO / "crimp_tpu_torch" / "ops" / "z2_grid.py").read_text()
        locked = '    with _STATE_LOCK:\n        LAUNCHES["z2_tile_sums"] += 1\n'
        assert locked in text
        target = tmp_path / "crimp_tpu_torch" / "ops" / "z2_grid.py"
        target.parent.mkdir(parents=True)
        target.write_text(text.replace(locked, '    LAUNCHES["z2_tile_sums"] += 1\n'))
        rep = engine.run(Config(root=tmp_path, paths=[target], rules=("GL008",)))
        assert [(f.rule, "LAUNCHES" in f.message) for f in rep.unwaived] == [("GL008", True)]


class TestImportPin:
    def test_the_cli_imports_neither_torch_nor_jax_nor_crimp_tpu(self):
        proc = subprocess.run([sys.executable, "-X", "importtime", "-m", "crimp_tpu_torch.analysis",
                               "--format", "json"], cwd=REPO, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        assert json.loads(proc.stdout)["counts"] == {}
        imported = chip_smoke.imported_packages(proc.stderr)
        assert "crimp_tpu_torch" in imported
        assert not imported & {"torch", "jax", "jaxlib", "crimp_tpu", "numpy"}, sorted(imported)
