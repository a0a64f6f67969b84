"""graftlint for the port (crimp_tpu_torch/analysis) against crimp_tpu's.

- **Parity.** The JAX package's per-rule fixture trees (tests/test_analysis.py)
  go through ``crimp_tpu.analysis.engine.run`` and
  ``crimp_tpu_torch.analysis.engine.run`` with the same injected inputs; the
  two give the same (rule, path, line, waived) findings for GL000 and the
  rules the port copies (GL004-GL006, GL008-GL010). For GL007 the parity
  set holds the fixtures where both engines stay silent; its firing cases
  are retargeted and pinned below.
- **Retargeted rules.** GL001 and GL002 on CUDA-graph capture, GL003 under
  ``CRIMP_TORCH_``, GL007 on spec tuples: each with fixtures that fire and
  fixtures that do not.
- The report, CLI, baseline and SARIF plumbing on small trees.
"""

from __future__ import annotations

import json
import textwrap

import pytest

from crimp_tpu import knobs as jax_knobs
from crimp_tpu.analysis import engine as jax_engine
from crimp_tpu.analysis.core import Config as JaxConfig
from crimp_tpu_torch import knobs
from crimp_tpu_torch.analysis import cli, engine, sarif
from crimp_tpu_torch.analysis.core import Config, load_baseline, new_findings, save_baseline


def run_tree(tmp_path, files, *, port=True, rules=None, registry=None, tools_md_text="",
             numeric_keys=("fake_mode",), gl004_allowlist=("pkg/anchor.py",),
             gl005_modules=("pkg/parallel/",), gl006_modules=("pkg/",), gl007_modules=("pkg/",),
             gl007_registry="pkg/parallel/registry.py", gl008_modules=("pkg/",), gl010_modules=("pkg/",),
             telemetry_consumers=(), observability_md_text="", robustness_md_text="", tests=None,
             bench_text=""):
    """Write a fixture tree and run one package's analyzer over it, every
    cross-file input injected through Config (tests/test_analysis.py's
    ``run_tree``, for either engine)."""
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    tools = tmp_path / "tools.md"
    tools.write_text(tools_md_text)
    resumable = tmp_path / "resumable.py"
    entries = ", ".join(f'"{k}": 1' for k in numeric_keys)
    resumable.write_text(f"_numeric_mode = {{{entries}}}\n")
    obs_md = tmp_path / "observability.md"
    obs_md.write_text(textwrap.dedent(observability_md_text))
    rob_md = tmp_path / "robustness.md"
    rob_md.write_text(textwrap.dedent(robustness_md_text))
    tests_dir = tmp_path / "tests"
    tests_dir.mkdir(exist_ok=True)
    for name, text in (tests or {}).items():
        (tests_dir / name).write_text(textwrap.dedent(text))
    bench = tmp_path / "bench.py"
    bench.write_text(textwrap.dedent(bench_text))
    cfg_cls, eng = (Config, engine) if port else (JaxConfig, jax_engine)
    cfg = cfg_cls(
        root=tmp_path, paths=[tmp_path / rel for rel in files], rules=rules,
        registry={} if registry is None else registry, tools_md=tools, resumable_py=resumable,
        gl004_allowlist=gl004_allowlist, gl005_modules=gl005_modules, gl006_modules=gl006_modules,
        gl007_modules=gl007_modules, gl007_registry=gl007_registry, gl008_modules=gl008_modules,
        gl010_modules=gl010_modules, telemetry_consumers=telemetry_consumers,
        observability_md=obs_md, robustness_md=rob_md, tests_dir=tests_dir, bench_py=bench)
    return eng.run(cfg)


def rules_fired(report):
    return sorted({f.rule for f in report.unwaived})


def keyset(report):
    return sorted((f.rule, f.path, f.line, f.waived) for f in report.findings)


# ---------------------------------------------------------------------------
# Parity: JAX's fixtures through both engines
# ---------------------------------------------------------------------------

GL009_POLICY = """
    LADDERS = {
        "grid": ("fast", "exact"),
    }

    FAULT_POINTS = frozenset({"chunk"})

    def record_degradation(engine, rung):
        pass

    def degrade():
        record_degradation("grid", "exact")
"""
GL009_FIRES = """
    def fire(point):
        pass

    def work():
        fire("chunk")
"""
GL009_DOC = """
    # robustness
    Ladder `grid`: `fast` then `exact`. Fault point: `chunk`.
"""
GL009_TEST = {"test_chaos.py": """
    def test_chunk_fires(monkeypatch):
        monkeypatch.setenv("CRIMP_TPU_FAULTS", "oom:chunk:1")
"""}
GL010_EMITTER = """
    from pkg import obs

    def work():
        obs.counter_add("widgets_made")
"""
GL010_OBS = """
    def counter_add(name, value=1):
        pass

    def gauge_set(name, value):
        pass
"""
GL010_DOC = "| `widgets_made` | counter |\n"
GL010_TEST = {"test_widgets.py": """
    def test_widgets_made_counts():
        assert "widgets_made"
"""}
LEDGER = """
    METRICS = {
        "toas_per_sec": {"field": "value", "better": "higher"},
    }
"""

PARITY = {
    # GL000 waiver hygiene
    "gl000-reasonless": ({"pkg/mod.py": """
        import numpy as np

        X = np.longdouble(1.5)  # graftlint: disable=GL004
    """}, dict(rules=("GL004",))),
    "gl000-unwaivable": ({"pkg/mod.py": """
        X = 1  # graftlint: disable=GL000,GL004 (trying to waive the waiver rule)
        import numpy as np

        Y = np.longdouble(1.5)  # graftlint: disable=GL004
    """}, dict(rules=("GL004",))),
    "gl000-string-inert": ({"pkg/mod.py": '''
        MSG = "write '# graftlint: disable=GLxxx (reason)' on the line"
    '''}, dict(rules=("GL004",))),
    "gl000-syntax-error": ({"pkg/mod.py": "def f(:\n    pass\n"}, dict(rules=("GL004",))),
    "gl000-malformed": ({"pkg/mod.py": "X = 1  # graftlint: disable=bogus\n"}, dict(rules=("GL004",))),
    # GL004 dtype discipline
    "gl004-longdouble": ({"pkg/mod.py": """
        import numpy as np

        X = np.longdouble(1.5)
    """}, dict(rules=("GL004",))),
    "gl004-mpmath": ({"pkg/mod.py": "import mpmath\n"}, dict(rules=("GL004",))),
    "gl004-allowlisted": ({"pkg/anchor.py": """
        import numpy as np

        X = np.longdouble(1.5)
    """}, dict(rules=("GL004",))),
    "gl004-file-waiver": ({"pkg/mod.py": """
        # graftlint: disable-file=GL004 (fixture: host-side longdouble module by design)
        import numpy as np

        X = np.longdouble(1.5)
        Y = np.longdouble(2.5)
    """}, dict(rules=("GL004",))),
    # GL005 order-sensitive reductions
    "gl005-parallel": ({"pkg/parallel/mod.py": """
        import torch

        def combine(a, b):
            return a @ b + torch.sum(a, 0) + torch.einsum("ij->j", a)
    """}, dict(rules=("GL005",))),
    "gl005-outside": ({"pkg/mod.py": """
        import torch

        def combine(a, b):
            return a @ b + torch.sum(a, 0)
    """}, dict(rules=("GL005",))),
    "gl005-waived": ({"pkg/parallel/mod.py": """
        import torch

        def combine(a):
            return torch.sum(a, 0)  # graftlint: disable=GL005 (fixture: replicated axis, fixed per-shard order)
    """}, dict(rules=("GL005",))),
    # GL006 failure domains
    "gl006-bare-exception": ({"pkg/mod.py": """
        def f():
            try:
                risky()
            except Exception as exc:
                return None
    """}, dict(rules=("GL006",))),
    "gl006-colon-and-tuple": ({"pkg/mod.py": """
        def f():
            try:
                risky()
            except:
                pass

        def g():
            try:
                risky()
            except (ValueError, Exception):
                pass
    """}, dict(rules=("GL006",))),
    "gl006-narrow": ({"pkg/mod.py": """
        def f():
            try:
                risky()
            except (ValueError, OSError):
                return None
    """}, dict(rules=("GL006",))),
    "gl006-classify": ({"pkg/mod.py": """
        from pkg import resilience

        def f():
            try:
                risky()
            except Exception as exc:
                return resilience.classify(exc)
    """}, dict(rules=("GL006",))),
    "gl006-error-record": ({"pkg/mod.py": """
        from pkg.resilience import error_record

        def f():
            try:
                risky()
            except Exception as exc:
                return error_record(exc)
    """}, dict(rules=("GL006",))),
    "gl006-reraise": ({"pkg/mod.py": """
        def f():
            try:
                risky()
            except Exception:
                cleanup()
                raise
    """}, dict(rules=("GL006",))),
    "gl006-outside-scope": ({"scripts/tool.py": """
        def f():
            try:
                risky()
            except Exception:
                pass
    """}, dict(rules=("GL006",))),
    "gl006-waived": ({"pkg/mod.py": """
        def f():
            try:
                risky()
            except Exception:  # graftlint: disable=GL006 (fixture: telemetry guard, deliberate swallow domain)
                pass
    """}, dict(rules=("GL006",))),
    # GL007: the fixtures where both engines stay silent
    "gl007-registry-sanctioned": ({"pkg/parallel/registry.py": """
        from jax.sharding import PartitionSpec as P

        RULE = P("events")
        SPEC = ("events", None)
    """}, dict(rules=("GL007",))),
    "gl007-outside-scope": ({"scripts/tool.py": """
        from jax.sharding import PartitionSpec as P

        SPEC = P("events")
        PLAIN = ("events",)
    """}, dict(rules=("GL007",))),
    "gl007-unrelated-p": ({"pkg/mod.py": """
        def P(x):
            return x

        Y = P(3)
    """}, dict(rules=("GL007",))),
    # GL008 concurrency
    "gl008-thread-unlocked": ({"pkg/worker.py": """
        import threading

        _CACHE = {}

        def _work():
            _CACHE["k"] = 1

        def start():
            threading.Thread(target=_work).start()
    """}, dict(rules=("GL008",))),
    "gl008-locked": ({"pkg/worker.py": """
        import threading

        _LOCK = threading.Lock()
        _CACHE = {}

        def _work():
            with _LOCK:
                _CACHE["k"] = 1

        def start():
            threading.Thread(target=_work).start()
    """}, dict(rules=("GL008",))),
    "gl008-lock-deleted": ({"pkg/worker.py": """
        import threading

        _LOCK = threading.Lock()
        _CACHE = {}

        def _work():
            _CACHE["k"] = 1

        def start():
            threading.Thread(target=_work).start()
    """}, dict(rules=("GL008",))),
    "gl008-executor": ({"pkg/pool.py": """
        from concurrent.futures import ThreadPoolExecutor

        _RESULTS = []

        def _job(x):
            _RESULTS.append(x)

        def run():
            pool = ThreadPoolExecutor(max_workers=1)
            pool.submit(_job, 1)
    """}, dict(rules=("GL008",))),
    "gl008-cross-module": ({
        "pkg/spawner.py": """
            import threading

            from pkg import cache

            def go():
                threading.Thread(target=cache.update).start()
        """,
        "pkg/cache.py": """
            _C = {}

            def update():
                _C["x"] = 1
        """}, dict(rules=("GL008",))),
    "gl008-lock-declaring-module": ({"pkg/state.py": """
        import threading

        _LOCK = threading.Lock()
        _STATE = {}
        LAUNCHES = {"k": 0}

        def set_state(v):
            _STATE["v"] = v

        def count():
            LAUNCHES["k"] += 1
    """}, dict(rules=("GL008",))),
    "gl008-tls-and-init": ({"pkg/tls.py": """
        import threading

        _TLS = threading.local()
        _TABLE = {}
        _TABLE["seed"] = 1

        def _work():
            _TLS.stack = []

        def start():
            threading.Thread(target=_work).start()
    """}, dict(rules=("GL008",))),
    "gl008-waived": ({"pkg/worker.py": """
        import threading

        _SEEN = set()

        def _work():
            _SEEN.add(1)  # graftlint: disable=GL008 (fixture: set.add is atomic under the GIL and readers tolerate staleness)

        def start():
            threading.Thread(target=_work).start()
    """}, dict(rules=("GL008",))),
    # GL009 resilience web
    "gl009-consistent": ({"pkg/policy.py": GL009_POLICY, "pkg/inject.py": GL009_FIRES},
                         dict(rules=("GL009",), robustness_md_text=GL009_DOC, tests=GL009_TEST)),
    "gl009-dead-rung": ({"pkg/policy.py": GL009_POLICY.replace(
        '        record_degradation("grid", "exact")', "        pass"), "pkg/inject.py": GL009_FIRES},
        dict(rules=("GL009",), robustness_md_text=GL009_DOC, tests=GL009_TEST)),
    "gl009-unregistered-rung": ({"pkg/policy.py": GL009_POLICY + """

    def degrade_more():
        record_degradation("grid", "imaginary")
        record_degradation("nope", "fast")
""", "pkg/inject.py": GL009_FIRES}, dict(rules=("GL009",), robustness_md_text=GL009_DOC, tests=GL009_TEST)),
    "gl009-no-fire-site": ({"pkg/policy.py": GL009_POLICY,
                            "pkg/inject.py": GL009_FIRES.replace('        fire("chunk")', "        pass")},
                           dict(rules=("GL009",), robustness_md_text=GL009_DOC, tests=GL009_TEST)),
    "gl009-no-firing-test": ({"pkg/policy.py": GL009_POLICY, "pkg/inject.py": GL009_FIRES},
                             dict(rules=("GL009",), robustness_md_text=GL009_DOC, tests={})),
    "gl009-no-docs-row": ({"pkg/policy.py": GL009_POLICY, "pkg/inject.py": GL009_FIRES},
                          dict(rules=("GL009",), robustness_md_text="# robustness\nLadder `grid`: `fast`.\n",
                               tests=GL009_TEST)),
    "gl009-unregistered-point": ({"pkg/policy.py": GL009_POLICY, "pkg/inject.py": GL009_FIRES + """

    def chaos():
        fire("undeclared")
"""}, dict(rules=("GL009",), robustness_md_text=GL009_DOC, tests=GL009_TEST)),
    # GL010 telemetry surface
    "gl010-clean": ({"pkg/mod.py": GL010_EMITTER, "pkg/obs.py": GL010_OBS},
                    dict(rules=("GL010",), observability_md_text=GL010_DOC, tests=GL010_TEST)),
    "gl010-undocumented": ({"pkg/mod.py": GL010_EMITTER, "pkg/obs.py": GL010_OBS},
                           dict(rules=("GL010",), observability_md_text="", tests=GL010_TEST)),
    "gl010-unconsumed": ({"pkg/mod.py": GL010_EMITTER, "pkg/obs.py": GL010_OBS},
                         dict(rules=("GL010",), observability_md_text=GL010_DOC, tests={})),
    "gl010-consumer-module": ({"pkg/mod.py": GL010_EMITTER, "pkg/obs.py": GL010_OBS, "pkg/report.py": """
        NAMES = ["widgets_made"]
    """}, dict(rules=("GL010",), observability_md_text=GL010_DOC, telemetry_consumers=("pkg/report.py",))),
    "gl010-cross-kind": ({"pkg/mod.py": """
        from pkg import obs

        def work():
            obs.counter_add("widgets_made")
            obs.gauge_set("widgets_made", 3)
    """, "pkg/obs.py": GL010_OBS}, dict(rules=("GL010",), observability_md_text=GL010_DOC, tests=GL010_TEST)),
    "gl010-dynamic-family": ({"pkg/mod.py": """
        from pkg import obs

        def work(status):
            obs.counter_add(f"widgets_{status}")
            obs.counter_add("a" if status else "b")
    """, "pkg/obs.py": GL010_OBS}, dict(rules=("GL010",), observability_md_text="", tests=GL010_TEST)),
    "gl010-fully-dynamic": ({"pkg/mod.py": """
        from pkg import obs

        def work(name):
            obs.counter_add(name)
    """, "pkg/obs.py": GL010_OBS}, dict(rules=("GL010",))),
    "gl010-ledger-fed": ({"pkg/ledger.py": LEDGER}, dict(rules=("GL010",), bench_text='{"value": 1}\n')),
    "gl010-ledger-unfed": ({"pkg/ledger.py": LEDGER}, dict(rules=("GL010",), bench_text="")),
    "gl010-waived": ({"pkg/mod.py": """
        from pkg import obs

        def work():
            obs.counter_add("widgets_made")  # graftlint: disable=GL010 (fixture: operator-facing only, scraped from the manifest by dashboards)
    """, "pkg/obs.py": GL010_OBS}, dict(rules=("GL010",), observability_md_text="", tests={})),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_same_findings_as_jax(tmp_path, case):
    files, kw = PARITY[case]
    jax_rep = run_tree(tmp_path / "jax", files, port=False, **kw)
    port_rep = run_tree(tmp_path / "port", files, port=True, **kw)
    assert keyset(port_rep) == keyset(jax_rep)
    assert port_rep.counts() == jax_rep.counts()
    assert port_rep.files_scanned == jax_rep.files_scanned


def test_parity_set_fires_every_copied_rule(tmp_path):
    """The parity set is not all silence: each copied rule fires in it."""
    fired = set()
    for case, (files, kw) in PARITY.items():
        fired |= set(rules_fired(run_tree(tmp_path / case, files, **kw)))
    assert fired == {"GL000", "GL004", "GL005", "GL006", "GL008", "GL009", "GL010"}


# ---------------------------------------------------------------------------
# GL001 capture purity (retargeted)
# ---------------------------------------------------------------------------


class TestGL001Capture:
    def test_env_read_in_capture_body_fires(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/mod.py": """
            import os
            import torch

            def run(g, x):
                with torch.cuda.graph(g):
                    y = x * float(os.environ.get("SCALE", "1"))
                return y
        """}, rules=("GL001",))
        assert rules_fired(rep) == ["GL001"]
        assert "os.environ" in rep.unwaived[0].message and "<capture@" in rep.unwaived[0].message

    def test_clock_read_just_outside_the_capture_is_clean(self, tmp_path):
        """ops/mcmc.py::_run_graphed reads the clock on the line before its
        ``with torch.cuda.graph(graph):`` and after it: host code."""
        rep = run_tree(tmp_path, {"pkg/mod.py": """
            import time
            import torch

            def _steps(x):
                return x * 2

            def run(x):
                graph = torch.cuda.CUDAGraph()
                t0 = time.perf_counter()
                with torch.cuda.graph(graph):
                    out = _steps(x)
                took = time.perf_counter() - t0
                return out, took
        """}, rules=("GL001",))
        assert rep.unwaived == []

    def test_transitive_reachability_through_helpers(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/mod.py": """
            import time
            import torch

            def _inner(x):
                time.sleep(0.1)
                return x

            def _steps(x):
                return _inner(x)

            def run(g, x):
                with torch.cuda.graph(g):
                    return _steps(x)
        """}, rules=("GL001",))
        assert rules_fired(rep) == ["GL001"]
        assert "_inner" in rep.unwaived[0].message and "time.sleep" in rep.unwaived[0].message

    def test_torch_compile_decorator_and_graphed_callables(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/mod.py": """
            import os
            import random
            import torch
            from functools import partial

            @torch.compile
            def a(x):
                return x + len(os.getenv("A", ""))

            @partial(torch.compile, mode="reduce-overhead")
            def b(x):
                return open("f").read()

            def c(x):
                return x * random.random()

            def d(x):
                return x.read_text()

            step = torch.cuda.make_graphed_callables(c, (1,))
            compiled = torch.compile(d)
        """}, rules=("GL001",))
        assert len(rep.unwaived) == 4
        assert {f.message.split(" inside ")[0] for f in rep.unwaived} == {
            "os.getenv() call", "open() call (file I/O in captured code)",
            "random.random() call (host RNG in captured code)", ".read_text() call (file I/O in captured code)"}

    def test_re_compile_is_not_a_capture(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/mod.py": """
            import os
            import re

            def pattern():
                return os.environ.get("P", "x")

            R = re.compile(pattern)
        """}, rules=("GL001",))
        assert rep.unwaived == []

    def test_knob_accessor_and_obs_api_from_captured_code_fire(self, tmp_path):
        rep = run_tree(tmp_path, {
            "crimp_tpu_torch/knobs.py": """
                def env_onoff(name):
                    return True
            """,
            "crimp_tpu_torch/obs/__init__.py": """
                def counter_add(name, value=1):
                    return None
            """,
            "pkg/mod.py": """
                import torch
                from crimp_tpu_torch import obs
                from crimp_tpu_torch.knobs import env_onoff

                def run(g, x):
                    with torch.cuda.graph(g):
                        if env_onoff("CRIMP_TORCH_POLY_TRIG"):
                            x = x + 1
                        obs.counter_add("events_folded", 1)
            """,
        }, rules=("GL001",))
        msgs = sorted(f.message for f in rep.unwaived)
        assert len(msgs) == 2
        assert "knob accessor env_onoff()" in msgs[0] and "obs API counter_add()" in msgs[1]

    def test_waived_with_reason(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/mod.py": """
            import os
            import torch

            def run(g, x):
                with torch.cuda.graph(g):
                    return x * len(os.environ)  # graftlint: disable=GL001 (fixture: deliberate violation kept for a test)
        """}, rules=("GL001",))
        assert rep.unwaived == []
        assert [f.rule for f in rep.findings if f.waived] == ["GL001"]


# ---------------------------------------------------------------------------
# GL002 host syncs in captured code (retargeted)
# ---------------------------------------------------------------------------


class TestGL002Capture:
    def test_item_in_capture_body_fires(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/mod.py": """
            import torch

            def run(g, x):
                with torch.cuda.graph(g):
                    total = x.sum().item()
                return total
        """}, rules=("GL002",))
        assert rules_fired(rep) == ["GL002"]
        assert ".item()" in rep.unwaived[0].message and "stream capture" in rep.unwaived[0].message

    @pytest.mark.parametrize("sync", ["x.cpu()", "x.numpy()", "x.tolist()", "torch.nonzero(x)", "x.nonzero()",
                                      "torch.cuda.synchronize()"])
    def test_syncs_in_a_captured_helper_fire(self, tmp_path, sync):
        rep = run_tree(tmp_path, {"pkg/mod.py": f"""
            import torch

            def _step(x):
                return {sync}

            def run(g, x):
                with torch.cuda.graph(g):
                    return _step(x)
        """}, rules=("GL002",))
        assert rules_fired(rep) == ["GL002"]
        assert rep.unwaived[0].line == 5

    def test_coercion_and_branch_on_tensor_parameter_fire(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/mod.py": """
            import torch

            def _step(x, n: int = 2):
                if n > 1:
                    x = x * n
                if x > 0:
                    return float(x)
                return x

            def run(g, x):
                with torch.cuda.graph(g):
                    return _step(x)
        """}, rules=("GL002",))
        assert [f.line for f in rep.unwaived] == [7, 8]
        assert "branch" in rep.unwaived[0].message and "float()" in rep.unwaived[1].message

    def test_is_none_and_host_code_are_clean(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/mod.py": """
            import torch

            def _step(x, w=None):
                if w is None:
                    return x
                return x * w

            def run(g, x):
                with torch.cuda.graph(g):
                    out = _step(x)
                return out.sum().item(), out.cpu()
        """}, rules=("GL002",))
        assert rep.unwaived == []


# ---------------------------------------------------------------------------
# GL003 knob registry under CRIMP_TORCH_ (retargeted)
# ---------------------------------------------------------------------------

FAKE_REG = {"CRIMP_TORCH_FAKE": knobs.Knob("CRIMP_TORCH_FAKE", "unset", "int", numeric_key="fake_mode")}
FAKE_DOCS = "| `CRIMP_TORCH_FAKE` | unset | fixture knob |\n"


class TestGL003Torch:
    def _run(self, tmp_path, files, **kw):
        kw.setdefault("registry", FAKE_REG)
        kw.setdefault("tools_md_text", FAKE_DOCS)
        return run_tree(tmp_path, files, rules=("GL003",), **kw)

    def test_read_outside_knobs_module_fires(self, tmp_path):
        rep = self._run(tmp_path, {"pkg/mod.py": """
            import os

            X = os.environ["CRIMP_TORCH_FAKE"]
            Y = os.getenv("CRIMP_TORCH_FAKE")
        """})
        assert [f.line for f in rep.unwaived] == [4, 5]
        assert all("outside crimp_tpu_torch/knobs.py" in f.message for f in rep.unwaived)

    def test_unregistered_read_and_write_fire(self, tmp_path):
        rep = self._run(tmp_path, {"pkg/mod.py": """
            import os

            X = os.environ.get("CRIMP_TORCH_NOT_DECLARED", "")
            os.environ["CRIMP_TORCH_TYPO"] = "1"
        """})
        msgs = [f.message for f in rep.unwaived]
        assert len(msgs) == 2
        assert "env read of unregistered knob CRIMP_TORCH_NOT_DECLARED" in msgs[0]
        assert "env write of unregistered knob CRIMP_TORCH_TYPO" in msgs[1]

    def test_sanctioned_site_and_script_writes_are_clean(self, tmp_path):
        rep = self._run(tmp_path, {
            "crimp_tpu_torch/knobs.py": """
                import os

                X = os.environ.get("CRIMP_TORCH_FAKE", "")
            """,
            "chip_smoke.py": """
                import os

                os.environ["CRIMP_TORCH_FAKE"] = "1"
                del os.environ["CRIMP_TORCH_FAKE"]
                Z = os.environ.get("CRIMP_TPU_OTHER_PACKAGE", "")
            """})
        assert rep.unwaived == []

    def test_shell_read_of_unregistered_knob_fires(self, tmp_path):
        rep = self._run(tmp_path, {"scripts/x.sh": """
            #!/usr/bin/env bash
            # a mention in a comment is not a read: $CRIMP_TORCH_COMMENT_ONLY
            echo "${CRIMP_TORCH_SHELL_ONLY:-}"
        """})
        msgs = [f.message for f in rep.unwaived]
        assert len(msgs) == 1 and "CRIMP_TORCH_SHELL_ONLY" in msgs[0]

    def test_missing_docs_row_and_fingerprint_key_fire(self, tmp_path):
        rep = self._run(tmp_path, {"pkg/mod.py": "X = 1\n"}, tools_md_text="", numeric_keys=())
        msgs = [f.message for f in rep.unwaived]
        assert len(msgs) == 2
        assert "CRIMP_TORCH_FAKE" in msgs[0] and "tools.md" in msgs[0]
        assert "fake_mode" in msgs[1] and "numeric_mode" in msgs[1]

    def test_the_real_registry_is_namespaced_and_consistent(self, tmp_path):
        rep = self._run(tmp_path, {"pkg/mod.py": "X = 1\n"}, registry=dict(knobs.REGISTRY),
                        tools_md_text="\n".join(f"| `{k}` |" for k in knobs.REGISTRY),
                        numeric_keys=tuple(k.numeric_key for k in knobs.REGISTRY.values() if k.numeric_key))
        assert rep.unwaived == []
        assert {k.removeprefix("CRIMP_TORCH_") for k in knobs.REGISTRY} <= {
            k.removeprefix("CRIMP_TPU_") for k in jax_knobs.REGISTRY}


# ---------------------------------------------------------------------------
# GL007 spec tuples (retargeted)
# ---------------------------------------------------------------------------


class TestGL007SpecTuples:
    def test_hand_written_spec_tuples_fire(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/ops/fold.py": """
            from pkg.parallel import mesh as pmesh
            from pkg.parallel.registry import EVENT_AXIS

            A = ("events", None)
            B = (EVENT_AXIS, None, None)
            C = (pmesh.SOURCE_AXIS,)
        """}, rules=("GL007",))
        assert [f.line for f in rep.unwaived] == [5, 6, 7]
        assert "spec tuple" in rep.unwaived[0].message

    def test_registry_axis_names_and_non_specs_are_clean(self, tmp_path):
        rep = run_tree(tmp_path, {
            "pkg/parallel/registry.py": """
                EVENT_AXIS = "events"
                RULE = (EVENT_AXIS,)
            """,
            "pkg/parallel/mesh.py": """
                from pkg.parallel.registry import EVENT_AXIS, TRIAL_AXIS

                def build_mesh(devices, axis_names=(EVENT_AXIS, TRIAL_AXIS)):
                    return Mesh(devices, (EVENT_AXIS, TRIAL_AXIS))

                def check(mesh):
                    return mesh.axis_names == (TRIAL_AXIS, EVENT_AXIS)

                PAD = (None, None)
                WORDS = ("events", "x")
            """}, rules=("GL007",))
        assert rep.unwaived == []

    def test_axes_come_from_the_scanned_registry(self, tmp_path):
        rep = run_tree(tmp_path, {
            "pkg/parallel/registry.py": """
                BAND_AXIS = "bands"
            """,
            "pkg/mod.py": """
                SPEC = ("bands", None)
                OLD = ("events", None)
            """}, rules=("GL007",))
        assert [(f.path, f.line) for f in rep.unwaived] == [("pkg/mod.py", 2)]

    def test_waived_with_reason(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/mod.py": """
            SPEC = ("events",)  # graftlint: disable=GL007 (fixture: spec is kernel-private, not a dispatch rule)
        """}, rules=("GL007",))
        assert rep.unwaived == [] and [f.rule for f in rep.findings if f.waived] == ["GL007"]


class TestGL010AnnotatedLedger:
    """The port's facts layer also reads an annotated ``METRICS: dict = {...}``
    literal, as the port's obs/ledger.py writes it."""

    ANNOTATED = LEDGER.replace("METRICS = {", "METRICS: dict[str, dict] = {")

    @pytest.mark.parametrize("bench,fired", [('{"value": 1}\n', 0), ("", 1)], ids=["fed", "unfed"])
    def test_annotated_metrics_literal(self, tmp_path, bench, fired):
        rep = run_tree(tmp_path, {"pkg/ledger.py": self.ANNOTATED}, rules=("GL010",), bench_text=bench)
        assert [f.line for f in rep.unwaived] == [2] * fired
        assert all("never produces it" in f.message for f in rep.unwaived)


# ---------------------------------------------------------------------------
# report / CLI / baseline / SARIF
# ---------------------------------------------------------------------------

FINDING_KEYS = {"rule", "path", "line", "message", "waived", "reason"}


class TestReportAndCli:
    def test_json_schema(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/mod.py": "import numpy as np\nX = np.longdouble(1.5)\n"}, rules=("GL004",))
        doc = rep.to_dict()
        assert doc["version"] == 1 and doc["tool"] == "graftlint" and doc["files_scanned"] == 1
        assert doc["counts"] == {"GL004": 1}
        assert all(set(f) == FINDING_KEYS for f in doc["findings"])
        json.dumps(doc)

    def test_cli_exit_codes_and_json(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text("import numpy as np\nX = np.longdouble(1.5)\n")
        assert cli.main(["--root", str(tmp_path), "--format", "json", "--rules", "GL004", str(bad)]) == 1
        doc = json.loads(capsys.readouterr().out)
        assert [f["rule"] for f in doc["new_findings"]] == ["GL004"]
        ok = tmp_path / "ok.py"
        ok.write_text("X = 1\n")
        assert cli.main(["--root", str(tmp_path), "--rules", "GL004", str(ok)]) == 0
        assert cli.main(["--root", str(tmp_path), str(tmp_path / "nope.py")]) == 2
        capsys.readouterr()

    def test_baseline_ratchet_and_refused_growth(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text("import numpy as np\nX = np.longdouble(1.5)\n")
        base = tmp_path / "base.json"
        args = ["--root", str(tmp_path), "--rules", "GL004", str(bad)]
        assert cli.main([*args, "--write-baseline", str(base)]) == 0
        assert cli.main([*args, "--baseline", str(base)]) == 0
        bad.write_text("import numpy as np\n\n\nX = np.longdouble(1.5)\nY = np.float128(2.5)\n")
        assert cli.main([*args, "--baseline", str(base)]) == 1
        assert cli.main([*args, "--write-baseline", str(base)]) == 2
        assert "refusing to grow" in capsys.readouterr().err
        assert cli.main([*args, "--write-baseline", str(base), "--allow-growth"]) == 0
        assert len(load_baseline(base)) == 2
        capsys.readouterr()

    def test_baseline_keys_are_line_free(self, tmp_path):
        rep = run_tree(tmp_path, {"pkg/mod.py": "import numpy as np\nX = np.longdouble(1.5)\n"}, rules=("GL004",))
        base = tmp_path / "b.json"
        save_baseline(rep, base)
        assert new_findings(rep, load_baseline(base)) == []
        assert all(k.count("|") >= 2 and ":" not in k.split("|")[1] for k in load_baseline(base))

    def test_sarif_validates_and_suppresses_waivers(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text("import numpy as np\nX = np.longdouble(1.5)\n"
                       "Y = np.longdouble(2.5)  # graftlint: disable=GL004 (fixture: host-side anchor arithmetic)\n")
        assert cli.main(["--root", str(tmp_path), "--format", "sarif", "--rules", "GL004", str(bad)]) == 1
        doc = json.loads(capsys.readouterr().out)
        assert sarif.validate_minimal(doc) == []
        results = doc["runs"][0]["results"]
        assert [("suppressions" in r) for r in results] == [False, True]
        assert results[0]["locations"][0]["physicalLocation"]["region"]["startLine"] == 2
        assert sarif.validate_minimal({"version": "2.1.0"}) != []

    def test_changed_only_and_waiver_table(self, tmp_path, capsys, monkeypatch):
        changed = tmp_path / "changed.py"
        changed.write_text("import numpy as np\nX = np.longdouble(1.5)  # graftlint: disable=GL004 (fixture: host anchor)\n"
                           "Y = np.longdouble(2.5)\n")
        stable = tmp_path / "stable.py"
        stable.write_text("import numpy as np\nZ = np.longdouble(2.5)\n")
        monkeypatch.setattr(cli, "changed_paths", lambda root: {"changed.py"})
        args = ["--root", str(tmp_path), "--rules", "GL004", "--changed-only", str(changed), str(stable)]
        assert cli.main(args) == 1
        assert "1 failing" in capsys.readouterr().out
        monkeypatch.setattr(cli, "changed_paths", lambda root: set())
        assert cli.main(args) == 0
        assert cli.main(["--root", str(tmp_path), "--waivers", str(changed)]) == 0
        out = capsys.readouterr().out
        assert "| GL004 | `changed.py:2` | fixture: host anchor |" in out and "1 waivers." in out

    def test_default_paths_are_the_port_and_the_smoke(self):
        assert cli.DEFAULT_PATHS == ("crimp_tpu_torch", "chip_smoke.py")
        assert cli.build_parser().prog == "python -m crimp_tpu_torch.analysis"
