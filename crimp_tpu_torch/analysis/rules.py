"""graftlint rules GL001/GL002/GL004-GL010 (GL003 lives in knobcheck.py).

Port of ``crimp_tpu/analysis/rules.py``: GL004-GL006 and GL008-GL010 are
the JAX package's rules over the port's paths; GL001, GL002 and GL007 are
retargeted from JAX traces and ``PartitionSpec`` to CUDA-graph capture and
the port's spec tuples. Each rule is a function ``(cfg, sources, project)
-> list[Finding]`` over the parsed scan set:

GL001  capture purity — no ``os.environ``/``time``/``random``/file-I/O
       reachable from code that runs under CUDA-graph capture (a
       ``torch.cuda.graph`` body, ``make_graphed_callables``,
       ``torch.compile``): a replay re-runs the recorded kernels, never
       the host side. Knob resolution is host-side by contract, so calls
       into ``crimp_tpu_torch.knobs``, the ``ops/autotune.py`` resolvers
       or the obs API from captured code are violations too.
GL002  host-sync hazards — ``.item()``/``.tolist()``/``.cpu()``/
       ``.numpy()``, ``torch.nonzero`` and ``torch.cuda.synchronize()``
       anywhere in captured code, ``float()``/``int()``/``bool()`` and
       ``np.asarray``/``np.array`` applied to (non-static) parameters of
       captured functions, and Python ``if``/``while`` branching on a
       non-static parameter of a capture entry point: each syncs the
       stream, which stream capture forbids.
GL004  dtype discipline — ``longdouble``/``float128`` confined to the
       host-side anchor modules (the allowlist in core.DEFAULT_GL004_ALLOWLIST);
       everywhere else the f64 device path is the contract.
GL005  order-sensitive reductions — matmul/dot/einsum/axis-sums in the
       sharded parity-pinned modules (crimp_tpu_torch/parallel/) must carry
       a waiver stating the fixed-order/parity argument (the JAX package's
       lesson: a library re-tiles matvec reductions per shape, so a sharded
       matvec broke its 8-device bitwise pin; the port's sharded twins rest
       on split-ordered partial sums).
GL006  failure-domain discipline — a bare ``except Exception`` inside
       crimp_tpu_torch/ must route the exception through
       ``resilience.classify``/``error_record`` (so retry/degradation
       policy sees a FailureKind, not a swallowed traceback), bare-
       re-raise it, or carry a waiver stating why this handler is a
       deliberate swallow domain (telemetry guards are the baseline).
GL007  sharding-registry discipline — a spec tuple (a tuple literal of
       ``None`` and registry axis names, at least one axis) written by
       hand anywhere in crimp_tpu_torch/ except parallel/registry.py must
       carry a waiver: specs scattered across call sites are exactly the
       bespoke-sharded-twin drift the registry exists to end (dispatch
       sites ask ``registry.specs_for(kernel, mesh)`` instead). A mesh's
       ``axis_names`` and a comparison's operands name axes, split
       nothing, and are exempt.
GL008  concurrency discipline — a module-level global mutated from code
       reachable from a thread spawn / executor callback must hold a
       declared module lock, and a module that declares such a lock
       keeps ALL its global mutations lock-guarded (the obs/core.py
       ``_LOCK`` and profiling ``_TIMES_LOCK`` patterns, enforced).
       Intentionally lock-free paths carry a mandatory-reason waiver.
GL009  resilience contract web — LADDERS engine/rung pairs, the
       FAULT_POINTS registry, their ``record_degradation()``/``fire()``
       call sites, firing tests in tests/, and the port's
       docs/robustness.md are
       cross-checked in all directions (the GL003 pattern, applied to
       the resilience layer).
GL010  telemetry-surface drift — every obs counter/gauge literal is
       unique, documented in the port's docs/observability.md, and
       consumed by obs/report.py, obs/ledger.py or a test (or waived);
       dynamic f-string families document their static prefix; every
       ledger METRICS key names a record field chip_smoke.py produces.

GL008-GL010 consume the cross-file facts layer (analysis/facts.py).
"""

from __future__ import annotations

import ast
import pathlib
import re

from crimp_tpu_torch.analysis import facts as facts_mod
from crimp_tpu_torch.analysis.callgraph import (
    FunctionInfo,
    Project,
    call_tail,
    dotted,
    iter_body_nodes,
)
from crimp_tpu_torch.analysis.core import Config, Finding, SourceFile

# -- GL001 -------------------------------------------------------------------

TIME_FUNCS = {"time", "perf_counter", "perf_counter_ns", "monotonic",
              "monotonic_ns", "sleep", "process_time", "thread_time"}
FILE_IO_TAILS = {"read_text", "write_text", "read_bytes", "write_bytes"}
# host-side knob/tuner resolution entry points (ops/autotune.py): calling
# these from captured code would re-introduce implicit env reads/timing
RESOLVER_PREFIXES = ("resolve_", "cached_", "autotune_mode", "tune",
                     "sweep_candidates")


def _gl001_banned(node: ast.AST, mod, project: Project,
                  scope: str | None) -> str | None:
    """A human message if this node is a banned host operation."""
    if isinstance(node, ast.Attribute) and node.attr == "environ":
        if isinstance(node.value, ast.Name) and node.value.id == "os":
            return "os.environ access"
    if not isinstance(node, ast.Call):
        return None
    path = dotted(node.func) or ""
    tail = call_tail(node.func)
    if path == "os.getenv":
        return "os.getenv() call"
    head = path.split(".")[0] if path else ""
    if head == "time" and tail in TIME_FUNCS:
        return f"time.{tail}() call (no implicit timing in captured code)"
    if head == "random":
        return f"random.{tail}() call (host RNG in captured code)"
    if isinstance(node.func, ast.Name) and node.func.id == "open":
        return "open() call (file I/O in captured code)"
    if tail in FILE_IO_TAILS:
        return f".{tail}() call (file I/O in captured code)"
    target = project.resolve_callable(mod, scope, node.func)
    if target is not None:
        if target.module == "crimp_tpu_torch/knobs.py" or target.module.endswith(
                "/crimp_tpu_torch/knobs.py"):
            return (f"knob accessor {target.name}() reached from captured code "
                    "(knobs must resolve host-side)")
        if (target.module.endswith("ops/autotune.py")
                and target.name.startswith(RESOLVER_PREFIXES)):
            return (f"autotune resolver {target.name}() reached from captured "
                    "code (resolution is host-side by contract)")
        if "crimp_tpu_torch/obs/" in target.module:
            return (f"obs API {target.name}() reached from captured code "
                    "(telemetry is host-side by construction)")
    return None


def rule_gl001(cfg: Config, sources: dict[str, SourceFile],
               project: Project) -> list[Finding]:
    out: list[Finding] = []
    for info in project.traced_functions().values():
        mod = project.modules[info.module]
        scope = info.scope
        for node in iter_body_nodes(info.node):
            msg = _gl001_banned(node, mod, project, scope)
            if msg:
                out.append(Finding(
                    "GL001", info.module, getattr(node, "lineno", info.lineno),
                    f"{msg} inside captured function {info.qualname!r} "
                    f"({info.traced_via})"))
    return out


# -- GL002 -------------------------------------------------------------------

# zero-argument tensor methods that copy to the host and so sync the stream
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _tensor_params(info: FunctionInfo) -> set[str]:
    skip = set(info.static_params)
    if info.class_name is not None:
        skip.add("self")
        skip.add("cls")
    return set(info.params) - skip


def _is_none_check(test: ast.AST) -> bool:
    """``x is None`` / ``x is not None`` tests read no tensor."""
    return (isinstance(test, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops))


def _sync_call(node: ast.Call) -> str | None:
    """The name of a host sync this call makes, if it is one."""
    tail = call_tail(node.func)
    path = dotted(node.func) or ""
    if tail in SYNC_METHODS and not node.args and isinstance(node.func, ast.Attribute):
        return f".{tail}()"
    if tail == "nonzero" and (path.startswith("torch.") or isinstance(node.func, ast.Attribute)):
        return "torch.nonzero()" if path == "torch.nonzero" else ".nonzero()"
    if path.endswith("cuda.synchronize"):
        return "torch.cuda.synchronize()"
    return None


def rule_gl002(cfg: Config, sources: dict[str, SourceFile],
               project: Project) -> list[Finding]:
    out: list[Finding] = []
    for info in project.traced_functions().values():
        tensors = _tensor_params(info)
        for node in iter_body_nodes(info.node):
            if isinstance(node, ast.Call):
                sync = _sync_call(node)
                if sync:
                    out.append(Finding(
                        "GL002", info.module, node.lineno,
                        f"{sync} in captured function {info.qualname!r} "
                        "forces a device sync, which breaks stream capture"))
                    continue
                path = dotted(node.func) or ""
                coercer = None
                if (isinstance(node.func, ast.Name)
                        and node.func.id in ("float", "int", "bool")):
                    coercer = node.func.id
                elif path in ("np.asarray", "np.array", "numpy.asarray",
                              "numpy.array", "np.float64", "np.float32"):
                    coercer = path
                if coercer and node.args:
                    touched = _names_in(node.args[0]) & tensors
                    if touched:
                        out.append(Finding(
                            "GL002", info.module, node.lineno,
                            f"{coercer}() applied to parameter "
                            f"{'/'.join(sorted(touched))} of captured function "
                            f"{info.qualname!r} (copies a tensor to the host)"))
            elif (isinstance(node, (ast.If, ast.While))
                  and info.entry_reason is not None
                  and not _is_none_check(node.test)):
                touched = _names_in(node.test) & tensors
                if touched:
                    out.append(Finding(
                        "GL002", info.module, node.lineno,
                        f"Python branch on parameter "
                        f"{'/'.join(sorted(touched))} of capture entry "
                        f"{info.qualname!r} ({info.entry_reason}); mark it "
                        "static (an int/bool/str/float annotation) or use "
                        "torch.where"))
    return out


# -- GL004 -------------------------------------------------------------------

EXTENDED_DTYPES = {"longdouble", "float128"}


def rule_gl004(cfg: Config, sources: dict[str, SourceFile],
               project: Project) -> list[Finding]:
    out: list[Finding] = []
    for rel, src in sources.items():
        if not src.is_python or src.tree is None:
            continue
        if any(rel == a or rel.startswith(a) for a in cfg.gl004_allowlist):
            continue
        for node in ast.walk(src.tree):
            name = None
            if isinstance(node, ast.Attribute) and node.attr in EXTENDED_DTYPES:
                name = dotted(node) or node.attr
            elif isinstance(node, ast.Name) and node.id in EXTENDED_DTYPES:
                name = node.id
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                modname = getattr(node, "module", None) or ""
                if modname.split(".")[0] == "mpmath" or any(
                        a.name.split(".")[0] == "mpmath" for a in node.names):
                    name = "mpmath import"
            if name:
                out.append(Finding(
                    "GL004", rel, node.lineno,
                    f"{name} outside the host-side anchor allowlist "
                    f"({', '.join(cfg.gl004_allowlist)}) — extended precision "
                    "is confined so device kernels stay f64-reproducible"))
    return out


# -- GL005 -------------------------------------------------------------------

ORDER_SENSITIVE_TAILS = {"dot", "matmul", "einsum", "tensordot", "inner",
                         "vdot"}


def rule_gl005(cfg: Config, sources: dict[str, SourceFile],
               project: Project) -> list[Finding]:
    out: list[Finding] = []
    for rel, src in sources.items():
        if not src.is_python or src.tree is None:
            continue
        if not any(rel == m or rel.startswith(m) for m in cfg.gl005_modules):
            continue
        for node in ast.walk(src.tree):
            msg = None
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
                msg = "matmul operator (@)"
            elif isinstance(node, ast.Call):
                tail = call_tail(node.func)
                if tail in ORDER_SENSITIVE_TAILS:
                    msg = f"{tail}()"
                elif tail == "sum" and (node.args or any(
                        k.arg == "axis" for k in node.keywords)):
                    msg = "axis reduction sum()"
            if msg:
                out.append(Finding(
                    "GL005", rel, node.lineno,
                    f"{msg} in sharded/parity-pinned module — a library "
                    "re-tiles matvec/axis reductions per shape (which broke "
                    "the JAX package's 8-device bitwise pin once); use "
                    "fixed-order accumulation or waive with the parity "
                    "argument"))
    return out


# -- GL006 -------------------------------------------------------------------

# Calls whose dotted tail proves the handler classified the failure:
# resilience.classify(exc) or resilience.error_record(exc) (the latter
# embeds classify and is the info-dict form the survey uses).
CLASSIFY_TAILS = {"classify", "error_record"}


def _gl006_broad(type_node) -> bool:
    """Whether an ExceptHandler's type catches everything."""
    if type_node is None:
        return True  # bare `except:`
    elts = type_node.elts if isinstance(type_node, ast.Tuple) else [type_node]
    return any(isinstance(n, ast.Name)
               and n.id in ("Exception", "BaseException") for n in elts)


def _gl006_classifies(handler: ast.ExceptHandler) -> bool:
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Call) and call_tail(sub.func) in CLASSIFY_TAILS:
            return True
        if isinstance(sub, ast.Raise) and sub.exc is None:
            # a bare re-raise keeps the exception in flight — the caller's
            # failure domain owns classification
            return True
    return False


# -- GL007 -------------------------------------------------------------------

# the registry's mesh axes (parallel/registry.py), read from the registry
# when it is in the scan set
DEFAULT_SPEC_AXES = {"EVENT_AXIS": "events", "TRIAL_AXIS": "trials",
                     "SEGMENT_AXIS": "segments", "SOURCE_AXIS": "sources"}


def _registry_axes(cfg: Config, sources: dict[str, SourceFile]) -> dict[str, str]:
    """Axis-name constants (``*_AXIS = "..."``) of the registry module."""
    src = sources.get(cfg.gl007_registry)
    if src is None or src.tree is None:
        return dict(DEFAULT_SPEC_AXES)
    axes = {}
    for stmt in src.tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id.endswith("_AXIS")
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)):
            axes[stmt.targets[0].id] = stmt.value.value
    return axes or dict(DEFAULT_SPEC_AXES)


def _is_spec_tuple(node: ast.Tuple, axes: dict[str, str]) -> bool:
    """A tuple literal of None and axis names (constants or their string
    values), naming at least one axis."""
    n_axes = 0
    for el in node.elts:
        if isinstance(el, ast.Constant) and el.value is None:
            continue
        if isinstance(el, ast.Constant) and el.value in axes.values():
            n_axes += 1
        elif call_tail(el) in axes and dotted(el) is not None:
            n_axes += 1
        else:
            return False
    return n_axes > 0


def _axis_name_tuples(tree: ast.AST) -> set[int]:
    """ids of tuples that name a mesh's axes and split nothing: a mesh's
    ``axis_names`` (``Mesh(devices, axis_names)``, an ``axis_names=``
    keyword or parameter default) and the operands of a comparison (a
    check of a mesh's axes)."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and call_tail(node.func) == "Mesh":
            if len(node.args) > 1:
                out.add(id(node.args[1]))
            out.update(id(k.value) for k in node.keywords if k.arg == "axis_names")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            positional = [*a.posonlyargs, *a.args]
            pairs = [*zip(positional[len(positional) - len(a.defaults):], a.defaults),
                     *zip(a.kwonlyargs, a.kw_defaults)]
            out.update(id(d) for arg, d in pairs if arg.arg == "axis_names" and d is not None)
        elif isinstance(node, ast.Compare):
            out.update(id(x) for x in (node.left, *node.comparators))
    return out


def rule_gl007(cfg: Config, sources: dict[str, SourceFile],
               project: Project) -> list[Finding]:
    out: list[Finding] = []
    axes = _registry_axes(cfg, sources)
    for rel, src in sources.items():
        if not src.is_python or src.tree is None:
            continue
        if rel == cfg.gl007_registry:
            continue  # the registry is the one sanctioned spec-writing site
        if not any(rel == m or rel.startswith(m) for m in cfg.gl007_modules):
            continue
        exempt = _axis_name_tuples(src.tree)
        for node in ast.walk(src.tree):
            if (isinstance(node, ast.Tuple) and id(node) not in exempt
                    and _is_spec_tuple(node, axes)):
                out.append(Finding(
                    "GL007", rel, node.lineno,
                    "hand-written spec tuple outside "
                    f"{cfg.gl007_registry} — dispatch sites take their specs "
                    "from registry.specs_for(kernel, mesh) so shardings "
                    "cannot drift per call site; waive with the reason this "
                    "spec cannot live in the registry"))
    return out


def rule_gl006(cfg: Config, sources: dict[str, SourceFile],
               project: Project) -> list[Finding]:
    out: list[Finding] = []
    for rel, src in sources.items():
        if not src.is_python or src.tree is None:
            continue
        if not any(rel == m or rel.startswith(m) for m in cfg.gl006_modules):
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _gl006_broad(node.type):
                continue
            if _gl006_classifies(node):
                continue
            out.append(Finding(
                "GL006", rel, node.lineno,
                "bare `except Exception` without failure classification — "
                "route it through resilience.classify/error_record so "
                "retry/degradation policy sees its FailureKind, or waive "
                "with the reason this handler is a deliberate swallow "
                "domain"))
    return out


# -- GL008/GL009/GL010 helpers ------------------------------------------------


def _in_modules(rel: str, modules: tuple[str, ...]) -> bool:
    return any(rel == m or rel.startswith(m) for m in modules)


def _mentions(text: str, name: str) -> bool:
    """Word-boundary-ish containment: ``grid`` must not match
    ``grid_mxu`` (identifier characters end the word)."""
    return re.search(r"(?<![A-Za-z0-9_])" + re.escape(name)
                     + r"(?![A-Za-z0-9_])", text) is not None


def _read_optional(path: pathlib.Path) -> str:
    try:
        return path.read_text(encoding="utf-8", errors="replace")
    except OSError:
        return ""


def _tests_corpus(cfg: Config) -> str:
    """Concatenated text of tests/*.py — the 'is there a test touching
    this name' side of the GL009/GL010 webs."""
    tests_dir = cfg.resolved_tests_dir()
    if not tests_dir.is_dir():
        return ""
    return "\n".join(_read_optional(p) for p in sorted(tests_dir.glob("*.py")))


# -- GL008 -------------------------------------------------------------------


def rule_gl008(cfg: Config, sources: dict[str, SourceFile],
               project: Project) -> list[Finding]:
    pf = facts_mod.for_project(project)
    reachable = pf.thread_reachable()
    out: list[Finding] = []
    for rel in sorted(pf.modules):
        if not _in_modules(rel, cfg.gl008_modules):
            continue
        mf = pf.modules[rel]
        lock_list = ", ".join(sorted(mf.locks)) or None
        for m in mf.mutations:
            if m.locks_held:
                continue
            if f"{rel}:{m.func}" in reachable:
                out.append(Finding(
                    "GL008", rel, m.line,
                    f"module global {m.name!r} mutated ({m.how}) in "
                    f"{m.func}(), which runs off the main thread (reachable "
                    "from a Thread target / executor callback), without "
                    "holding a declared lock — guard it with a module "
                    "threading.Lock or waive with the lock-free argument"))
            elif lock_list is not None:
                out.append(Finding(
                    "GL008", rel, m.line,
                    f"module global {m.name!r} mutated ({m.how}) in "
                    f"{m.func}() outside any `with` on a declared lock "
                    f"({lock_list}) — a lock-declaring module keeps every "
                    "global mutation guarded, or waives the site with the "
                    "single-threaded argument"))
    return out


# -- GL009 -------------------------------------------------------------------


def rule_gl009(cfg: Config, sources: dict[str, SourceFile],
               project: Project) -> list[Finding]:
    pf = facts_mod.for_project(project)
    ladders, lad_rel, lad_line = pf.ladders()
    points, pts_rel, pts_line = pf.fault_points()
    rob_path = cfg.resolved_robustness_md()
    rob_rel = cfg.rel(rob_path)
    rob = _read_optional(rob_path)
    tests = _tests_corpus(cfg)
    out: list[Finding] = []

    deg_literal = {(s.engine, s.rung)
                   for s in pf.degradation_sites() if s.engine and s.rung}
    for engine, rungs in sorted(ladders.items()):
        # rungs[0] is the normal (non-degraded) path — reaching it never
        # goes through record_degradation, so only fallback rungs need a
        # call site
        for rung in rungs[1:]:
            if (engine, rung) not in deg_literal:
                out.append(Finding(
                    "GL009", lad_rel, lad_line,
                    f"LADDERS[{engine!r}] rung {rung!r} has no "
                    f"record_degradation({engine!r}, {rung!r}, ...) call "
                    "site in the scan set — an unreachable rung is dead "
                    "policy"))
        for name in dict.fromkeys((engine, *rungs)):
            if not _mentions(rob, name):
                out.append(Finding(
                    "GL009", lad_rel, lad_line,
                    f"ladder name {name!r} (engine {engine!r}) is missing "
                    f"from {rob_rel} — the degradation-ladder table is the "
                    "operator contract"))
    if ladders:
        for s in pf.degradation_sites():
            if s.engine is None or s.rung is None:
                continue  # dynamic args — validated at runtime by policy.py
            if s.engine not in ladders:
                out.append(Finding(
                    "GL009", s.rel, s.line,
                    f"record_degradation names unregistered engine "
                    f"{s.engine!r} — every engine degrades along a declared "
                    "LADDERS entry"))
            elif s.rung not in ladders[s.engine]:
                out.append(Finding(
                    "GL009", s.rel, s.line,
                    f"record_degradation names rung {s.rung!r} not in "
                    f"LADDERS[{s.engine!r}] {ladders[s.engine]!r}"))

    fired = {f.point for f in pf.fire_sites() if f.point}
    for point in sorted(points):
        if point not in fired:
            out.append(Finding(
                "GL009", pts_rel, pts_line,
                f"fault point {point!r} has no fire({point!r}) site in the "
                "scan set — an unfireable point cannot be chaos-tested"))
        if f":{point}:" not in tests:
            out.append(Finding(
                "GL009", pts_rel, pts_line,
                f"fault point {point!r} has no firing test in tests/ "
                f"(no 'kind:{point}:n' fault spec) — every recovery path "
                "is exercised in CI, not discovered in production"))
        if not _mentions(rob, point):
            out.append(Finding(
                "GL009", pts_rel, pts_line,
                f"fault point {point!r} is missing from {rob_rel}"))
    if points:
        for f in pf.fire_sites():
            if f.point is not None and f.point not in points:
                out.append(Finding(
                    "GL009", f.rel, f.line,
                    f"fire() names unregistered fault point {f.point!r} — "
                    "the FAULT_POINTS registry is closed"))
    return out


# -- GL010 -------------------------------------------------------------------


def rule_gl010(cfg: Config, sources: dict[str, SourceFile],
               project: Project) -> list[Finding]:
    pf = facts_mod.for_project(project)
    obs_path = cfg.resolved_observability_md()
    obs_rel = cfg.rel(obs_path)
    obs_doc = _read_optional(obs_path)
    consumers = _tests_corpus(cfg) + "\n" + "\n".join(
        _read_optional(cfg.root / rel) for rel in cfg.telemetry_consumers)
    out: list[Finding] = []

    emits = [m for m in pf.metric_emits()
             if _in_modules(m.rel, cfg.gl010_modules)]
    # first emission site per literal name (stable anchor for waivers)
    first: dict[tuple[str, str], facts_mod.MetricEmit] = {}
    kinds_by_name: dict[str, set[str]] = {}
    for m in sorted(emits, key=lambda m: (m.rel, m.line)):
        if m.name is None:
            continue
        first.setdefault((m.kind, m.name), m)
        if m.kind in ("counter", "gauge"):
            kinds_by_name.setdefault(m.name, set()).add(m.kind)

    for name, kinds in sorted(kinds_by_name.items()):
        if len(kinds) > 1:
            m = min((first[(k, name)] for k in kinds),
                    key=lambda m: (m.rel, m.line))
            out.append(Finding(
                "GL010", m.rel, m.line,
                f"metric name {name!r} is emitted as both "
                f"{' and '.join(sorted(kinds))} — names are unique across "
                "metric types"))

    for (kind, name), m in sorted(first.items()):
        if kind == "beat":
            continue  # heartbeat labels are phase tags, not ledger metrics
        if not _mentions(obs_doc, name):
            out.append(Finding(
                "GL010", m.rel, m.line,
                f"{kind} {name!r} is not documented in {obs_rel} — every "
                "emitted metric has an inventory row"))
        if not _mentions(consumers, name):
            out.append(Finding(
                "GL010", m.rel, m.line,
                f"{kind} {name!r} is emitted but never consumed by "
                "obs/report.py, obs/ledger.py or a test — dead telemetry "
                "drifts silently; consume it or waive with the reason it "
                "is operator-facing only"))

    seen_dynamic: set[tuple[str, str]] = set()
    for m in sorted(emits, key=lambda m: (m.rel, m.line)):
        if m.name is not None or m.kind == "beat":
            continue
        if not m.prefix:
            out.append(Finding(
                "GL010", m.rel, m.line,
                f"{m.kind} name at this site is not a string literal or "
                "prefixed f-string — the telemetry surface must be "
                "statically enumerable; use a literal family prefix or "
                "waive with the reason"))
            continue
        if (m.kind, m.prefix) in seen_dynamic:
            continue
        seen_dynamic.add((m.kind, m.prefix))
        if m.prefix not in obs_doc:
            out.append(Finding(
                "GL010", m.rel, m.line,
                f"dynamic {m.kind} family with prefix {m.prefix!r} is not "
                f"documented in {obs_rel} — document the "
                f"'{m.prefix}<...>' pattern"))

    ledger, led_rel, led_line = pf.ledger_metrics()
    bench_text = _read_optional(cfg.resolved_bench_py())
    for key, field in sorted(ledger.items()):
        if not _mentions(bench_text, field):
            out.append(Finding(
                "GL010", led_rel, led_line,
                f"ledger metric {key!r} reads record field {field!r} "
                f"but {cfg.resolved_bench_py().name} never produces it — a "
                "gate metric nothing feeds can never ratchet"))
    return out
