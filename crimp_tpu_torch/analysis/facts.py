"""graftlint facts layer: typed cross-file facts for the contract web.

Port of ``crimp_tpu/analysis/facts.py`` (locks, globals, thread spawns,
``LADDERS``/``FAULT_POINTS`` and emissions are plain Python in both
packages).

GL001–GL007 are (mostly) per-file properties. The v2 rules — GL008
concurrency discipline, GL009 resilience contract web, GL010 telemetry-
surface drift — need *whole-program* facts: who spawns threads, which
module globals are mutated under which locks, where `LADDERS` /
`FAULT_POINTS` literals live versus their `record_degradation()` /
`fire()` call sites, and which obs counter/gauge names are emitted
where. This module extracts those facts once per analysis run, from
plain ASTs only (same contract as the rest of graftlint: no imports of
checked modules, no torch).

Extraction is deliberately conservative, mirroring the call graph's
philosophy: a string argument that is not a literal (or an f-string /
two-armed conditional of literals) is recorded as *dynamic* — rules
validate what they can read and never guess at runtime values. An
unresolvable thread target adds no reachability edge, so it can hide a
violation but never invent one.
"""

from __future__ import annotations

import ast
import dataclasses

from crimp_tpu_torch.analysis.callgraph import (
    FunctionInfo,
    ModuleIndex,
    Project,
    call_tail,
    dotted,
    iter_body_nodes,
)

# module-level ``NAME = threading.X()`` declarations recognized as locks
LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

# method calls that mutate their receiver in place
MUTATING_METHODS = {
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "remove", "discard", "clear", "appendleft",
}


@dataclasses.dataclass(frozen=True)
class MetricEmit:
    """One obs ``counter_add`` / ``gauge_set`` / ``beat`` call site."""

    kind: str  # "counter" | "gauge" | "beat"
    name: str | None  # literal name/label; None when dynamic
    prefix: str | None  # static f-string prefix when dynamic
    rel: str
    line: int


@dataclasses.dataclass(frozen=True)
class DegradationSite:
    """One ``record_degradation(engine, rung, ...)`` call site; a non-
    literal engine/rung is recorded as None (dynamic, not validated)."""

    engine: str | None
    rung: str | None
    rel: str
    line: int


@dataclasses.dataclass(frozen=True)
class FireSite:
    """One ``fire(point)`` fault-injection call site."""

    point: str | None  # None = dynamic argument
    rel: str
    line: int


@dataclasses.dataclass(frozen=True)
class ThreadSpawn:
    """A ``threading.Thread(target=f)`` or ``<executor>.submit(f, ...)``
    site. ``target`` is the resolved callable when name resolution
    succeeds — the seed of GL008's off-main-thread reachability."""

    api: str  # "Thread" | "submit"
    rel: str
    line: int
    target: FunctionInfo | None


@dataclasses.dataclass(frozen=True)
class GlobalMutation:
    """A mutation of a module-level name inside a function body, with
    the set of declared locks held (via lexically enclosing ``with``)
    at the mutation site."""

    name: str
    how: str  # "assign" | "augassign" | "subscript" | "delete" | "method:<m>" | "attribute"
    func: str  # enclosing function qualname
    rel: str
    line: int
    locks_held: frozenset[str]


@dataclasses.dataclass
class ModuleFacts:
    rel: str
    locks: dict[str, int] = dataclasses.field(default_factory=dict)
    tls: set[str] = dataclasses.field(default_factory=set)
    module_globals: dict[str, int] = dataclasses.field(default_factory=dict)
    mutations: list[GlobalMutation] = dataclasses.field(default_factory=list)
    spawns: list[ThreadSpawn] = dataclasses.field(default_factory=list)
    degradations: list[DegradationSite] = dataclasses.field(default_factory=list)
    fires: list[FireSite] = dataclasses.field(default_factory=list)
    metrics: list[MetricEmit] = dataclasses.field(default_factory=list)
    # LADDERS = {"engine": ("rung0", ...)} literal, when this module has one
    ladders: dict[str, tuple[str, ...]] | None = None
    ladders_line: int = 0
    # FAULT_POINTS = frozenset({...}) literal
    fault_points: frozenset[str] | None = None
    fault_points_line: int = 0
    # METRICS = {"metric": {"field": ...}} ledger literal: name -> field tail
    ledger_metrics: dict[str, str] | None = None
    ledger_metrics_line: int = 0


def _root_name(node: ast.AST) -> str | None:
    """The root Name of an attribute/subscript chain: ``_RUN.counters[k]``
    -> ``_RUN``. Mutating through any such chain mutates the root
    module global."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _str_args(node: ast.AST) -> list[str]:
    """Constant-string elements of a tuple/list/set/frozenset(...) literal."""
    if isinstance(node, ast.Call) and call_tail(node.func) in ("frozenset", "set", "tuple"):
        if not node.args:
            return []
        node = node.args[0]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for el in node.elts:
            s = _const_str(el)
            if s is not None:
                out.append(s)
        return out
    return []


def _joined_prefix(node: ast.JoinedStr) -> str:
    """Leading constant text of an f-string — the static family prefix of
    a dynamic metric name like f"degraded_{engine}_{rung}"."""
    prefix = ""
    for part in node.values:
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            prefix += part.value
        else:
            break
    return prefix


def _metric_name_args(node: ast.AST) -> list[tuple[str | None, str | None]]:
    """(literal name, dynamic prefix) alternatives for one metric-name
    argument. A two-armed conditional of literals yields both arms."""
    s = _const_str(node)
    if s is not None:
        return [(s, None)]
    if isinstance(node, ast.JoinedStr):
        return [(None, _joined_prefix(node))]
    if isinstance(node, ast.IfExp):
        return _metric_name_args(node.body) + _metric_name_args(node.orelse)
    return [(None, None)]


def _module_level_names(tree: ast.Module) -> dict[str, int]:
    """Names bound by top-level Assign/AnnAssign — the module globals
    whose mutation GL008 polices."""
    out: dict[str, int] = {}
    for stmt in tree.body:
        targets: list[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name):
                out.setdefault(t.id, stmt.lineno)
            elif isinstance(t, ast.Tuple):
                for el in t.elts:
                    if isinstance(el, ast.Name):
                        out.setdefault(el.id, stmt.lineno)
    return out


def _bound_names(target: ast.AST):
    """Names BOUND by an assignment/for/with-as target. A Subscript or
    Attribute target mutates an existing object — it binds nothing, so
    it must not shadow a module global here."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for el in target.elts:
            yield from _bound_names(el)
    elif isinstance(target, ast.Starred):
        yield from _bound_names(target.value)


def _local_bindings(fn_node: ast.AST) -> set[str]:
    """Names bound locally in a function body (params, assignments, for
    targets, with-as, conservative set). A module global shadowed by a
    local binding is not a global mutation."""
    out: set[str] = set()
    if not isinstance(fn_node, ast.Lambda):
        a = fn_node.args
        for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
            out.add(arg.arg)
        if a.vararg:
            out.add(a.vararg.arg)
        if a.kwarg:
            out.add(a.kwarg.arg)
    for node in iter_body_nodes(fn_node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                out.update(_bound_names(t))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            out.update(_bound_names(node.target))
        elif isinstance(node, ast.For):
            out.update(_bound_names(node.target))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    out.update(_bound_names(item.optional_vars))
        elif isinstance(node, ast.ExceptHandler) and node.name:
            out.add(node.name)
    return out


class _ModuleExtractor:
    """One pass over a module: locks, globals, mutations-with-held-locks,
    thread spawns, resilience/telemetry call sites, registry literals."""

    def __init__(self, project: Project, mod: ModuleIndex):
        self.project = project
        self.mod = mod
        self.facts = ModuleFacts(rel=mod.rel)
        self._extract_module_level()
        self._extract_calls()
        for info in list(mod.functions.values()):
            if isinstance(info.node, ast.Lambda):
                continue
            self._extract_mutations(info)

    # -- module level --------------------------------------------------------

    def _extract_module_level(self) -> None:
        f = self.facts
        f.module_globals = _module_level_names(self.mod.tree)
        for stmt in self.mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target, value = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                target, value = stmt.target, stmt.value  # METRICS: dict[str, dict] = {...}
            else:
                continue
            if not isinstance(target, ast.Name):
                continue
            name = target.id
            if isinstance(value, ast.Call):
                tail = call_tail(value.func)
                if tail in LOCK_FACTORIES:
                    f.locks[name] = stmt.lineno
                elif tail == "local" and (dotted(value.func) or "").startswith("threading"):
                    f.tls.add(name)
            if name == "LADDERS" and isinstance(value, ast.Dict):
                ladders: dict[str, tuple[str, ...]] = {}
                for k, v in zip(value.keys, value.values):
                    ks = _const_str(k) if k is not None else None
                    if ks is not None:
                        ladders[ks] = tuple(_str_args(v))
                if ladders:
                    f.ladders, f.ladders_line = ladders, stmt.lineno
            elif name == "FAULT_POINTS":
                points = _str_args(value)
                if points:
                    f.fault_points = frozenset(points)
                    f.fault_points_line = stmt.lineno
            elif name == "METRICS" and isinstance(value, ast.Dict):
                metrics: dict[str, str] = {}
                for k, v in zip(value.keys, value.values):
                    ks = _const_str(k) if k is not None else None
                    if ks is None or not isinstance(v, ast.Dict):
                        continue
                    field = ""
                    for fk, fv in zip(v.keys, v.values):
                        if fk is not None and _const_str(fk) == "field":
                            parts = _str_args(fv)
                            field = parts[-1] if parts else (_const_str(fv) or "")
                    if field:
                        metrics[ks] = field
                if metrics:
                    f.ledger_metrics = metrics
                    f.ledger_metrics_line = stmt.lineno

    # -- call sites (any scope) ----------------------------------------------

    def _extract_calls(self) -> None:
        extractor = self
        mod, facts = self.mod, self.facts
        scope_stack: list[str] = []

        class V(ast.NodeVisitor):
            def _scoped(self, node):
                scope_stack.append(getattr(node, "name", f"<lambda@{node.lineno}>"))
                self.generic_visit(node)
                scope_stack.pop()

            visit_FunctionDef = _scoped
            visit_AsyncFunctionDef = _scoped
            visit_ClassDef = _scoped

            def visit_Call(self, node: ast.Call):
                extractor._one_call(node, ".".join(scope_stack) or None)
                self.generic_visit(node)

        V().visit(mod.tree)

    def _one_call(self, node: ast.Call, scope: str | None) -> None:
        facts, mod = self.facts, self.mod
        tail = call_tail(node.func)
        if tail in ("counter_add", "gauge_set") and node.args:
            kind = "counter" if tail == "counter_add" else "gauge"
            for name, prefix in _metric_name_args(node.args[0]):
                facts.metrics.append(MetricEmit(
                    kind=kind, name=name, prefix=prefix,
                    rel=mod.rel, line=node.lineno))
        elif tail == "beat":
            label = None
            for kw in node.keywords:
                if kw.arg == "label":
                    label = kw.value
            if label is not None:
                for name, prefix in _metric_name_args(label):
                    facts.metrics.append(MetricEmit(
                        kind="beat", name=name, prefix=prefix,
                        rel=mod.rel, line=node.lineno))
        elif tail == "record_degradation" and node.args:
            engine = _const_str(node.args[0])
            rung = _const_str(node.args[1]) if len(node.args) > 1 else None
            facts.degradations.append(DegradationSite(
                engine=engine, rung=rung, rel=mod.rel, line=node.lineno))
        elif tail == "fire" and node.args:
            facts.fires.append(FireSite(
                point=_const_str(node.args[0]), rel=mod.rel, line=node.lineno))
        elif tail == "Thread":
            path = dotted(node.func) or tail
            if path in ("Thread", "threading.Thread"):
                target = None
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = self.project.resolve_callable(mod, scope, kw.value)
                facts.spawns.append(ThreadSpawn(
                    api="Thread", rel=mod.rel, line=node.lineno, target=target))
        elif tail == "submit" and isinstance(node.func, ast.Attribute) and node.args:
            target = self.project.resolve_callable(mod, scope, node.args[0])
            facts.spawns.append(ThreadSpawn(
                api="submit", rel=mod.rel, line=node.lineno, target=target))

    # -- mutations with held locks -------------------------------------------

    def _lock_names_in_with(self, node: ast.With | ast.AsyncWith) -> set[str]:
        """Declared-lock names acquired by a with statement. A bare Name
        must be one of this module's locks; ``mod._LOCK`` resolves through
        the import alias to a lock declared in another scanned module."""
        held: set[str] = set()
        for item in node.items:
            expr = item.context_expr
            # ``with lock:`` and ``with lock.acquire_timeout():`` style
            if isinstance(expr, ast.Call):
                expr = expr.func if not isinstance(expr.func, ast.Attribute) \
                    else expr.func.value
            if isinstance(expr, ast.Name) and expr.id in self.facts.locks:
                held.add(expr.id)
            elif isinstance(expr, ast.Attribute):
                path = dotted(expr)
                if path is None:
                    continue
                head, _, rest = path.partition(".")
                target = self.mod.module_aliases.get(head)
                if target is not None and "." not in rest:
                    tmod = self.project.by_dotted.get(target)
                    if tmod is not None:
                        tfacts = _module_locks(tmod)
                        if rest in tfacts:
                            held.add(f"{target}.{rest}")
        return held

    def _extract_mutations(self, info: FunctionInfo) -> None:
        fn_node = info.node
        globals_declared: set[str] = set()
        for n in iter_body_nodes(fn_node):
            if isinstance(n, ast.Global):
                globals_declared.update(n.names)
        local = _local_bindings(fn_node) - globals_declared
        mod_globals = set(self.facts.module_globals) | globals_declared
        tls = self.facts.tls

        def is_global(name: str) -> bool:
            return name in mod_globals and name not in local and name not in tls

        def record(name: str, how: str, line: int, held: frozenset[str]) -> None:
            self.facts.mutations.append(GlobalMutation(
                name=name, how=how, func=info.qualname, rel=self.mod.rel,
                line=line, locks_held=held))

        def check(node: ast.AST, held: frozenset[str]) -> None:
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name) and t.id in globals_declared \
                            and t.id not in tls:
                        record(t.id, "assign", node.lineno, held)
                    elif isinstance(t, (ast.Subscript, ast.Attribute)):
                        root = _root_name(t)
                        how = "subscript" if isinstance(t, ast.Subscript) else "attribute"
                        if root is not None and is_global(root):
                            record(root, how, node.lineno, held)
            elif isinstance(node, ast.AugAssign):
                t = node.target
                if isinstance(t, ast.Name) and t.id in globals_declared and t.id not in tls:
                    record(t.id, "augassign", node.lineno, held)
                elif isinstance(t, (ast.Subscript, ast.Attribute)):
                    root = _root_name(t)
                    if root is not None and is_global(root):
                        record(root, "subscript", node.lineno, held)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        root = _root_name(t)
                        if root is not None and is_global(root):
                            record(root, "delete", node.lineno, held)
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                root = _root_name(node.func.value)
                if root is not None and node.func.attr in MUTATING_METHODS \
                        and is_global(root):
                    record(root, f"method:{node.func.attr}", node.lineno, held)

        def walk(node: ast.AST, held: frozenset[str]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return  # nested defs are their own FunctionInfos
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = held | self._lock_names_in_with(node)
                for item in node.items:
                    walk(item.context_expr, held)
                for b in node.body:
                    walk(b, inner)
                return
            check(node, held)
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        roots = [fn_node.body] if isinstance(fn_node, ast.Lambda) else fn_node.body
        for stmt in (roots if isinstance(roots, list) else [roots]):
            walk(stmt, frozenset())


_LOCKS_CACHE_ATTR = "_graftlint_locks"


def _module_locks(mod: ModuleIndex) -> dict[str, int]:
    """Module-level lock declarations of one module (cached on the index
    — cross-module ``with other._LOCK:`` resolution needs it before that
    module's own facts exist)."""
    cached = getattr(mod, _LOCKS_CACHE_ATTR, None)
    if cached is None:
        cached = {}
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and isinstance(stmt.value, ast.Call) \
                    and call_tail(stmt.value.func) in LOCK_FACTORIES:
                cached[stmt.targets[0].id] = stmt.lineno
        setattr(mod, _LOCKS_CACHE_ATTR, cached)
    return cached


class ProjectFacts:
    """Facts for every scanned python module + cross-module closures."""

    def __init__(self, project: Project):
        self.project = project
        self.modules: dict[str, ModuleFacts] = {}
        for rel, mod in project.modules.items():
            self.modules[rel] = _ModuleExtractor(project, mod).facts
        self._thread_closure: set[str] | None = None

    # -- aggregates ----------------------------------------------------------

    def ladders(self) -> tuple[dict[str, tuple[str, ...]], str, int]:
        """Merged LADDERS literals: (engine -> rungs, defining rel, line).
        Empty dict when no scanned module declares one."""
        merged: dict[str, tuple[str, ...]] = {}
        rel, line = "", 0
        for f in self.modules.values():
            if f.ladders:
                merged.update(f.ladders)
                rel, line = f.rel, f.ladders_line
        return merged, rel, line

    def fault_points(self) -> tuple[frozenset[str], str, int]:
        points: set[str] = set()
        rel, line = "", 0
        for f in self.modules.values():
            if f.fault_points:
                points |= f.fault_points
                rel, line = f.rel, f.fault_points_line
        return frozenset(points), rel, line

    def ledger_metrics(self) -> tuple[dict[str, str], str, int]:
        merged: dict[str, str] = {}
        rel, line = "", 0
        for f in self.modules.values():
            if f.ledger_metrics:
                merged.update(f.ledger_metrics)
                rel, line = f.rel, f.ledger_metrics_line
        return merged, rel, line

    def degradation_sites(self) -> list[DegradationSite]:
        return [s for f in self.modules.values() for s in f.degradations]

    def fire_sites(self) -> list[FireSite]:
        return [s for f in self.modules.values() for s in f.fires]

    def metric_emits(self) -> list[MetricEmit]:
        return [m for f in self.modules.values() for m in f.metrics]

    # -- thread reachability -------------------------------------------------

    def thread_reachable(self) -> set[str]:
        """Labels (``module:qualname``) of every function reachable from a
        resolved thread target / executor callback — code that runs off
        the main thread. BFS over the same conservative call graph GL001
        uses: an unresolved edge can hide reachability, never invent it."""
        if self._thread_closure is not None:
            return self._thread_closure
        seeds: list[FunctionInfo] = []
        for f in self.modules.values():
            for spawn in f.spawns:
                if spawn.target is not None:
                    seeds.append(spawn.target)
        seen: set[str] = set()
        queue = list(seeds)
        while queue:
            cur = queue.pop()
            if cur.label in seen:
                continue
            seen.add(cur.label)
            for callee in self.project._callees(cur):
                if callee.label not in seen:
                    queue.append(callee)
        self._thread_closure = seen
        return seen

    def spawn_origin(self, label: str) -> str:
        """Human-readable seed description for a thread-reachable label
        (best-effort; used only in finding messages)."""
        for f in self.modules.values():
            for spawn in f.spawns:
                if spawn.target is not None and spawn.target.label == label:
                    return f"{spawn.api} at {f.rel}"
        return "thread callback"


_FACTS_CACHE_ATTR = "_graftlint_facts"


def for_project(project: Project) -> ProjectFacts:
    """The (cached) facts for one Project — GL008/GL009/GL010 share one
    extraction pass."""
    cached = getattr(project, _FACTS_CACHE_ATTR, None)
    if cached is None:
        cached = ProjectFacts(project)
        setattr(project, _FACTS_CACHE_ATTR, cached)
    return cached
