"""graftlint call graph: which functions run under CUDA-graph capture?

Port of ``crimp_tpu/analysis/callgraph.py``, retargeted from JAX traces to
CUDA-graph capture. Builds a project-wide, name-resolved call graph from
plain ASTs and computes the set of functions reachable from *capture entry
points*, the code whose device work a CUDA graph records and replays
without running its host side again:

- the body of a ``with torch.cuda.graph(...)`` block (the body itself,
  and every callable called lexically inside it);
- callables handed to ``torch.cuda.make_graphed_callables`` or
  ``torch.compile`` (as decorators, ``partial`` decorators, or call-site
  wrappers).

In the port the one capture today is ``ops/mcmc.py::_run_graphed``: its
``with torch.cuda.graph(graph)`` body calls ``_run_steps``, which calls
``_half_update``. Their log-probability ``lp_fn`` is a parameter (the
caller's function), so it adds no edge: a host sync inside a
log-probability is out of the graph's sight, and the MCMC tests on the
card catch it at capture instead. Replaying the ToA fit's fixed-length
stages from captured graphs will add entry points.

Resolution is deliberately name-based and conservative:

- ``Name`` callees resolve through the lexical scope chain (nested defs,
  enclosing class, module level), then ``from x import y`` aliases;
- ``mod.f`` attribute callees resolve when ``mod`` is an import alias of
  a module inside the scan set;
- ``self.m`` resolves to methods of the lexically enclosing class.

Anything unresolvable (external libraries, dynamic dispatch) simply adds
no edge — the rules that consume the graph (GL001/GL002) look at call
*sites* inside captured bodies for the banned host operations, so an
unresolved edge can hide a transitive violation but never invent one.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib

# wrapper name -> positions of the captured callable argument(s).
# ``make_graphed_callables`` is unambiguous; AMBIGUOUS_TAILS (``compile``:
# ``re.compile`` is not a capture) additionally require a torch qualifier
# (``torch.compile``) or a recorded ``from torch import compile``.
TRACE_WRAPPERS: dict[str, tuple[int, ...]] = {
    "make_graphed_callables": (0,),
    "compile": (0,),
}
AMBIGUOUS_TAILS = {"compile"}
# ``with torch.cuda.graph(g):`` (or ``cuda.graph``, or ``graph`` imported
# from torch.cuda) opens a capture body
CAPTURE_CONTEXT = "graph"

# Parameter annotations / default types treated as static configuration
# (never tensors) by the GL002 heuristics.
STATIC_ANNOTATIONS = {"int", "bool", "str", "float"}


def dotted(node: ast.AST) -> str | None:
    """'a.b.c' for nested Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_tail(func: ast.AST) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


@dataclasses.dataclass
class FunctionInfo:
    module: str  # root-relative posix path
    qualname: str  # e.g. "Class.method" / "outer.<locals>.inner" / "f.<capture@12>"
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda | With (a capture body)
    name: str
    lineno: int
    params: tuple[str, ...]
    static_params: frozenset[str]  # annotation/default-typed config params
    class_name: str | None = None
    entry_reason: str | None = None  # set when this is a capture entry point
    traced_via: str | None = None  # entry (or caller) that makes it captured

    @property
    def label(self) -> str:
        return f"{self.module}:{self.qualname}"

    @property
    def scope(self) -> str | None:
        """The lexical scope names in this body resolve against (None for
        a lambda or a module-level capture body)."""
        return None if self.qualname.startswith(("<lambda", "<capture")) else self.qualname


def _param_info(node: ast.AST) -> tuple[tuple[str, ...], frozenset[str]]:
    """(param names, statically-typed param names) for a def/lambda."""
    a = node.args
    args = [*a.posonlyargs, *a.args, *a.kwonlyargs]
    names = tuple(arg.arg for arg in args)
    static: set[str] = set(arg.arg for arg in a.kwonlyargs)
    for arg in args:
        ann = arg.annotation
        if ann is not None:
            text = dotted(ann) or (ann.value if isinstance(ann, ast.Constant)
                                   and isinstance(ann.value, str) else "")
            base = str(text).split("|")[0].strip().split(".")[-1]
            if base in STATIC_ANNOTATIONS:
                static.add(arg.arg)
    defaults = list(a.defaults)
    if defaults and not isinstance(node, ast.Lambda):
        for arg, dflt in zip(args[len(args) - len(a.kwonlyargs) - len(defaults):],
                             defaults):
            if isinstance(dflt, ast.Constant) and isinstance(
                    dflt.value, (bool, int, str, type(None))):
                static.add(arg.arg)
    for arg, dflt in zip(a.kwonlyargs, a.kw_defaults):
        if isinstance(dflt, ast.Constant):
            static.add(arg.arg)
    return names, frozenset(static)


class ModuleIndex:
    def __init__(self, rel: str, tree: ast.Module):
        self.rel = rel
        self.tree = tree
        self.functions: dict[str, FunctionInfo] = {}
        # import alias -> dotted module name ("search" -> "crimp_tpu_torch.ops.search")
        self.module_aliases: dict[str, str] = {}
        # from-import: local name -> (dotted module, original name)
        self.from_imports: dict[str, tuple[str, str]] = {}
        self._index()

    def _index(self) -> None:
        mod = self

        class V(ast.NodeVisitor):
            def __init__(self) -> None:
                self.stack: list[tuple[str, str]] = []  # (kind, name)

            def _qual(self, name: str) -> str:
                parts = [n for _, n in self.stack] + [name]
                return ".".join(parts)

            def visit_Import(self, node: ast.Import) -> None:
                for alias in node.names:
                    mod.module_aliases[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0])

            def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
                if node.module is None or node.level:
                    return
                for alias in node.names:
                    mod.from_imports[alias.asname or alias.name] = (
                        node.module, alias.name)
                    # ``from crimp_tpu_torch.parallel import mesh`` binds a module
                    mod.module_aliases.setdefault(
                        alias.asname or alias.name,
                        f"{node.module}.{alias.name}")

            def _def(self, node) -> None:
                params, static = _param_info(node)
                cls = self.stack[-1][1] if self.stack and self.stack[-1][0] == "class" else None
                qual = self._qual(node.name)
                mod.functions[qual] = FunctionInfo(
                    module=mod.rel, qualname=qual, node=node, name=node.name,
                    lineno=node.lineno, params=params, static_params=static,
                    class_name=cls)
                self.stack.append(("func", node.name))
                self.generic_visit(node)
                self.stack.pop()

            visit_FunctionDef = _def
            visit_AsyncFunctionDef = _def

            def visit_ClassDef(self, node: ast.ClassDef) -> None:
                self.stack.append(("class", node.name))
                self.generic_visit(node)
                self.stack.pop()

        V().visit(self.tree)

    def lambda_info(self, node: ast.Lambda) -> FunctionInfo:
        qual = f"<lambda@{node.lineno}>"
        if qual not in self.functions:
            params, static = _param_info(node)
            self.functions[qual] = FunctionInfo(
                module=self.rel, qualname=qual, node=node, name=qual,
                lineno=node.lineno, params=params, static_params=static)
        return self.functions[qual]


def _module_dotted_name(rel: str) -> str:
    p = pathlib.PurePosixPath(rel)
    parts = list(p.with_suffix("").parts)
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class Project:
    """All scanned modules + the traced-reachability closure."""

    def __init__(self, sources: dict[str, ast.Module]):
        self.modules: dict[str, ModuleIndex] = {
            rel: ModuleIndex(rel, tree) for rel, tree in sources.items()}
        self.by_dotted: dict[str, ModuleIndex] = {
            _module_dotted_name(rel): m for rel, m in self.modules.items()}
        self._traced: dict[str, FunctionInfo] | None = None

    # -- name resolution ----------------------------------------------------

    def _resolve_in_module(self, mod: ModuleIndex, scope: str | None,
                           name: str) -> FunctionInfo | None:
        # lexical chain: nested defs of the scope, enclosing scopes, module
        prefixes: list[str] = []
        if scope:
            parts = scope.split(".")
            prefixes = [".".join(parts[:i]) for i in range(len(parts), 0, -1)]
        for prefix in prefixes:
            hit = mod.functions.get(f"{prefix}.{name}")
            if hit is not None:
                return hit
        hit = mod.functions.get(name)
        if hit is not None:
            return hit
        imp = mod.from_imports.get(name)
        if imp is not None:
            target_mod = self.by_dotted.get(imp[0])
            if target_mod is not None:
                return target_mod.functions.get(imp[1])
        return None

    def resolve_callable(self, mod: ModuleIndex, scope: str | None,
                         node: ast.AST) -> FunctionInfo | None:
        """Resolve a callable-valued expression to a scanned function."""
        # partial(f, ...) and functools.partial(f, ...): unwrap
        if isinstance(node, ast.Call) and call_tail(node.func) == "partial" and node.args:
            return self.resolve_callable(mod, scope, node.args[0])
        if isinstance(node, ast.Lambda):
            return mod.lambda_info(node)
        if isinstance(node, ast.Name):
            return self._resolve_in_module(mod, scope, node.id)
        if isinstance(node, ast.Attribute):
            path = dotted(node)
            if path is None:
                return None
            head, _, rest = path.partition(".")
            if head == "self" and scope:
                # method on the lexically enclosing class
                cls_prefix = scope.split(".")[0]
                return mod.functions.get(f"{cls_prefix}.{rest}")
            target = mod.module_aliases.get(head)
            if target is not None:
                target_mod = self.by_dotted.get(target)
                if target_mod is None and "." in path:
                    # ``import crimp_tpu_torch.ops.search as s`` style full path
                    target_mod = self.by_dotted.get(
                        ".".join([target] + rest.split(".")[:-1]))
                    rest = rest.split(".")[-1]
                if target_mod is not None:
                    return target_mod.functions.get(rest)
        return None

    # -- capture entries ----------------------------------------------------

    def _wrapper_name(self, mod: ModuleIndex, func: ast.AST) -> str | None:
        """The TRACE_WRAPPERS tail when ``func`` names a capture wrapper."""
        tail = call_tail(func)
        if tail not in TRACE_WRAPPERS:
            return None
        if tail in AMBIGUOUS_TAILS:
            parts = (dotted(func) or "").split(".")
            qualified = len(parts) > 1 and parts[-2] == "torch"
            imported = mod.from_imports.get(tail, ("", ""))[0] == "torch"
            if not (qualified or imported):
                return None
        return tail

    def _is_capture_context(self, mod: ModuleIndex, expr: ast.AST) -> bool:
        """Whether a with-item opens a CUDA-graph capture."""
        if not isinstance(expr, ast.Call):
            return False
        path = dotted(expr.func) or ""
        if path.endswith("cuda." + CAPTURE_CONTEXT):
            return True
        return (path == CAPTURE_CONTEXT and mod.from_imports.get(
            CAPTURE_CONTEXT, ("", ""))[0] == "torch.cuda")

    def _capture_body(self, mod: ModuleIndex, node: ast.With,
                      enclosing: FunctionInfo | None, scope: str | None) -> FunctionInfo:
        """The body of a capture ``with`` as a function of its own, with
        the enclosing function's parameters (a sync on one of them inside
        the body breaks the capture as it would in a callee)."""
        qual = f"{scope}.<capture@{node.lineno}>" if scope else f"<capture@{node.lineno}>"
        return FunctionInfo(
            module=mod.rel, qualname=qual, node=node, name=f"<capture@{node.lineno}>",
            lineno=node.lineno,
            params=enclosing.params if enclosing is not None else (),
            static_params=enclosing.static_params if enclosing is not None else frozenset(),
            class_name=enclosing.class_name if enclosing is not None else None)

    def _entry_points(self) -> list[tuple[FunctionInfo, str]]:
        entries: list[tuple[FunctionInfo, str]] = []
        for mod in self.modules.values():
            # decorator-based entries
            for info in list(mod.functions.values()):
                node = info.node
                if isinstance(node, ast.Lambda):
                    continue
                for dec in node.decorator_list:
                    reason = self._decorator_entry(mod, dec, info)
                    if reason:
                        entries.append((info, reason))
                        break
            # call-site entries: make_graphed_callables(f), torch.compile(f),
            # and the capture bodies of ``with torch.cuda.graph(...)``
            scope_stack: list[str] = []
            project = self

            class W(ast.NodeVisitor):
                def _scoped(self, node):
                    scope_stack.append(node.name if hasattr(node, "name")
                                       else f"<lambda@{node.lineno}>")
                    self.generic_visit(node)
                    scope_stack.pop()

                visit_FunctionDef = _scoped
                visit_AsyncFunctionDef = _scoped

                def visit_ClassDef(self, node):
                    self._scoped(node)

                def visit_With(self, node: ast.With):
                    if any(project._is_capture_context(mod, item.context_expr)
                           for item in node.items):
                        scope = ".".join(scope_stack) or None
                        where = f"{mod.rel}:{node.lineno}"
                        body = project._capture_body(
                            mod, node, mod.functions.get(scope or ""), scope)
                        entries.append((body, f"torch.cuda.graph() capture body at {where}"))
                        for sub in iter_body_nodes(node):
                            if not isinstance(sub, ast.Call):
                                continue
                            info = project.resolve_callable(mod, scope, sub.func)
                            if info is not None:
                                entries.append((
                                    info, f"called inside torch.cuda.graph() at {where}"))
                    self.generic_visit(node)

                def visit_Call(self, node: ast.Call):
                    tail = project._wrapper_name(mod, node.func)
                    if tail is not None:
                        scope = ".".join(scope_stack) or None
                        for pos in TRACE_WRAPPERS[tail]:
                            if pos >= len(node.args):
                                continue
                            arg = node.args[pos]
                            cands = (arg.elts if isinstance(
                                arg, (ast.List, ast.Tuple)) else [arg])
                            for cand in cands:
                                info = project.resolve_callable(mod, scope, cand)
                                if info is not None:
                                    entries.append((
                                        info, f"passed to {tail}() at "
                                              f"{mod.rel}:{node.lineno}"))
                    self.generic_visit(node)

            W().visit(mod.tree)
        return entries

    def _decorator_entry(self, mod: ModuleIndex, dec: ast.AST,
                         info: FunctionInfo) -> str | None:
        tail = self._wrapper_name(mod, dec)
        if tail is not None:
            return f"@{tail}"
        if isinstance(dec, ast.Call):
            ctail = self._wrapper_name(mod, dec.func)
            if ctail is not None:
                return f"@{ctail}(...)"
            if call_tail(dec.func) == "partial" and dec.args:
                inner = self._wrapper_name(mod, dec.args[0])
                if inner is not None:
                    return f"@partial({inner}, ...)"
        return None

    # -- reachability --------------------------------------------------------

    def _callees(self, info: FunctionInfo) -> list[FunctionInfo]:
        mod = self.modules[info.module]
        scope = info.scope
        out: list[FunctionInfo] = []
        for node in iter_body_nodes(info.node):
            if isinstance(node, ast.Call):
                target = self.resolve_callable(mod, scope, node.func)
                if target is not None:
                    out.append(target)
                # callables passed onward (e.g. to torch.compile) also captured
                tail = self._wrapper_name(mod, node.func)
                if tail is not None:
                    for pos in TRACE_WRAPPERS[tail]:
                        if pos < len(node.args):
                            t = self.resolve_callable(mod, scope, node.args[pos])
                            if t is not None:
                                out.append(t)
        return out

    def traced_functions(self) -> dict[str, FunctionInfo]:
        """label -> FunctionInfo for every function reachable from a
        capture entry point (the entry points included)."""
        if self._traced is not None:
            return self._traced
        traced: dict[str, FunctionInfo] = {}
        queue: list[FunctionInfo] = []
        for info, reason in self._entry_points():
            if info.label not in traced:
                info.entry_reason = reason
                info.traced_via = f"entry: {reason}"
                traced[info.label] = info
                queue.append(info)
        while queue:
            cur = queue.pop()
            for callee in self._callees(cur):
                if callee.label not in traced:
                    callee.traced_via = f"called from {cur.label}"
                    traced[callee.label] = callee
                    queue.append(callee)
        self._traced = traced
        return traced


def iter_body_nodes(func_node: ast.AST):
    """Walk a function (or capture) body WITHOUT descending into nested
    function / lambda definitions (those are separate FunctionInfos — a
    nested def only matters if it is itself capture-reachable)."""
    if isinstance(func_node, ast.Lambda):
        roots = [func_node.body]
    else:
        roots = list(func_node.body)
    stack = list(roots)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)
