"""graftlint GL003: knob-registry consistency.

Port of ``crimp_tpu/analysis/knobcheck.py`` under the port's prefix. The
invariant web, enforced in all four directions:

1. every env read of a ``CRIMP_TORCH_*`` name in the scan set (Python AST:
   ``os.environ[...]`` / ``os.environ.get`` / ``os.getenv``; shell: any
   ``$CRIMP_TORCH_*`` / ``${CRIMP_TORCH_*...}`` expansion), and every
   ``os.environ[...]`` write or delete (a script arming a knob), names a
   knob declared in ``crimp_tpu_torch.knobs.REGISTRY``;
2. Python reads of CRIMP_TORCH names happen ONLY inside
   crimp_tpu_torch/knobs.py (everything else goes through the registry
   accessors);
3. every registered knob has a ``CRIMP_TORCH_*`` row in
   crimp_tpu_torch/docs/tools.md;
4. every registered knob with a ``numeric_key`` has that key pinned in
   the ``_numeric_mode`` fingerprint dict of ops/resumable.py — numeric
   modes that are not fingerprinted can silently mix chunks computed
   under different kernels into one resumable store.

Checks 3 and 4 read the doc/fingerprint files directly (they may sit
outside the scanned paths), so deleting a tools.md row or a fingerprint
key fails the gate even when only ``crimp_tpu_torch/`` is scanned.
"""

from __future__ import annotations

import ast
import re

from crimp_tpu_torch.analysis.callgraph import dotted
from crimp_tpu_torch.analysis.core import Config, Finding, SourceFile

PREFIX = "CRIMP_TORCH_"
ENV_NAME_RE = re.compile(r"CRIMP_TORCH_[A-Z0-9_]+")
# shell expansions only — a mention in a comment or log string is not a read
SHELL_READ_RE = re.compile(r"\$\{?(CRIMP_TORCH_[A-Z0-9_]+)")


def _env_access(node: ast.AST) -> tuple[str, int, bool] | None:
    """(env var name, lineno, is_read) when this AST node reads, sets or
    deletes an environment variable with a literal name. A script that sets
    a knob for the code it runs (``os.environ[X] = ...``, ``del``) reads
    nothing past the registry, but the name must still be registered."""
    key, read = None, True
    if isinstance(node, ast.Subscript):  # os.environ["X"]
        if dotted(node.value) == "os.environ":
            key, read = node.slice, isinstance(node.ctx, ast.Load)
    elif isinstance(node, ast.Call):
        path = dotted(node.func)
        if path in ("os.environ.get", "os.getenv") and node.args:
            key = node.args[0]
    if (key is not None and isinstance(key, ast.Constant)
            and isinstance(key.value, str)):
        return key.value, node.lineno, read
    return None


def rule_gl003(cfg: Config, sources: dict[str, SourceFile],
               project) -> list[Finding]:
    registry = cfg.resolved_registry()
    out: list[Finding] = []

    # 1 + 2: env reads in the scan set
    for rel, src in sources.items():
        if src.is_python and src.tree is not None:
            for node in ast.walk(src.tree):
                hit = _env_access(node)
                if hit is None or not hit[0].startswith(PREFIX):
                    continue
                name, line, read = hit
                if name not in registry:
                    out.append(Finding(
                        "GL003", rel, line,
                        f"env {'read' if read else 'write'} of unregistered knob {name} — declare it "
                        "in crimp_tpu_torch/knobs.py REGISTRY "
                        "(crimp_tpu_torch/docs/analysis.md)"))
                elif read and rel != cfg.knobs_rel and not rel.endswith("/" + cfg.knobs_rel):
                    out.append(Finding(
                        "GL003", rel, line,
                        f"direct os.environ read of {name} outside "
                        f"{cfg.knobs_rel} — use the crimp_tpu_torch.knobs accessors "
                        "so parsing and registration stay uniform"))
        elif rel.endswith(".sh"):
            for i, text in enumerate(src.text.splitlines(), start=1):
                code = text.split("#", 1)[0]
                for m in SHELL_READ_RE.finditer(code):
                    if m.group(1) not in registry:
                        out.append(Finding(
                            "GL003", rel, i,
                            f"shell read of unregistered knob {m.group(1)} — "
                            "declare it in crimp_tpu_torch/knobs.py REGISTRY"))

    # 3: tools.md coverage
    tools_md = cfg.resolved_tools_md()
    tools_rel = cfg.rel(tools_md)
    try:
        documented = set(ENV_NAME_RE.findall(tools_md.read_text()))
    except OSError:
        documented = None
        out.append(Finding("GL003", tools_rel, 1,
                           f"cannot read {tools_md} to check knob docs"))
    if documented is not None:
        for name in sorted(registry):
            if name not in documented:
                out.append(Finding(
                    "GL003", tools_rel, 1,
                    f"registered knob {name} has no row in the {tools_rel} "
                    "environment-variable table"))

    # 4: numeric_mode fingerprint coverage
    resumable = cfg.resolved_resumable()
    res_rel = cfg.rel(resumable)
    keys = _numeric_mode_keys(resumable)
    if keys is None:
        out.append(Finding(
            "GL003", res_rel, 1,
            f"could not locate the _numeric_mode fingerprint dict in "
            f"{resumable} — numeric-affecting knobs cannot be verified"))
    else:
        for name in sorted(registry):
            k = registry[name]
            if k.numeric and k.numeric_key not in keys:
                out.append(Finding(
                    "GL003", res_rel, 1,
                    f"numeric-affecting knob {name} expects fingerprint key "
                    f"{k.numeric_key!r} in the resumable numeric_mode dict, "
                    "which only has "
                    f"{sorted(keys)} — resumed stores could mix numeric modes"))
    return out


def _numeric_mode_keys(path) -> set[str] | None:
    """String keys of the ``*_numeric_mode = {...}`` dict literal."""
    try:
        tree = ast.parse(path.read_text())
    except (OSError, SyntaxError):
        return None
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Dict):
            continue
        for tgt in node.targets:
            name = tgt.attr if isinstance(tgt, ast.Attribute) else (
                tgt.id if isinstance(tgt, ast.Name) else "")
            if name.endswith("_numeric_mode") or name == "numeric_mode":
                return {k.value for k in node.value.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)}
    return None
