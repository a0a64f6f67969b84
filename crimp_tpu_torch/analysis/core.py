"""graftlint core: findings, waivers, file loading, report, baseline.

Port of ``crimp_tpu/analysis/core.py``. The analyzer is a plain-AST pass:
it never imports the modules it checks (so a capture-discipline bug in a
kernel module cannot take the linter down with it) and never imports
torch (it runs in a shell with no backend; the knob registry it reads,
``crimp_tpu_torch/knobs.py``, imports only the standard library).

Waiver grammar (one line):

    some_code()  # graftlint: disable=GL005 (fixed-order column accumulation, see mesh.py note)
    # graftlint: disable-file=GL004 (host-side longdouble Taylor phase math by design)

A waiver suppresses only the named rules on its own line (or, for
``disable-file``, in its whole file). The parenthesized reason is
MANDATORY: a reasonless waiver still suppresses its target but raises an
unwaivable GL000 finding, so the tier-1 gate stays red until the reason
that survives review is written down.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import pathlib
import re
import tokenize

RULES: dict[str, str] = {
    "GL000": "waiver hygiene / unparseable source",
    "GL001": "capture purity: no env/time/random/file-I/O reachable from CUDA-graph capture",
    "GL002": "host-sync hazards: syncs / tensor coercions / tensor branching in captured code",
    "GL003": "knob-registry consistency (crimp_tpu_torch/knobs.py <-> env reads <-> docs <-> "
             "numeric_mode)",
    "GL004": "dtype discipline: longdouble/float128 confined to host-side anchor modules",
    "GL005": "order-sensitive reductions in sharded/parity-pinned modules",
    "GL006": "failure-domain discipline: bare `except Exception` must classify "
             "through resilience.taxonomy or carry a waiver reason",
    "GL007": "sharding-registry discipline: hand-written spec tuple outside "
             "parallel/registry.py needs a waiver",
    "GL008": "concurrency discipline: thread-reachable module-global mutations "
             "hold a declared lock; lock-declaring modules guard every mutation",
    "GL009": "resilience contract web (LADDERS/FAULT_POINTS <-> "
             "record_degradation/fire sites <-> tests <-> docs/robustness.md)",
    "GL010": "telemetry-surface drift (obs counters/gauges <-> "
             "docs/observability.md <-> consumers; ledger METRICS <-> chip_smoke.py)",
}

_RULE_LIST = r"GL\d{3}(?:\s*,\s*GL\d{3})*"
WAIVER_RE = re.compile(
    r"#\s*graftlint:\s*disable(?P<file>-file)?=(?P<rules>" + _RULE_LIST + r")"
    r"(?:\s*\((?P<reason>[^()]*(?:\([^()]*\)[^()]*)*)\))?"
)


@dataclasses.dataclass
class Finding:
    rule: str
    path: str  # root-relative posix path
    line: int
    message: str
    waived: bool = False
    reason: str = ""

    @property
    def key(self) -> str:
        """Line-number-free identity used by the baseline (a pure-motion
        edit above a finding must not make it count as new)."""
        return f"{self.rule}|{self.path}|{self.message}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "waived": self.waived,
            "reason": self.reason,
        }

    def render(self) -> str:
        tag = f"  [waived: {self.reason}]" if self.waived else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tag}"


@dataclasses.dataclass
class Waiver:
    rules: frozenset[str]
    reason: str
    line: int
    file_level: bool


@dataclasses.dataclass
class SourceFile:
    path: pathlib.Path
    rel: str
    text: str
    tree: ast.AST | None
    parse_error: str | None
    line_waivers: dict[int, Waiver]
    file_waivers: dict[str, Waiver]  # rule -> waiver

    @property
    def is_python(self) -> bool:
        return self.rel.endswith(".py")


# a comment opening with the tool name + "disable" shows directive intent
# even when the rest fails to parse; prose mentions of the tool do not
_DIRECTIVE_RE = re.compile(r"graftlint:\s*" + "disable")


def _comment_lines(text: str, is_python: bool) -> list[tuple[int, str]]:
    """(lineno, comment text) pairs. Python files go through tokenize so
    waiver syntax quoted in strings/docstrings (e.g. this linter's own
    error messages) is never mistaken for a directive; everything else
    (shell) falls back to a per-line scan of the '#...' tail."""
    if is_python:
        try:
            return [(tok.start[0], tok.string)
                    for tok in tokenize.generate_tokens(io.StringIO(text).readline)
                    if tok.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass  # unparseable source already yields GL000 via load_source
    out = []
    for i, line in enumerate(text.splitlines(), start=1):
        if "#" in line:
            out.append((i, line[line.index("#"):]))
    return out


def _scan_waivers(text: str, is_python: bool) -> tuple[dict[int, Waiver], dict[str, Waiver], list[tuple[int, str]]]:
    """Parse waiver comments; returns (line waivers, file waivers,
    [(line, problem)] for reasonless/malformed ones)."""
    line_waivers: dict[int, Waiver] = {}
    file_waivers: dict[str, Waiver] = {}
    problems: list[tuple[int, str]] = []
    for i, comment in _comment_lines(text, is_python):
        if not _DIRECTIVE_RE.search(comment):
            continue
        m = WAIVER_RE.search(comment)
        if m is None:
            problems.append((i, "malformed graftlint waiver (expected "
                                "'# graftlint: disable=GLxxx (reason)')"))
            continue
        rules = frozenset(r.strip() for r in m.group("rules").split(","))
        reason = (m.group("reason") or "").strip()
        if not reason:
            problems.append((i, f"waiver for {'/'.join(sorted(rules))} has no "
                                "(reason) — a waiver must say why it survives review"))
        w = Waiver(rules=rules, reason=reason, line=i,
                   file_level=bool(m.group("file")))
        if w.file_level:
            for r in rules:
                file_waivers[r] = w
        else:
            line_waivers[i] = w
    return line_waivers, file_waivers, problems


def load_source(path: pathlib.Path, root: pathlib.Path) -> SourceFile:
    text = path.read_text(encoding="utf-8", errors="replace")
    tree, err = None, None
    if path.suffix == ".py":
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError as exc:
            err = f"could not parse: {exc.msg} (line {exc.lineno})"
    lw, fw, problems = _scan_waivers(text, path.suffix == ".py")
    src = SourceFile(path=path, rel=path.relative_to(root).as_posix(),
                     text=text, tree=tree, parse_error=err,
                     line_waivers=lw, file_waivers=fw)
    src._waiver_problems = problems  # type: ignore[attr-defined]
    return src


EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules", "build",
                "dist", ".pytest_cache"}


def collect_files(paths: list[pathlib.Path], root: pathlib.Path) -> list[pathlib.Path]:
    """Expand the given files/directories into the .py + .sh scan set."""
    out: list[pathlib.Path] = []
    seen: set[pathlib.Path] = set()
    for p in paths:
        p = p if p.is_absolute() else root / p
        if p.is_dir():
            found = [f for f in sorted(p.rglob("*"))
                     if f.suffix in (".py", ".sh")
                     and not (set(f.relative_to(p).parts[:-1]) & EXCLUDE_DIRS)]
        elif p.exists():
            found = [p]
        else:
            raise FileNotFoundError(f"no such file or directory: {p}")
        for f in found:
            rp = f.resolve()
            if rp not in seen:
                seen.add(rp)
                out.append(f)
    return out


DEFAULT_GL004_ALLOWLIST = (
    "crimp_tpu_torch/ops/anchored.py",   # the longdouble anchor is this module's contract
    "crimp_tpu_torch/ops/deltafold.py",  # basis construction differences exact longdouble phases
    "crimp_tpu_torch/io/",               # parsing .par/.tim timestamps at full precision
)

DEFAULT_GL005_MODULES = ("crimp_tpu_torch/parallel/",)
DEFAULT_GL006_MODULES = ("crimp_tpu_torch/",)
DEFAULT_GL007_MODULES = ("crimp_tpu_torch/",)
DEFAULT_GL007_REGISTRY = "crimp_tpu_torch/parallel/registry.py"
DEFAULT_GL008_MODULES = ("crimp_tpu_torch/",)
DEFAULT_GL010_MODULES = ("crimp_tpu_torch/",)
# files whose text counts as "something reads this metric" for GL010
DEFAULT_TELEMETRY_CONSUMERS = ("crimp_tpu_torch/obs/report.py",
                               "crimp_tpu_torch/obs/ledger.py")
# the port's own docs: the tables GL003, GL009 and GL010 read
DOCS_DIR = ("crimp_tpu_torch", "docs")


@dataclasses.dataclass
class Config:
    """One analysis run's inputs (everything injectable for tests)."""

    root: pathlib.Path
    paths: list[pathlib.Path]
    registry: dict | None = None  # default: crimp_tpu_torch.knobs.REGISTRY
    tools_md: pathlib.Path | None = None  # default: root/crimp_tpu_torch/docs/tools.md
    resumable_py: pathlib.Path | None = None  # default: root/crimp_tpu_torch/ops/resumable.py
    knobs_rel: str = "crimp_tpu_torch/knobs.py"  # the one sanctioned env-read site
    gl004_allowlist: tuple[str, ...] = DEFAULT_GL004_ALLOWLIST
    gl005_modules: tuple[str, ...] = DEFAULT_GL005_MODULES
    gl006_modules: tuple[str, ...] = DEFAULT_GL006_MODULES
    gl007_modules: tuple[str, ...] = DEFAULT_GL007_MODULES
    gl007_registry: str = DEFAULT_GL007_REGISTRY
    gl008_modules: tuple[str, ...] = DEFAULT_GL008_MODULES
    gl010_modules: tuple[str, ...] = DEFAULT_GL010_MODULES
    telemetry_consumers: tuple[str, ...] = DEFAULT_TELEMETRY_CONSUMERS
    observability_md: pathlib.Path | None = None  # default: the port's docs/observability.md
    robustness_md: pathlib.Path | None = None  # default: the port's docs/robustness.md
    tests_dir: pathlib.Path | None = None  # default: root/tests
    # the file whose records the ledger METRICS read (chip_smoke.py in the
    # port; the field keeps the JAX package's name)
    bench_py: pathlib.Path | None = None  # default: root/chip_smoke.py
    rules: tuple[str, ...] | None = None  # None = all

    def resolved_registry(self) -> dict:
        if self.registry is not None:
            return self.registry
        from crimp_tpu_torch import knobs

        return knobs.REGISTRY

    def _doc(self, name: str) -> pathlib.Path:
        return self.root.joinpath(*DOCS_DIR, name)

    def resolved_tools_md(self) -> pathlib.Path:
        return self.tools_md or self._doc("tools.md")

    def resolved_resumable(self) -> pathlib.Path:
        return self.resumable_py or self.root / "crimp_tpu_torch" / "ops" / "resumable.py"

    def resolved_observability_md(self) -> pathlib.Path:
        return self.observability_md or self._doc("observability.md")

    def resolved_robustness_md(self) -> pathlib.Path:
        return self.robustness_md or self._doc("robustness.md")

    def resolved_tests_dir(self) -> pathlib.Path:
        return self.tests_dir or self.root / "tests"

    def resolved_bench_py(self) -> pathlib.Path:
        return self.bench_py or self.root / "chip_smoke.py"

    def rel(self, path: pathlib.Path) -> str:
        """``path`` relative to the root (posix), else as given."""
        try:
            return path.relative_to(self.root).as_posix()
        except ValueError:
            return path.as_posix()

    def rule_enabled(self, rule: str) -> bool:
        return self.rules is None or rule in self.rules


@dataclasses.dataclass
class Report:
    findings: list[Finding]
    files_scanned: int

    @property
    def unwaived(self) -> list[Finding]:
        return [f for f in self.findings if not f.waived]

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.unwaived:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "tool": "graftlint",
            "files_scanned": self.files_scanned,
            "counts": self.counts(),
            "findings": [f.to_dict() for f in self.findings],
        }

    def render_text(self, show_waived: bool = False) -> str:
        shown = self.findings if show_waived else self.unwaived
        lines = [f.render() for f in sorted(
            shown, key=lambda f: (f.path, f.line, f.rule))]
        n = len(self.unwaived)
        waived = len(self.findings) - n
        lines.append(f"graftlint: {self.files_scanned} files, "
                     f"{n} finding{'s' if n != 1 else ''} "
                     f"({waived} waived)")
        return "\n".join(lines)


def apply_waivers(findings: list[Finding], sources: dict[str, SourceFile]) -> list[Finding]:
    """Mark findings covered by line/file waivers; append GL000 findings
    for waiver-hygiene problems. GL000 itself is not waivable."""
    out: list[Finding] = []
    for f in findings:
        src = sources.get(f.path)
        if src is not None and f.rule != "GL000":
            fw = src.file_waivers.get(f.rule)
            lw = src.line_waivers.get(f.line)
            if fw is not None:
                f.waived, f.reason = True, fw.reason or "(no reason given)"
            elif lw is not None and f.rule in lw.rules:
                f.waived, f.reason = True, lw.reason or "(no reason given)"
        out.append(f)
    for src in sources.values():
        for line, problem in getattr(src, "_waiver_problems", []):
            out.append(Finding("GL000", src.rel, line, problem))
        if src.is_python and src.parse_error:
            out.append(Finding("GL000", src.rel, 1, src.parse_error))
    return out


# -- baseline ----------------------------------------------------------------


def save_baseline(report: Report, path: pathlib.Path) -> None:
    keys = sorted(f.key for f in report.unwaived)
    path.write_text(json.dumps({"version": 1, "keys": keys}, indent=2) + "\n")


def load_baseline(path: pathlib.Path) -> set[str]:
    doc = json.loads(path.read_text())
    if not isinstance(doc, dict) or doc.get("version") != 1:
        raise ValueError(f"{path}: not a graftlint baseline file")
    return set(doc.get("keys", []))


def new_findings(report: Report, baseline_keys: set[str]) -> list[Finding]:
    """Unwaived findings not present in the baseline — the --baseline gate
    fails only on these, so a PR inheriting old debt sees only its own."""
    return [f for f in report.unwaived if f.key not in baseline_keys]
