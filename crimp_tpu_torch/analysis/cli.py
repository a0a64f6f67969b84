"""graftlint CLI: ``python -m crimp_tpu_torch.analysis [paths...]``.

Port of ``crimp_tpu/analysis/cli.py``; the default scan set is the port and
``chip_smoke.py``.

Exit codes: 0 = clean (or nothing new vs --baseline), 1 = unwaived
findings, 2 = usage / I-O error. ``--write-baseline`` records today's
unwaived findings so future runs with ``--baseline`` fail only on NEW
findings (ratchet mode for incremental adoption); re-writing an existing
baseline refuses to *grow* it unless ``--allow-growth`` is passed — the
ratchet only ever tightens by default.

``--changed-only`` scopes the *report* to files git considers changed.
The analysis itself always runs over the full tree: the cross-layer
rules (GL003 knob web, GL008 thread reachability, GL009/GL010 contract
webs) need whole-program facts, so scoping the scan would silently
weaken them. Only the displayed/failing findings are filtered.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

from crimp_tpu_torch.analysis import engine, sarif
from crimp_tpu_torch.analysis.core import (
    RULES,
    Config,
    collect_files,
    load_baseline,
    load_source,
    new_findings,
    save_baseline,
)

DEFAULT_PATHS = ("crimp_tpu_torch", "chip_smoke.py")


def find_root(start: pathlib.Path) -> pathlib.Path:
    """Nearest ancestor carrying pyproject.toml (the repo root the GL003
    cross-checks are anchored to), else the start directory."""
    for cand in [start, *start.parents]:
        if (cand / "pyproject.toml").exists():
            return cand
    return start


def changed_paths(root: pathlib.Path) -> set[str]:
    """Root-relative posix paths git reports as changed (staged,
    unstaged, or untracked). Raises CalledProcessError/OSError on a
    broken git invocation — the caller turns that into exit 2."""
    out = subprocess.run(
        ["git", "-C", str(root), "status", "--porcelain"],
        check=True, capture_output=True, text=True).stdout
    changed: set[str] = set()
    for line in out.splitlines():
        if len(line) < 4:
            continue
        path = line[3:]
        # a rename is "R  old -> new"; the new path is the live one
        if " -> " in path:
            path = path.split(" -> ", 1)[1]
        changed.add(path.strip().strip('"'))
    return changed


def waiver_inventory(cfg: Config) -> list[tuple[str, str, int, str]]:
    """Every waiver in the scan set as (rule, rel, line, reason) rows,
    sorted by rule then location — the generated table
    crimp_tpu_torch/docs/analysis.md embeds."""
    rows: list[tuple[str, str, int, str]] = []
    for f in collect_files(cfg.paths, cfg.root):
        src = load_source(f, cfg.root)
        for w in src.line_waivers.values():
            for rule in sorted(w.rules):
                rows.append((rule, src.rel, w.line, w.reason))
        for rule, w in sorted(src.file_waivers.items()):
            rows.append((rule, src.rel, w.line, w.reason))
    return sorted(set(rows))


def render_waiver_table(rows: list[tuple[str, str, int, str]]) -> str:
    lines = ["| Rule | Site | Reason |", "|---|---|---|"]
    for rule, rel, line, reason in rows:
        lines.append(f"| {rule} | `{rel}:{line}` | {reason} |")
    lines.append(f"\n{len(rows)} waivers.")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m crimp_tpu_torch.analysis",
        description="graftlint: capture-discipline, knob-registry and "
                    "parity-invariant static analyzer for crimp_tpu_torch.")
    p.add_argument("paths", nargs="*", help="files/directories to scan "
                   f"(default: {' '.join(DEFAULT_PATHS)} under the repo root)")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text")
    p.add_argument("--root", type=pathlib.Path, default=None,
                   help="repo root (default: nearest ancestor with pyproject.toml)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset, e.g. GL001,GL003")
    p.add_argument("--baseline", type=pathlib.Path, default=None,
                   help="fail only on findings absent from this baseline file")
    p.add_argument("--write-baseline", type=pathlib.Path, default=None,
                   help="record current unwaived findings and exit 0")
    p.add_argument("--allow-growth", action="store_true",
                   help="let --write-baseline add finding keys to an "
                        "existing baseline (refused by default: the "
                        "ratchet only tightens)")
    p.add_argument("--changed-only", action="store_true",
                   help="report only findings in git-changed files (the "
                        "analysis still scans the full tree — cross-layer "
                        "rules need whole-program facts)")
    p.add_argument("--show-waived", action="store_true",
                   help="include waived findings in text output")
    p.add_argument("--waivers", action="store_true",
                   help="print the waiver inventory as a markdown table "
                        "and exit")
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    root = (args.root or find_root(pathlib.Path.cwd())).resolve()
    raw_paths = args.paths or [p for p in DEFAULT_PATHS if (root / p).exists()]
    cfg = Config(
        root=root,
        paths=[pathlib.Path(p) for p in raw_paths],
        rules=tuple(r.strip() for r in args.rules.split(",")) if args.rules else None,
    )
    if args.waivers:
        try:
            print(render_waiver_table(waiver_inventory(cfg)))
        except FileNotFoundError as exc:
            print(f"graftlint: {exc}", file=sys.stderr)
            return 2
        return 0
    try:
        report = engine.run(cfg)
    except FileNotFoundError as exc:
        print(f"graftlint: {exc}", file=sys.stderr)
        return 2

    if args.write_baseline is not None:
        if args.write_baseline.exists() and not args.allow_growth:
            try:
                prior = load_baseline(args.write_baseline)
            except (OSError, ValueError) as exc:
                print(f"graftlint: bad baseline: {exc}", file=sys.stderr)
                return 2
            grown = {f.key for f in report.unwaived} - prior
            if grown:
                print(f"graftlint: refusing to grow baseline "
                      f"{args.write_baseline} by {len(grown)} new finding "
                      f"key{'s' if len(grown) != 1 else ''} (pass "
                      "--allow-growth to accept new debt)", file=sys.stderr)
                for key in sorted(grown):
                    print(f"  + {key}", file=sys.stderr)
                return 2
        save_baseline(report, args.write_baseline)
        print(f"graftlint: wrote baseline with {len(report.unwaived)} "
              f"finding keys to {args.write_baseline}")
        return 0

    failing = report.unwaived
    if args.baseline is not None:
        try:
            failing = new_findings(report, load_baseline(args.baseline))
        except (OSError, ValueError) as exc:
            print(f"graftlint: bad baseline: {exc}", file=sys.stderr)
            return 2

    scope_note = ""
    if args.changed_only:
        try:
            changed = changed_paths(root)
        except (OSError, subprocess.CalledProcessError) as exc:
            print(f"graftlint: --changed-only needs a working git checkout: "
                  f"{exc}", file=sys.stderr)
            return 2
        failing = [f for f in failing if f.path in changed]
        scope_note = f" (changed-only: {len(changed)} changed files)"

    if args.format == "sarif":
        shown = report
        if args.changed_only:
            from crimp_tpu_torch.analysis.core import Report
            shown = Report(
                findings=[f for f in report.findings if f.path in changed],
                files_scanned=report.files_scanned)
        print(sarif.render_sarif_text(shown, root))
    elif args.format == "json":
        doc = report.to_dict()
        doc["new_findings"] = [f.to_dict() for f in failing]
        print(json.dumps(doc, indent=2))
    else:
        print(report.render_text(show_waived=args.show_waived))
        if args.baseline is not None:
            print(f"graftlint: {len(failing)} new vs baseline")
        if scope_note:
            print(f"graftlint: {len(failing)} failing{scope_note}")
    return 1 if failing else 0
