"""Reporter CLI: ``python -m crimp_tpu_torch.obs <subcommand>``.

Port of ``crimp_tpu/obs/cli.py``:

- ``summary MANIFEST``        one-run summary (spans, counters, knobs)
- ``diff A B``                attribute A->B slowdown; flag knob/numeric drift
- ``trace MANIFEST [-o OUT]`` export Chrome trace-event JSON (Perfetto)
- ``prom MANIFEST [-o OUT]``  export Prometheus text exposition
- ``roofline MANIFEST``       join cost-model rows x kernel spans into a
                              per-kernel share-of-roofline table
                              (``--fail-below PCT``)
- ``validate MANIFEST``       schema-check a manifest
- ``merge STREAMS...``        join per-host event streams of one multi-host
                              run into a single validated manifest
- ``salvage EVENTS``          reconstruct a manifest from a killed run's
                              event stream (``"salvaged": true``)
- ``tail TARGET``             follow a live event stream (progress/ETA)
- ``heartbeat-check SIDECAR --max-age-s N``
                              liveness probe: exit 0 when the sidecar is
                              fresher than N seconds, 1 when stale, missing
                              or torn
- ``ledger add|show|check``   the append-only performance ledger

Exit codes: 0 = ok, 1 = validation problems / drift found with
``--fail-on-drift`` / regression with ``--fail-on-regression`` / roofline
worst kernel below ``--fail-below`` / tail without a run end / a stale
heartbeat, 2 = usage or I/O error.
"""

from __future__ import annotations

import argparse
import json
import sys

from crimp_tpu_torch.obs import heartbeat as hbt
from crimp_tpu_torch.obs import ledger as ldg
from crimp_tpu_torch.obs import merge as mrg
from crimp_tpu_torch.obs import report as rpt
from crimp_tpu_torch.obs import roofline as rfl
from crimp_tpu_torch.obs import salvage as slv
from crimp_tpu_torch.obs.manifest import load_manifest, validate_manifest


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m crimp_tpu_torch.obs",
                                description="crimp_tpu_torch flight-recorder reporter: summarize, diff "
                                            "and export run manifests.")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary", help="summarize one run manifest")
    s.add_argument("manifest")
    s.add_argument("--format", choices=("text", "json"), default="text")

    d = sub.add_parser("diff", help="compare two run manifests (A -> B)")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("--format", choices=("text", "json"), default="text")
    d.add_argument("--min-delta-s", type=float, default=0.005, help="ignore stage deltas below this (timer noise)")
    d.add_argument("--fail-on-drift", action="store_true",
                   help="exit 1 when knobs, numeric_mode or backend drifted")

    t = sub.add_parser("trace", help="export Chrome trace-event JSON")
    t.add_argument("manifest")
    t.add_argument("-o", "--out", default=None, help="output path (default stdout)")

    m = sub.add_parser("prom", help="export Prometheus text exposition")
    m.add_argument("manifest")
    m.add_argument("-o", "--out", default=None, help="output path (default stdout)")

    r = sub.add_parser("roofline", help="per-kernel achieved FLOP/s, intensity and share of the "
                                        "roofline from the manifest's cost-model rows")
    r.add_argument("manifest")
    r.add_argument("--format", choices=("text", "json"), default="text")
    r.add_argument("--fail-below", type=float, default=None, metavar="PCT",
                   help="exit 1 when the worst measured kernel sits below this percent of its roofline")

    v = sub.add_parser("validate", help="schema-check a manifest")
    v.add_argument("manifest")

    mg = sub.add_parser("merge", help="join per-host event streams of one multi-host run into a single "
                                      "validated manifest")
    mg.add_argument("streams", nargs="+", help="per-host *.events.jsonl files, or one run directory (newest "
                                               "run's host group wins)")
    mg.add_argument("-o", "--out", default=None,
                    help="output path (default: <run_id>.merged.manifest.json next to the first stream)")
    mg.add_argument("--run-id", default=None,
                    help="with a directory target: merge this run's host group instead of the newest one "
                         "(a unique substring of the id is enough)")
    mg.add_argument("--force", action="store_true",
                    help="join streams whose run_ids disagree (clock skew at the stamp second)")
    mg.add_argument("--trace-out", default=None, metavar="PATH",
                    help="also export the merged Chrome trace (per-host lanes) to PATH")

    sv = sub.add_parser("salvage", help="reconstruct a best-effort manifest from a killed run's event stream")
    sv.add_argument("events", help="*.events.jsonl file or a run directory (newest stream wins)")
    sv.add_argument("-o", "--out", default=None,
                    help="output path (default: <run>.salvaged.manifest.json next to the stream)")

    tl = sub.add_parser("tail", help="follow a live event stream, rendering progress/ETA heartbeats")
    tl.add_argument("target", help="run directory or *.events.jsonl file")
    tl.add_argument("--once", action="store_true",
                    help="render what is there and exit (0 only if the run already ended)")
    tl.add_argument("--interval", type=float, default=2.0, help="poll period in seconds")
    tl.add_argument("--max-seconds", type=float, default=None,
                    help="give up (exit 1) after this long without run_end")

    hb = sub.add_parser("heartbeat-check", help="liveness-probe a heartbeat sidecar (exit 0 fresh, "
                                                "1 stale/missing/torn)")
    hb.add_argument("sidecar", help="*.heartbeat.json file or a run directory (newest sidecar wins)")
    hb.add_argument("--max-age-s", type=float, required=True,
                    help="maximum sidecar age in seconds to count as alive")
    hb.add_argument("--format", choices=("text", "json"), default="text")

    lg = sub.add_parser("ledger", help="append-only performance ledger: classify records, baseline, gate")
    lg.add_argument("action", choices=("add", "show", "check"))
    lg.add_argument("paths", nargs="*",
                    help="bench records (BENCH_r*.json), bench logs, or obs manifests to ingest")
    lg.add_argument("--ledger", default=None, help="ledger JSONL path (default: $CRIMP_TORCH_OBS_LEDGER)")
    lg.add_argument("--format", choices=("text", "json"), default="text")
    lg.add_argument("--tolerance-pct", type=float, default=5.0, help="regression tolerance band per metric")
    lg.add_argument("--fail-on-regression", action="store_true",
                    help="exit 1 when the latest green entry regresses")
    return p


def _ledger_entries(args) -> tuple[list[dict], str | None]:
    """Entries for a ledger action: stored ledger rows + listed artifacts."""
    path = args.ledger if args.ledger is not None else ldg.env_ledger_path()
    entries = ldg.read(path) if path else []
    for src in args.paths:
        entries.extend(ldg.entries_from_path(src))
    return entries, path


def _cmd_ledger(args) -> int:
    if args.action == "add":
        path = args.ledger if args.ledger is not None else ldg.env_ledger_path()
        if not path:
            print("obs ledger add: no ledger path (--ledger or CRIMP_TORCH_OBS_LEDGER)", file=sys.stderr)
            return 2
        if not args.paths:
            print("obs ledger add: nothing to ingest", file=sys.stderr)
            return 2
        entries = []
        for src in args.paths:
            entries.extend(ldg.entries_from_path(src))
        ldg.append(path, entries)
        print(f"appended {len(entries)} entrie(s) to {path}")
        return 0
    entries, _ = _ledger_entries(args)
    if args.action == "show":
        doc = {"entries": entries, "baseline": ldg.baseline(entries)}
        if args.format == "json":
            print(json.dumps(doc, indent=2))
        else:
            for e in entries:
                rnd = f"r{e.get('round')}" if e.get("round") is not None else "r?"
                print(f"{rnd:<4} {e.get('class', '?'):<13} {e.get('kind', '?'):<13} {e.get('source', '?')}")
            for metric, b in sorted(doc["baseline"].items()):
                print(f"baseline {metric:<24} {b['value']:<12g} {b['source']}")
        return 0
    report = ldg.check(entries, tolerance_pct=args.tolerance_pct)
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        print(ldg.render_check(report))
    return 1 if (args.fail_on_regression and not report["ok"]) else 0


def _write(text: str, out: str | None) -> None:
    if out:
        with open(out, "w", encoding="utf-8") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text if text.endswith("\n") else text + "\n")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.cmd == "validate":
            with open(args.manifest, encoding="utf-8") as fh:
                doc = json.load(fh)
            problems = validate_manifest(doc)
            for prob in problems:
                print(f"{args.manifest}: {prob}")
            print(f"{args.manifest}: " + ("OK" if not problems else f"{len(problems)} problem(s)"))
            return 1 if problems else 0

        if args.cmd == "summary":
            doc = load_manifest(args.manifest)
            if args.format == "json":
                print(json.dumps({"summary": rpt.span_rollup(doc), "counters": doc.get("counters"),
                                  "gauges": doc.get("gauges"), "knobs": doc.get("knobs"),
                                  "run_id": doc["run_id"], "wall_s": doc["wall_s"]}, indent=2))
            else:
                print(rpt.summarize(doc))
            return 0

        if args.cmd == "diff":
            a = load_manifest(args.a)
            b = load_manifest(args.b)
            d = rpt.diff(a, b, min_delta_s=args.min_delta_s)
            if args.format == "json":
                print(json.dumps(d, indent=2))
            else:
                print(rpt.render_diff(d))
            drifted = bool(d["knob_drift"] or d["numeric_mode_drift"] or d["backend_drift"])
            return 1 if (args.fail_on_drift and drifted) else 0

        if args.cmd == "trace":
            doc = load_manifest(args.manifest)
            _write(json.dumps(rpt.chrome_trace(doc), indent=1), args.out)
            return 0

        if args.cmd == "prom":
            doc = load_manifest(args.manifest)
            _write(rpt.prometheus(doc), args.out)
            return 0

        if args.cmd == "roofline":
            doc = load_manifest(args.manifest)
            analysis = rfl.analyze(doc)
            if args.format == "json":
                print(json.dumps(analysis, indent=2))
            else:
                print(rfl.render(analysis))
            if args.fail_below is not None:
                worst = analysis.get("worst_pct")
                if worst is None:
                    print("obs roofline: --fail-below set but no kernel had both a cost row and a "
                          "measured span", file=sys.stderr)
                    return 1
                if worst < args.fail_below:
                    print(f"obs roofline: worst kernel {worst:.2f}% of roof < --fail-below "
                          f"{args.fail_below:g}%", file=sys.stderr)
                    return 1
            return 0

        if args.cmd == "merge":
            streams = mrg.resolve_streams(args.streams, run_id=args.run_id)
            out = mrg.merge_file(streams, args.out, force=args.force)
            doc = load_manifest(out)  # a merge that fails validation is a bug
            print(out)
            if args.trace_out:
                _write(json.dumps(rpt.chrome_trace(doc), indent=1), args.trace_out)
            print(rpt.summarize(doc), file=sys.stderr)
            return 0

        if args.cmd == "salvage":
            events = slv.resolve_events(args.events)
            out = slv.salvage_file(events, args.out)
            doc = load_manifest(out)  # a salvage that fails validation is a bug
            print(out)
            print(rpt.summarize(doc), file=sys.stderr)
            return 0

        if args.cmd == "tail":
            return slv.tail(args.target, follow=not args.once, interval=args.interval,
                            max_seconds=args.max_seconds)

        if args.cmd == "heartbeat-check":
            # missing/torn/stale are not usage errors: check_sidecar absorbs
            # them into (fresh=False, reason), so a dead service probes as 1
            fresh, reason, doc = hbt.check_sidecar(args.sidecar, args.max_age_s)
            if args.format == "json":
                print(json.dumps({"fresh": fresh, "reason": reason, "heartbeat": doc}, indent=2))
            else:
                print(f"heartbeat-check: {reason}")
            return 0 if fresh else 1

        if args.cmd == "ledger":
            return _cmd_ledger(args)
    except (OSError, ValueError) as exc:
        print(f"obs: {exc}", file=sys.stderr)
        return 2
    return 2
