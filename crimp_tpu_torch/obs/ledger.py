"""Append-only performance ledger: classify, baseline, gate.

Port of ``crimp_tpu/obs/ledger.py``, with JAX's vocabulary and entry
schema. One deliberate difference: a baseline belongs to one platform and
device kind. ``check()`` gates the latest green entry only against greens of
its own platform and card (the others are reported excluded, class
``other_platform``), and ``baseline()`` takes the platform and kind to
keep, so a TPU-era record (``BENCH_r0*.json``) never seeds or gates an
H100's baseline. Entries carry ``device_kind`` beside ``platform``.

It ingests bench driver records (``BENCH_r*.json``),
raw bench record lines (``bench.log`` / ``results.jsonl``) and obs run
manifests into normalized ledger entries, classifies each by
``platform``/``platform_fallback`` (bench.py stamps these), excludes
everything that is not a green on-chip run from the baseline, and gates
new records against the per-metric baseline with a tolerance band
(``obs ledger check --fail-on-regression --tolerance-pct N`` for CI).

Classification vocabulary (one per entry):

- ``onchip``       — parsed record, zero rc, accelerator platform. Only
                     these contribute to (and are gated against) the
                     baseline.
- ``cpu_fallback`` — ran on CPU. Records predating the
                     ``platform_fallback`` stamp (r3/r4's drivers) are
                     conservatively classified here too, as is any obs
                     manifest whose backend is ``cpu``: nothing that ran
                     on CPU may ever seed an on-chip baseline.
- ``cpu_pinned``   — CPU with ``platform_fallback: false`` (the operator
                     forced CPU; excluded, but not an outage signal).
- ``carried``      — a carry-forward record (bench re-emitting the last
                     real measurement); never baseline material.
- ``degraded``     — the run completed only by taking a resilience
                     ladder rung (manifest ``degraded`` flag, or a bench
                     record stamped ``degraded``); its numbers reflect a
                     lower rung, so it never feeds the green baseline.
- ``failed``       — nonzero rc or no parseable record (r1's crash, r5's
                     rc=124 polling timeout).
- ``unknown``      — a parsed record from before the ``platform`` stamp
                     (r2); excluded, since its provenance is a guess.

A driver record ``BENCH_rNN.json`` additionally pulls in its sibling
``onchip_results_rNN/bench.log`` when present: the driver ran on the CPU
fallback during a relay outage, but the session's own on-chip record —
the one ROADMAP prose pointed at by hand — is the last record line of
that log, and it lands in the ledger as round NN's on-chip entry.
"""

from __future__ import annotations

import json
import os
import re

from crimp_tpu_torch import knobs

LEDGER_SCHEMA = "crimp_tpu.obs.ledger"
LEDGER_SCHEMA_VERSION = 1

GREEN_CLASSES = frozenset(("onchip",))

# metric name -> (where it lives in a bench record, which direction is
# better). "higher" gates throughput, "lower" gates walls and compile
# telemetry.
# The port has no benchmark yet: chip_smoke.py writes no bench record, so
# GL010's ledger leg finds most of these fields unfed until one exists.
METRICS: dict[str, dict] = {  # graftlint: disable=GL010 (no port benchmark yet, so chip_smoke.py produces no ledger record)
    "toas_per_sec": {"field": "value", "better": "higher"},
    "north_star_wall_s": {"field": "north_star_wall_s", "better": "lower"},
    "z2_trials_per_sec": {"field": "z2_trials_per_sec", "better": "higher"},
    "z2_trials_per_sec_poly": {"field": "z2_trials_per_sec_poly",
                               "better": "higher"},
    "config4_toas_per_sec": {"field": "config4_toas_per_sec",
                             "better": "higher"},
    "sources_per_s": {"field": "sources_per_s", "better": "higher"},
    "ess_per_s": {"field": "ess_per_s", "better": "higher"},
    "warmup_s": {"field": "warmup_s", "better": "lower"},
    "backend_compile_s": {"field": ("compile_cache", "backend_compile_s"),
                          "better": "lower"},
    "requests_per_s": {"field": "requests_per_s", "better": "higher"},
    "p99_latency_ms": {"field": "p99_latency_ms", "better": "lower"},
    # steady-state warm re-timing throughput (bench_serving's warm-heavy
    # phase: >=16 resident clients refolding per round)
    "warm_requests_per_s": {"field": "warm_requests_per_s",
                            "better": "higher"},
    # grid-search cube throughput (bench.py bench_jerk): equivalent-coherent
    # cube trials per second, so semi-coherent rounds are comparable to
    # coherent ones at matched coverage
    "trials_per_s": {"field": "trials_per_s", "better": "higher"},
}


def classify(record: dict | None, rc: int | None = None) -> str:
    """One class per record; see the module docstring for the vocabulary."""
    if rc not in (None, 0):
        return "failed"
    if not isinstance(record, dict):
        return "failed"
    if record.get("carried"):
        return "carried"
    if record.get("degraded"):
        return "degraded"
    platform = record.get("platform")
    if platform == "cpu":
        if record.get("platform_fallback") is False:
            return "cpu_pinned"
        # stamped true, or a pre-stamp legacy record: both mean "did not
        # run on the accelerator", which is all the baseline cares about
        return "cpu_fallback"
    if not platform:
        return "unknown"
    return "onchip"


def extract_metrics(record: dict) -> dict[str, float]:
    """The gateable metric values present in a bench record."""
    out: dict[str, float] = {}
    for name, spec in METRICS.items():
        field = spec["field"]
        if isinstance(field, tuple):
            val = record
            for part in field:
                val = val.get(part) if isinstance(val, dict) else None
        else:
            val = record.get(field)
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[name] = float(val)
    return out


def entry_from_record(record: dict | None, *, source: str, kind: str = "bench",
                      round_n: int | None = None,
                      rc: int | None = None) -> dict:
    """Normalize one bench record (or its absence) into a ledger entry.

    The ``process_index``/``process_count`` stamps ride along (defaulting
    to the single-process identity for records predating the stamp) so the
    green baseline never mixes single-host and N-host rates — ``check()``
    gates a candidate only against greens with the same process count."""
    rec = record if isinstance(record, dict) else {}
    return {
        "schema": LEDGER_SCHEMA,
        "v": LEDGER_SCHEMA_VERSION,
        "kind": kind,
        "source": source,
        "round": round_n,
        "rc": rc,
        "class": classify(record, rc),
        "platform": rec.get("platform"),
        "platform_fallback": rec.get("platform_fallback"),
        "carried": bool(rec.get("carried")),
        "process_index": int(rec.get("process_index") or 0),
        "process_count": int(rec.get("process_count") or 1),
        "metrics": extract_metrics(rec),
        "device_kind": rec.get("device_kind"),
    }


def _entry_from_manifest(doc: dict, source: str) -> dict:
    backend = (doc.get("platform") or {}).get("backend")
    devices = (doc.get("platform") or {}).get("devices") or []
    kind = (devices[0] or {}).get("kind") if devices else None
    if backend and backend != "cpu":
        cls = "onchip"
    elif backend == "cpu":
        cls = "cpu_fallback"
    else:
        cls = "unknown"
    if doc.get("degraded"):
        cls = "degraded"  # completed on a ladder rung, not the normal path
    if doc.get("salvaged"):
        cls = "failed"  # a killed run's lower-bound walls are not baselines
    metrics = {}
    wall = doc.get("wall_s")
    if isinstance(wall, (int, float)):
        metrics["run_wall_s"] = float(wall)
    # cost-model extensions: recorded for longitudinal history, but NOT
    # in METRICS — check() skips them, so they cannot gate a round yet
    hbm_peak = (doc.get("gauges") or {}).get("hbm_peak_bytes")
    if isinstance(hbm_peak, (int, float)):
        metrics["hbm_peak_bytes"] = float(hbm_peak)
    if doc.get("costmodel"):
        try:
            from crimp_tpu_torch.obs import roofline
            analysis = roofline.analyze(doc)
            for key in ("worst_pct", "best_pct"):
                val = analysis.get(key)
                if isinstance(val, (int, float)):
                    metrics[f"roofline_{key}"] = float(val)
        except Exception:  # noqa: BLE001 — a sparse manifest yields no roofline metric, never a failed ingest  # graftlint: disable=GL006 (telemetry guard: roofline join is optional ledger enrichment)
            pass
    return {
        "schema": LEDGER_SCHEMA, "v": LEDGER_SCHEMA_VERSION,
        "kind": "obs_manifest", "source": source,
        "round": _round_from_name(source), "rc": None, "class": cls,
        "platform": backend, "platform_fallback": None, "carried": False,
        "metrics": metrics, "device_kind": kind,
    }


def _round_from_name(path: str) -> int | None:
    # BENCH_r04.json -> 4; onchip_results_r4/bench.log -> 4
    m = re.search(r"_r0*(\d+)(?:\D|$)", path)
    return int(m.group(1)) if m else None


def _record_lines(path: str) -> list[dict]:
    """Every parseable bench-record JSON line of a log/JSONL file."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(doc, dict) and "metric" in doc:
                out.append(doc)
    return out


def entries_from_path(path: str) -> list[dict]:
    """Ingest one artifact into ledger entries (see module docstring).

    Driver records fan out into the driver entry plus the sibling
    ``onchip_results_rNN/bench.log`` session record when one exists.
    """
    base = os.path.basename(path)
    if base.endswith((".log", ".jsonl")):
        records = _record_lines(path)
        if not records:
            return [entry_from_record(None, source=path, kind="bench_log",
                                      round_n=_round_from_name(path))]
        return [entry_from_record(records[-1], source=path, kind="bench_log",
                                  round_n=_round_from_name(path))]
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: expected a JSON object")
    if doc.get("schema") == "crimp_tpu.obs":
        return [_entry_from_manifest(doc, path)]
    if "parsed" in doc and ("rc" in doc or "cmd" in doc):
        round_n = doc.get("n") if isinstance(doc.get("n"), int) \
            else _round_from_name(path)
        entries = [entry_from_record(doc.get("parsed"), source=path,
                                     kind="bench_driver", round_n=round_n,
                                     rc=doc.get("rc"))]
        if round_n is not None:
            sibling = os.path.join(os.path.dirname(os.path.abspath(path)),
                                   f"onchip_results_r{round_n}", "bench.log")
            if os.path.exists(sibling):
                entries.extend(entries_from_path(sibling))
        return entries
    if "metric" in doc:
        return [entry_from_record(doc, source=path, kind="bench",
                                  round_n=_round_from_name(path))]
    raise ValueError(f"{path}: not a bench record, driver record, or obs "
                     "manifest")


def append(path: str, entries: list[dict]) -> None:
    """Append normalized entries to the ledger JSONL (append-only)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "a", encoding="utf-8") as fh:
        for entry in entries:
            json.dump(entry, fh, default=str)
            fh.write("\n")


def read(path: str) -> list[dict]:
    """All entries of a ledger file (missing file = empty ledger)."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(doc, dict):
                out.append(doc)
    return out


def _ordered(entries: list[dict]) -> list[dict]:
    # Stable order: by round (unknown rounds first, as ambient history),
    # then ingestion order — "latest" is the last element.
    def key(pair):
        i, e = pair
        rnd = e.get("round")
        return (rnd if isinstance(rnd, int) else -1, i)

    return [e for _, e in sorted(enumerate(entries), key=key)]


def _same_card(e: dict, platform, device_kind) -> bool:
    return e.get("platform") == platform and e.get("device_kind") == device_kind


def baseline(entries: list[dict], platform=..., device_kind=...) -> dict[str, dict]:
    """Per-metric green baseline: the latest green entry carrying it, of
    ``platform`` and ``device_kind`` when they are given."""
    base: dict[str, dict] = {}
    for e in _ordered(entries):
        if e.get("class") not in GREEN_CLASSES:
            continue
        if platform is not ... and not _same_card(e, platform, device_kind):
            continue
        for metric, value in (e.get("metrics") or {}).items():
            base[metric] = {"value": value, "round": e.get("round"),
                            "source": e.get("source")}
    return base


def check(entries: list[dict], tolerance_pct: float = 5.0) -> dict:
    """Gate the latest green entry against the baseline of the rest.

    The latest green entry (by round, then ingestion order) is the
    candidate; the baseline is computed from the green entries before it.
    With a single green entry there is nothing to compare — it *is* the
    baseline and the check passes. Non-green entries are reported as
    excluded. A metric regresses when it is worse than baseline by more
    than ``tolerance_pct`` percent in its metric's bad direction.

    Greens whose ``process_count`` differs from the candidate's are
    excluded from its baseline (reported with class
    ``other_process_count``): a 4-host aggregate rate must never gate —
    or be gated by — a single-host run of the same metric. So are greens
    of another platform or device kind (class ``other_platform``).
    """
    ordered = _ordered(entries)
    greens = [e for e in ordered
              if e.get("class") in GREEN_CLASSES and e.get("metrics")]
    if greens:
        cand = greens[-1]
        cand_pc = int(cand.get("process_count") or 1)
        other_card = [e for e in greens[:-1]
                      if not _same_card(e, cand.get("platform"), cand.get("device_kind"))]
        mismatched = [e for e in greens[:-1] if e not in other_card
                      and int(e.get("process_count") or 1) != cand_pc]
        greens = [e for e in greens if e not in mismatched and e not in other_card]
    else:
        mismatched, other_card = [], []
    excluded = [{"source": e.get("source"), "round": e.get("round"),
                 "class": e.get("class")}
                for e in ordered if e.get("class") not in GREEN_CLASSES]
    excluded += [{"source": e.get("source"), "round": e.get("round"),
                  "class": "other_process_count"} for e in mismatched]
    excluded += [{"source": e.get("source"), "round": e.get("round"),
                  "class": "other_platform"} for e in other_card]
    report = {
        "tolerance_pct": tolerance_pct,
        "entries": len(entries),
        "excluded": excluded,
        "baseline": {},
        "baseline_round": None,
        "candidate": None,
        "regressions": [],
        "improvements": [],
        "ok": True,
    }
    if not greens:
        return report
    candidate, prior = greens[-1], greens[:-1]
    base = baseline(prior if prior else [candidate])
    report["baseline"] = base
    rounds = [b["round"] for b in base.values() if b["round"] is not None]
    report["baseline_round"] = max(rounds) if rounds else None
    report["candidate"] = {"source": candidate.get("source"),
                           "round": candidate.get("round"),
                           "metrics": candidate.get("metrics")}
    if not prior:
        return report
    tol = tolerance_pct / 100.0
    for metric, cand_val in (candidate.get("metrics") or {}).items():
        if metric not in base or metric not in METRICS:
            continue
        base_val = base[metric]["value"]
        if base_val == 0:
            continue
        higher = METRICS[metric]["better"] == "higher"
        delta_pct = 100.0 * (cand_val - base_val) / abs(base_val)
        worse = cand_val < base_val * (1.0 - tol) if higher \
            else cand_val > base_val * (1.0 + tol)
        row = {"metric": metric, "candidate": cand_val, "baseline": base_val,
               "baseline_round": base[metric]["round"],
               "delta_pct": round(delta_pct, 2)}
        if worse:
            report["regressions"].append(row)
        elif (delta_pct > 0) == higher and delta_pct != 0:
            report["improvements"].append(row)
    report["ok"] = not report["regressions"]
    return report


def render_check(report: dict) -> str:
    """Human-readable rendering of a :func:`check` report."""
    lines = [f"ledger: {report['entries']} entries, tolerance "
             f"{report['tolerance_pct']:g}%"]
    for e in report["excluded"]:
        rnd = f"r{e['round']}" if e["round"] is not None else "r?"
        lines.append(f"  excluded  {rnd:<4} {e['class']:<13} {e['source']}")
    if not report["baseline"]:
        lines.append("no green on-chip entries: nothing to gate")
        return "\n".join(lines)
    rnd = report["baseline_round"]
    lines.append(f"green baseline (round "
                 f"{'r%d' % rnd if rnd is not None else '?'}):")
    for metric, b in sorted(report["baseline"].items()):
        lines.append(f"  {metric:<24} {b['value']:<12g} {b['source']}")
    cand = report["candidate"]
    if cand is not None:
        crnd = f"r{cand['round']}" if cand["round"] is not None else "r?"
        lines.append(f"candidate {crnd}: {cand['source']}")
    for row in report["regressions"]:
        lines.append(
            f"  REGRESSION  {row['metric']}: {row['candidate']:g} vs "
            f"baseline {row['baseline']:g} (r{row['baseline_round']}) "
            f"{row['delta_pct']:+.1f}%")
    for row in report["improvements"]:
        lines.append(
            f"  improved    {row['metric']}: {row['candidate']:g} vs "
            f"baseline {row['baseline']:g} {row['delta_pct']:+.1f}%")
    lines.append("OK" if report["ok"] else "FAIL")
    return "\n".join(lines)


def env_ledger_path() -> str | None:
    """The CRIMP_TORCH_OBS_LEDGER path, or None when unset/disabled."""
    env = knobs.raw("CRIMP_TORCH_OBS_LEDGER")
    if not env or knobs.parse_onoff(env) is False:
        return None
    return env


def append_bench_record(record: dict, *, source: str,
                        round_n: int | None = None) -> str | None:
    """Bench's end-of-round hook: append when the ledger knob is set.

    Returns the ledger path written to, or None when the knob is off.
    Never raises — the official record on stdout must not be lost to a
    full disk under the ledger path.
    """
    path = env_ledger_path()
    if path is None:
        return None
    try:
        append(path, [entry_from_record(record, source=source, kind="bench",
                                        round_n=round_n)])
    except OSError:
        return None
    return path
