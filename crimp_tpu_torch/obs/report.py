"""Reporter: summarize / diff manifests, export Chrome trace + Prometheus.

Port of ``crimp_tpu/obs/report.py``, output for output: the series names
of the Prometheus exposition are the schema's (``crimp_tpu_*``), so one
dashboard reads both packages' runs. ``diff`` answers "why was run B slow"
from artifacts: it rolls both span trees up by path, attributes the
wall-time delta stage by stage, and surfaces counter deltas plus knob,
numeric-mode and backend drift (a run that fell to the CPU shows as
backend drift).
"""

from __future__ import annotations

import json
import math

from crimp_tpu_torch.obs.manifest import span_paths


def _sec(val) -> str:
    """Seconds for humans; '?' for a partial doc's missing/null field."""
    return f"{val:.3f}s" if isinstance(val, (int, float)) else "?"


def span_rollup(doc: dict) -> dict[str, dict]:
    """Aggregate span durations by path: path -> {sum_s, count, kind}."""
    out: dict[str, dict] = {}
    for path, row in zip(span_paths(doc), doc.get("spans") or []):
        dur = row.get("dur_s")
        if dur is None:
            continue
        agg = out.setdefault(path, {"sum_s": 0.0, "count": 0, "kind": row["kind"]})
        agg["sum_s"] += float(dur)
        agg["count"] += 1
    for agg in out.values():
        agg["sum_s"] = round(agg["sum_s"], 6)
    return out


def summarize(doc: dict, top: int = 12) -> str:
    """Human-readable one-run summary (the ``summary`` subcommand)."""
    plat = doc.get("platform") or {}
    lines = []
    if doc.get("salvaged"):
        lines.append("SALVAGED reconstructed from the event stream of a "
                     "killed run; durations are lower bounds")
    lines += [
        f"run      {doc.get('run_id') or '?'}",
        f"name     {doc.get('name') or '?'}",
        f"wall     {_sec(doc.get('wall_s'))}"
        + (f"   ERROR: {doc['error']}" if doc.get("error") else ""),
        f"backend  {plat.get('backend') or 'none initialized'}"
        f"  devices={len(plat.get('devices') or [])}",
    ]
    if doc.get("numeric_mode"):
        lines.append("numeric  " + json.dumps(doc["numeric_mode"], sort_keys=True))
    snap = doc.get("knobs") or {}
    if snap:
        lines.append(f"knobs    {len(snap)} set: "
                     + " ".join(f"{k}={v}" for k, v in sorted(snap.items())))
    rollup = span_rollup(doc)
    rollup.pop(doc.get("name"), None)  # the root just restates wall_s
    if rollup:
        lines.append(f"spans    ({min(top, len(rollup))} of {len(rollup)} paths by total time)")
        ranked = sorted(rollup.items(), key=lambda kv: -kv[1]["sum_s"])
        for path, agg in ranked[:top]:
            lines.append(f"  {agg['sum_s']:9.3f}s  x{agg['count']:<4d} {path}")
    counters = doc.get("counters") or {}
    if counters:
        lines.append("counters")
        for name, val in sorted(counters.items()):
            lines.append(f"  {_num(val):>12}  {name}")
    gauges = doc.get("gauges") or {}
    if gauges:
        lines.append("gauges")
        for name, val in sorted(gauges.items()):
            lines.append(f"  {_num(val):>12}  {name}")
    cm = doc.get("costmodel") or {}
    if cm:
        lines.append(f"cost     {len(cm)} kernel cost row(s) "
                     "(`obs roofline` joins them against span times)")
    comp = doc.get("compile") or {}
    if comp:
        lines.append(
            "compile  hits=%s misses=%s backend_compile=%.2fs" % (
                comp.get("cache_hits", 0), comp.get("cache_misses", 0),
                comp.get("backend_compile_s", 0.0)))
    return "\n".join(lines)


def _num(val) -> str:
    if isinstance(val, float) and not val.is_integer():
        return f"{val:.4g}"
    return str(int(val))


def diff(a: dict, b: dict, min_delta_s: float = 0.005) -> dict:
    """Structured A→B comparison: stage slowdowns, counter/knob drift.

    ``stages`` is sorted by |delta| descending, so the first entry *is*
    the slowdown attribution. Stages whose delta is under ``min_delta_s``
    are dropped (timer noise, not signal).
    """
    ra, rb = span_rollup(a), span_rollup(b)
    # the root span just restates wall_s (reported separately) — left in,
    # it would always outrank the actual per-stage attribution
    ra.pop(a.get("name"), None)
    rb.pop(b.get("name"), None)
    stages = []
    for path in sorted(set(ra) | set(rb)):
        sa = ra.get(path, {}).get("sum_s", 0.0)
        sb = rb.get(path, {}).get("sum_s", 0.0)
        delta = sb - sa
        if abs(delta) < min_delta_s:
            continue
        stages.append({
            "path": path, "a_s": round(sa, 6), "b_s": round(sb, 6),
            "delta_s": round(delta, 6),
            "ratio": round(sb / sa, 3) if sa > 0 else None,
            "count_a": ra.get(path, {}).get("count", 0),
            "count_b": rb.get(path, {}).get("count", 0),
        })
    stages.sort(key=lambda s: -abs(s["delta_s"]))

    ca, cb = a.get("counters") or {}, b.get("counters") or {}
    counters = {
        name: {"a": ca.get(name, 0), "b": cb.get(name, 0),
               "delta": _round6(cb.get(name, 0) - ca.get(name, 0))}
        for name in sorted(set(ca) | set(cb))
        if ca.get(name, 0) != cb.get(name, 0)
    }

    ka, kb = a.get("knobs") or {}, b.get("knobs") or {}
    knob_drift = {
        name: {"a": ka.get(name), "b": kb.get(name)}
        for name in sorted(set(ka) | set(kb))
        if ka.get(name) != kb.get(name)
    }

    na, nb = a.get("numeric_mode"), b.get("numeric_mode")
    numeric_drift = None
    if na != nb:
        keys = set(na or {}) | set(nb or {})
        numeric_drift = {
            key: {"a": (na or {}).get(key), "b": (nb or {}).get(key)}
            for key in sorted(keys)
            if (na or {}).get(key) != (nb or {}).get(key)
        }

    pa = (a.get("platform") or {}).get("backend")
    pb = (b.get("platform") or {}).get("backend")
    wa, wb = a.get("wall_s"), b.get("wall_s")
    both_walls = all(isinstance(w, (int, float)) for w in (wa, wb))
    return {
        "a": a.get("run_id") or "?", "b": b.get("run_id") or "?",
        "wall_a_s": wa, "wall_b_s": wb,
        "wall_delta_s": _round6(wb - wa) if both_walls else None,
        "salvaged": ({"a": bool(a.get("salvaged")), "b": bool(b.get("salvaged"))}
                     if (a.get("salvaged") or b.get("salvaged")) else None),
        "backend_drift": None if pa == pb else {"a": pa, "b": pb},
        "stages": stages,
        "counters": counters,
        "knob_drift": knob_drift,
        "numeric_mode_drift": numeric_drift,
    }


def _round6(val):
    return round(val, 6) if isinstance(val, float) else val


def render_diff(d: dict, top: int = 12) -> str:
    """Human-readable rendering of a :func:`diff` result."""
    delta = d["wall_delta_s"]
    delta_txt = f"{delta:+.3f}s" if isinstance(delta, (int, float)) else "?"
    lines = [
        f"A  {d['a']}   wall {_sec(d['wall_a_s'])}",
        f"B  {d['b']}   wall {_sec(d['wall_b_s'])}   delta {delta_txt}",
    ]
    if d.get("salvaged"):
        which = "+".join(k.upper() for k in ("a", "b") if d["salvaged"][k])
        lines.append(f"SALVAGED {which}  (killed-run reconstruction; "
                     "durations are lower bounds)")
    if d["backend_drift"]:
        lines.append(f"BACKEND DRIFT  {d['backend_drift']['a']} -> "
                     f"{d['backend_drift']['b']}")
    if d["stages"]:
        lines.append("stage attribution (delta B-A, worst first)")
        for s in d["stages"][:top]:
            ratio = f" x{s['ratio']:.2f}" if s["ratio"] else ""
            lines.append(f"  {s['delta_s']:+9.3f}s{ratio:>8}  {s['path']}"
                         f"  ({s['a_s']:.3f}s -> {s['b_s']:.3f}s)")
    else:
        lines.append("stage attribution: no stage moved beyond noise")
    if d["counters"]:
        lines.append("counter deltas")
        for name, row in d["counters"].items():
            lines.append(f"  {_num(row['a']):>10} -> {_num(row['b']):<10} {name}")
    if d["knob_drift"]:
        lines.append("KNOB DRIFT")
        for name, row in d["knob_drift"].items():
            lines.append(f"  {name}: {row['a'] or '<unset>'} -> {row['b'] or '<unset>'}")
    if d["numeric_mode_drift"]:
        lines.append("NUMERIC-MODE DRIFT")
        for key, row in d["numeric_mode_drift"].items():
            lines.append(f"  {key}: {row['a']!r} -> {row['b']!r}")
    return "\n".join(lines)


def chrome_trace(doc: dict) -> dict:
    """Chrome trace-event JSON (load in Perfetto / chrome://tracing).

    Complete events ("ph": "X") with microsecond timestamps relative to
    run start; obs thread ordinals become trace tids. A merged multi-host
    manifest (``obs merge``) renders one LANE (trace pid) per host —
    pid = host + 1, each with its own process_name metadata row — so the
    per-host subtrees sit side by side on the shared run clock; the
    synthetic run root stays on pid 1 alongside host 0.
    """
    merged = bool(doc.get("merged"))
    events = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": f"{doc['name']} ({doc['run_id']})"}},
    ]
    if merged:
        for hr in doc.get("hosts") or []:
            h = hr.get("host", 0)
            if h == 0:
                continue  # host 0 shares pid 1 with the run root's row
            events.append({
                "ph": "M", "name": "process_name", "pid": h + 1, "tid": 0,
                "args": {"name": f"host{h} · {doc['name']} "
                                 f"({doc['run_id']})"}})
    for row in doc["spans"]:
        if row.get("dur_s") is None:
            continue
        pid = (int(row.get("host", 0)) + 1) if merged else 1
        events.append({
            "ph": "X", "pid": pid, "tid": row["thread"],
            "name": row["name"], "cat": row["kind"],
            "ts": round(row["t0_s"] * 1e6, 1),
            "dur": round(row["dur_s"] * 1e6, 1),
            "args": row.get("attrs") or {},
        })
    for name, val in sorted((doc.get("counters") or {}).items()):
        events.append({"ph": "C", "pid": 1, "tid": 0, "name": name,
                       "ts": round(doc["wall_s"] * 1e6, 1),
                       "args": {"value": val}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _prom_label(val: str) -> str:
    return str(val).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _prom_num(val) -> str:
    """A sample value in exposition-format 0.0.4 spelling.

    Python's ``nan``/``inf`` reprs are unparseable to Prometheus — the
    format wants ``NaN``/``+Inf``/``-Inf``. Finite values keep their
    native rendering (ints stay ``3``, not ``3.0``). A non-numeric value
    (a partial/hand-edited manifest) becomes NaN rather than a line the
    scraper rejects wholesale.
    """
    try:
        num = float(val)
    except (TypeError, ValueError):
        return "NaN"
    if math.isnan(num):
        return "NaN"
    if math.isinf(num):
        return "+Inf" if num > 0 else "-Inf"
    return str(val)


def prometheus(doc: dict) -> str:
    """Prometheus text exposition (format 0.0.4) for one manifest.

    Every series carries a ``host`` label: the writing process index for
    a per-host manifest (0 on single-host runs), or the source host for
    a merged multi-host document — whose wall/counter/gauge series are
    emitted once per host from ``hosts[]`` (the aggregate is one PromQL
    ``sum()``/``max()`` away, and emitting both would double-count) and
    whose span series follow each span row's ``host`` field.
    """
    run = _prom_label(doc["run_id"])
    merged = bool(doc.get("merged")) and isinstance(doc.get("hosts"), list)
    host0 = doc["host"] if isinstance(doc.get("host"), int) else 0
    sources = ([(hr.get("host", i), hr) for i, hr in enumerate(doc["hosts"])]
               if merged else [(host0, doc)])
    lines = [
        "# HELP crimp_tpu_run_wall_seconds total wall time of the run",
        "# TYPE crimp_tpu_run_wall_seconds gauge",
    ]
    for h, src in sources:
        lines.append(f'crimp_tpu_run_wall_seconds{{run="{run}",host="{h}"}} '
                     f'{_prom_num(src["wall_s"])}')
    lines += [
        "# HELP crimp_tpu_counter_total run counters (events folded, ToAs fit, cache hits, ...)",
        "# TYPE crimp_tpu_counter_total counter",
    ]
    for h, src in sources:
        for name, val in sorted((src.get("counters") or {}).items()):
            lines.append(
                f'crimp_tpu_counter_total{{run="{run}",host="{h}",'
                f'name="{_prom_label(name)}"}} {_prom_num(val)}')
    lines += [
        "# HELP crimp_tpu_gauge run gauges (padding waste, device counts, ...)",
        "# TYPE crimp_tpu_gauge gauge",
    ]
    for h, src in sources:
        for name, val in sorted((src.get("gauges") or {}).items()):
            lines.append(
                f'crimp_tpu_gauge{{run="{run}",host="{h}",'
                f'name="{_prom_label(name)}"}} {_prom_num(val)}')
    lines += [
        "# HELP crimp_tpu_span_seconds total seconds per span path",
        "# TYPE crimp_tpu_span_seconds gauge",
        "# HELP crimp_tpu_span_count spans recorded per span path",
        "# TYPE crimp_tpu_span_count gauge",
    ]
    rollup: dict[tuple[int, str], dict] = {}
    for path, row in zip(span_paths(doc), doc.get("spans") or []):
        dur = row.get("dur_s")
        if dur is None:
            continue
        h = int(row.get("host", host0)) if merged else host0
        agg = rollup.setdefault((h, path), {"sum_s": 0.0, "count": 0})
        agg["sum_s"] += float(dur)
        agg["count"] += 1
    for (h, path), agg in sorted(rollup.items()):
        label = f'run="{run}",host="{h}",path="{_prom_label(path)}"'
        lines.append(f"crimp_tpu_span_seconds{{{label}}} "
                     f"{_prom_num(round(agg['sum_s'], 6))}")
        lines.append(f"crimp_tpu_span_count{{{label}}} {_prom_num(agg['count'])}")
    return "\n".join(lines) + "\n"
