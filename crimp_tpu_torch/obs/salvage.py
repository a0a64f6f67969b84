"""Crash salvage + live tail: consuming the append-only event stream.

Port of ``crimp_tpu/obs/salvage.py``. The manifest is written atomically
at ``finalize()``: a run killed by SIGKILL, OOM or a time limit never
reaches it. But the JSONL event stream *is* flushed per event, so
everything up to the kill is on disk:
``salvage()`` replays it into a best-effort manifest (open spans closed
at the last event's timestamp, counters/gauges re-summed, the knob
snapshot recovered from ``run_start``) that passes ``validate_manifest``
and therefore feeds the same ``obs summary|diff`` tooling as a
clean run — just marked ``"salvaged": true`` so nobody mistakes its
lower-bound durations for measurements.

``tail()`` is the live view of the same stream: it follows the newest
``*.events.jsonl`` of a run directory, rendering heartbeats (progress,
rate, ETA, open span) and stage closes as they append, and exits when
``run_end`` arrives. Both entry points are wired into the obs CLI
(``python -m crimp_tpu_torch.obs salvage|tail``).
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time

from crimp_tpu_torch.obs.core import OBS_SCHEMA, OBS_SCHEMA_VERSION


def read_events(path: str) -> list[dict]:
    """Parse a JSONL event stream, tolerating a torn final line.

    A run killed mid-``write()`` can leave a truncated last record; every
    line that parses is kept, anything that does not is skipped (the
    stream is append-only, so damage can only be at the tail).
    """
    events: list[dict] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail (or mid-write garbage): best effort
            if isinstance(ev, dict):
                events.append(ev)
    return events


def _last_t(events: list[dict]) -> float:
    """The run-relative timestamp of the last stamped event."""
    t = 0.0
    for ev in events:
        ts = ev.get("t_s")
        if isinstance(ts, (int, float)):
            t = max(t, float(ts))
        # closed spans know their own end even without a stamp
        if ev.get("ev") == "span":
            t0, dur = ev.get("t0_s"), ev.get("dur_s")
            if isinstance(t0, (int, float)) and isinstance(dur, (int, float)):
                t = max(t, float(t0) + float(dur))
    return t


def salvage(events_path: str) -> dict:
    """Reconstruct a best-effort manifest document from an event stream.

    The result carries every field a finalized manifest does (it passes
    ``validate_manifest`` with zero problems) plus ``"salvaged": true``.
    Open spans — including the run root — are closed at the last event's
    timestamp, so their durations are lower bounds on the truth.
    """
    events = read_events(events_path)
    if not events:
        raise ValueError(f"{events_path}: no parseable events")
    start = next((e for e in events if e.get("ev") == "run_start"), None)
    if start is None:
        raise ValueError(f"{events_path}: no run_start event (not an obs "
                         "event stream?)")
    last_t = _last_t(events)
    run_id = start.get("run_id") or os.path.basename(events_path).replace(
        ".events.jsonl", "")
    name = start.get("name") or run_id
    spans: list[dict] = [{
        "name": name, "kind": "run", "t0_s": 0.0, "dur_s": None,
        "parent": None, "thread": 0, "attrs": dict(start.get("attrs") or {}),
    }]
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    costmodel: dict[str, dict] = {}
    numeric_mode = None
    error = None
    backend = None
    heartbeat = None
    ended = False

    def _seat(i: int) -> dict:
        # The span table is append-only and index-addressed; a gap can
        # only come from events lost at a torn tail, so pad with
        # explicitly-unknown rows rather than shifting indices.
        while len(spans) <= i:
            spans.append({"name": "?", "kind": "lost", "t0_s": last_t,
                          "dur_s": None, "parent": 0,
                          "thread": 0, "attrs": {}})
        return spans[i]

    for ev in events:
        kind = ev.get("ev")
        if kind == "span_open":
            i = ev.get("i")
            if isinstance(i, int) and i > 0:
                row = _seat(i)
                row.update({k: ev[k] for k in
                            ("name", "kind", "t0_s", "parent", "thread")
                            if k in ev})
        elif kind == "span":
            i = ev.get("i")
            if isinstance(i, int) and i >= 0:
                row = _seat(i)
                row.update({k: ev[k] for k in
                            ("name", "kind", "t0_s", "dur_s", "parent",
                             "thread", "attrs") if k in ev})
        elif kind == "ctr":
            k, v = ev.get("k"), ev.get("v")
            if isinstance(k, str) and isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        elif kind == "gauge":
            k, v = ev.get("k"), ev.get("v")
            if isinstance(k, str) and isinstance(v, (int, float)):
                gauges[k] = v
        elif kind == "cost":
            k, row = ev.get("k"), ev.get("row")
            if isinstance(k, str) and isinstance(row, dict):
                costmodel[k] = row  # last capture wins, like record_cost
        elif kind == "numeric_mode":
            if isinstance(ev.get("mode"), dict):
                numeric_mode = ev["mode"]
        elif kind == "heartbeat":
            heartbeat = {k: v for k, v in ev.items() if k != "ev"}
            if ev.get("backend"):
                backend = ev["backend"]
        elif kind == "run_end":
            ended = True
            if ev.get("error"):
                error = str(ev["error"])
            if isinstance(ev.get("wall_s"), (int, float)):
                spans[0]["dur_s"] = ev["wall_s"]
    for row in spans:
        if row["dur_s"] is None:
            row["dur_s"] = round(max(0.0, last_t - float(row["t0_s"])), 6)
    # Span 0's parent must be null and parents must precede children;
    # anything the stream got wrong gets clamped so the doc validates.
    spans[0]["parent"] = None
    for i, row in enumerate(spans[1:], start=1):
        p = row.get("parent")
        if not isinstance(p, int) or not (0 <= p < i):
            row["parent"] = 0
    doc_host = start.get("host")
    return {
        "schema": start.get("schema") or OBS_SCHEMA,
        "schema_version": start.get("schema_version") or OBS_SCHEMA_VERSION,
        "run_id": run_id,
        "name": name,
        # host identity survives salvage so `obs merge` can lane the
        # reconstruction like a finalized per-host manifest
        "host": doc_host if isinstance(doc_host, int) else 0,
        "host_count": start.get("host_count")
        if isinstance(start.get("host_count"), int) else 1,
        "t_start_unix": start.get("t_start_unix") or 0.0,
        "wall_s": spans[0]["dur_s"],
        "error": error,
        "platform": {"python": sys.version.split()[0], "backend": backend,
                     "devices": []},
        "knobs": dict(start.get("knobs") or {}),
        "numeric_mode": numeric_mode,
        "compile": None,
        "counters": counters,
        "gauges": gauges,
        "costmodel": costmodel,
        "spans": spans,
        "salvaged": not ended,
        "heartbeat": heartbeat,
    }


def salvage_file(events_path: str, out: str | None = None) -> str:
    """Salvage ``events_path`` and write the manifest atomically.

    Default output sits next to the stream as
    ``<run_id>.salvaged.manifest.json`` — deliberately NOT the
    ``.manifest.json`` name, so a salvage can never shadow (or be
    shadowed by) a finalize racing it.
    """
    doc = salvage(events_path)
    if out is None:
        base = events_path
        if base.endswith(".events.jsonl"):
            base = base[: -len(".events.jsonl")]
        out = base + ".salvaged.manifest.json"
    tmp = out + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=False, default=str)
        fh.write("\n")
    os.replace(tmp, out)
    return out


def resolve_events(target: str) -> str:
    """``target`` may be an events file or a run directory (newest wins)."""
    if os.path.isdir(target):
        streams = glob.glob(os.path.join(target, "*.events.jsonl"))
        if not streams:
            raise FileNotFoundError(f"{target}: no *.events.jsonl streams")
        return max(streams, key=os.path.getmtime)
    if not os.path.exists(target):
        raise FileNotFoundError(target)
    return target


def _fmt_hb(ev: dict) -> str:
    done, total = ev.get("done"), ev.get("total")
    frac = ev.get("frac")
    rate, eta = ev.get("rate_per_s"), ev.get("eta_s")
    bits = [f"[hb +{ev.get('t_s', 0):.0f}s]"]
    if done is not None:
        bits.append(f"{done}/{total if total is not None else '?'}")
    if frac is not None:
        bits.append(f"{100.0 * frac:.1f}%")
    if rate is not None:
        bits.append(f"{rate:.3g}/s")
    if eta is not None:
        bits.append(f"eta {eta:.0f}s")
    if ev.get("label"):
        bits.append(str(ev["label"]))
    if ev.get("span"):
        bits.append(f"span={ev['span']}")
    if ev.get("backend"):
        bits.append(f"backend={ev['backend']}")
    return "  ".join(bits)


def _render(ev: dict, out) -> bool:
    """Print one event's tail line; returns True when the run ended."""
    kind = ev.get("ev")
    if kind == "run_start":
        print(f"run {ev.get('run_id', '?')} started", file=out)
    elif kind == "heartbeat":
        print(_fmt_hb(ev), file=out)
    elif kind == "span" and ev.get("kind") in ("stage", "run"):
        dur = ev.get("dur_s")
        dur_txt = f"{dur:.3f}s" if isinstance(dur, (int, float)) else "?"
        print(f"[span] {ev.get('name', '?')} {dur_txt}", file=out)
    elif kind == "run_end":
        wall = ev.get("wall_s")
        wall_txt = f"{wall:.3f}s" if isinstance(wall, (int, float)) else "?"
        print(f"run ended  wall={wall_txt}  manifest={ev.get('manifest', '?')}"
              + (f"  ERROR: {ev['error']}" if ev.get("error") else ""),
              file=out)
        return True
    return False


def tail(target: str, follow: bool = True, interval: float = 2.0,
         max_seconds: float | None = None, out=None) -> int:
    """Follow a live event stream, rendering progress/ETA to ``out``.

    Renders existing content immediately; with ``follow`` keeps reading
    appended lines every ``interval`` seconds until ``run_end`` (exit 0)
    or ``max_seconds`` elapses without one (exit 1). ``follow=False``
    (the CLI's ``--once``) renders what is there and exits 0 if the run
    already ended, 1 if it is still (or forever) in flight.
    """
    out = out if out is not None else sys.stdout
    path = resolve_events(target)
    print(f"tailing {path}", file=out)
    t0 = time.monotonic()
    ended = False
    buf = ""
    with open(path, encoding="utf-8") as fh:
        while True:
            chunk = fh.read()
            if chunk:
                buf += chunk
                *lines, buf = buf.split("\n")
                for line in lines:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if _render(ev, out):
                        ended = True
            if ended:
                return 0
            if not follow:
                return 1
            if max_seconds is not None \
                    and time.monotonic() - t0 >= max_seconds:
                print("tail: gave up waiting for run_end", file=out)
                return 1
            time.sleep(interval)
