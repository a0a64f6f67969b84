"""Live progress heartbeats: periodic events + an atomic ETA sidecar.

Port of ``crimp_tpu/obs/heartbeat.py``. Instrumented loops report
``(done, total)`` progress with :func:`beat`; at most once per
``CRIMP_TORCH_OBS_HEARTBEAT_S`` seconds (default 30) the active run appends
a ``heartbeat`` event to its JSONL stream and atomically rewrites a small
``<run_id>.heartbeat.json`` sidecar with the progress fraction, observed
rate, ETA, the calling thread's deepest open span path and the backend.

- **Disabled is free.** With no active run, :func:`beat` returns after the
  same single ``None`` check as the other obs hooks.
  ``CRIMP_TORCH_OBS_HEARTBEAT_S=0`` (or ``off``) disables heartbeats even
  when obs is on.
- **Monotonic-clock based.** Rates and ETAs come from
  ``time.perf_counter()`` deltas against the run's own ``t0``.
- **Rate from observed work only.** The first beat anchors the window.
"""

from __future__ import annotations

import json
import os
import threading
import time

from crimp_tpu_torch import knobs
from crimp_tpu_torch.obs import core

DEFAULT_PERIOD_S = 30.0


def period_s() -> float | None:
    """The heartbeat period, or None when disabled.

    Unset/blank means the 30 s default (heartbeats ride on the obs
    enable, they do not need their own opt-in); ``0``/``off`` disables;
    a positive float overrides; anything else raises (same typo
    discipline as every other knob — a malformed period must not
    silently pick a default).
    """
    env = knobs.raw("CRIMP_TORCH_OBS_HEARTBEAT_S")
    if not env:
        return DEFAULT_PERIOD_S
    if knobs.parse_onoff(env) is False:
        return None
    try:
        val = float(env)
    except ValueError:
        raise ValueError(
            f"CRIMP_TORCH_OBS_HEARTBEAT_S={env!r} is not a number") from None
    if not (0.0 < val < float("inf")):
        raise ValueError(
            f"CRIMP_TORCH_OBS_HEARTBEAT_S={env!r} out of range (expected > 0, "
            "or 0/off to disable)")
    return val


def _open_span_path(rec) -> str:
    """The calling thread's deepest open span, as a '/'-joined path."""
    stack = core._stack()
    idx = stack[-1] if stack else 0
    parts: list[str] = []
    with core._LOCK:
        while idx is not None and 0 <= idx < len(rec.spans):
            parts.append(rec.spans[idx]["name"])
            idx = rec.spans[idx]["parent"]
    return "/".join(reversed(parts)) or rec.name


def beat(done: float, total: float | None, label: str | None = None,
         force: bool = False) -> dict | None:
    """Report progress; emit a heartbeat if the period has elapsed.

    Returns the heartbeat document when one was emitted, else None.
    ``done``/``total`` are in whatever unit the caller is looping over
    (chunks, buckets, bench stages); ``force`` bypasses the rate limit
    for boundaries worth recording regardless (stage starts, final
    completion).
    """
    rec = core.active()
    if rec is None:
        return None
    now = time.perf_counter()
    with core._LOCK:
        hb = rec.hb
        if hb is None:
            hb = rec.hb = {
                "period": period_s(),
                # host_tag keeps co-located processes (multi-host jobs, or
                # CRIMP_TORCH_OBS_HOST-tagged launchers) from clobbering each
                # other's sidecar on a shared obs dir
                "path": os.path.join(
                    rec.dir,
                    rec.run_id + rec.host_tag + ".heartbeat.json"),
                "last": None,       # perf_counter of the last emission
                "label": None,      # rate window anchor: label at t_first
                "t_first": None,
                "done_first": None,
            }
        if hb["period"] is None:
            return None
        if hb["label"] != label or hb["t_first"] is None \
                or (hb["done_first"] is not None and done < hb["done_first"]):
            # New phase (or a caller restarting its count): re-anchor the
            # rate window so ETAs reflect this phase's observed rate only.
            hb["label"] = label
            hb["t_first"] = now
            hb["done_first"] = done
        if not force and hb["last"] is not None \
                and now - hb["last"] < hb["period"]:
            return None
        hb["last"] = now
        span_path = _open_span_path(rec)
    rate = None
    eta = None
    dt = now - hb["t_first"]
    dwork = done - hb["done_first"]
    if dt > 0 and dwork > 0:
        rate = dwork / dt
        if total is not None and total > done:
            eta = (total - done) / rate
    doc = {
        "run_id": rec.run_id,
        "name": rec.name,
        "host": rec.host,
        "t_s": round(now - rec.t0, 3),
        "t_unix": round(time.time(), 3),
        "label": label,
        "done": done,
        "total": total,
        "frac": round(done / total, 6) if total else None,
        "rate_per_s": round(rate, 6) if rate is not None else None,
        "eta_s": round(eta, 3) if eta is not None else None,
        "span": span_path,
        "backend": core._platform_identity()["backend"],
    }
    rec._emit({"ev": "heartbeat",
               **{k: doc[k] for k in ("t_s", "label", "done", "total",
                                      "frac", "rate_per_s", "eta_s",
                                      "span", "backend")}})
    if hb["path"] is not None:
        # per-thread tmp name: two threads beating concurrently must not
        # replace each other's tmp file out from under the open() — the
        # final os.replace is atomic either way, last writer wins
        tmp = hb["path"] + f".{threading.get_ident()}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, indent=1, default=str)
                fh.write("\n")
            os.replace(tmp, hb["path"])
        except OSError:
            # ENOSPC/read-only obs dir mid-scan: a heartbeat must never
            # kill the run. Stop writing the sidecar, keep computing.
            hb["path"] = None
            rec._note_write_error("heartbeat sidecar")
    return doc


def check_sidecar(target: str, max_age_s: float,
                  now_unix: float | None = None) -> tuple[bool, str, dict | None]:
    """Liveness-probe a heartbeat sidecar: ``(fresh, reason, doc)``.

    ``target`` is a ``*.heartbeat.json`` file or a run directory (the
    newest sidecar in it wins — the serving/liveness probe case where the
    prober knows the obs dir, not the run id).  Freshness compares the
    sidecar's wall-clock ``t_unix`` stamp against ``now_unix`` (default:
    ``time.time()``): fresh iff ``now - t_unix <= max_age_s``.

    Missing, torn (partially-written or unparseable — the atomic-rename
    contract makes this "should never happen", which is exactly why a
    probe must treat it as dead, not crash) and stale sidecars are all
    NOT-fresh outcomes with a reason, never exceptions: a liveness probe
    that errors out is indistinguishable from a dead service.
    """
    max_age_s = float(max_age_s)
    if not (max_age_s > 0):
        raise ValueError(
            f"max_age_s={max_age_s!r} out of range (expected > 0)")
    path = target
    if os.path.isdir(target):
        cands = sorted(
            (os.path.join(target, f) for f in os.listdir(target)
             if f.endswith(".heartbeat.json")),
            key=lambda p: os.path.getmtime(p))
        if not cands:
            return False, f"no *.heartbeat.json in {target}", None
        path = cands[-1]
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return False, f"missing: {path}", None
    except (OSError, ValueError) as exc:
        return False, f"torn/unreadable: {path} ({exc})", None
    t_unix = doc.get("t_unix") if isinstance(doc, dict) else None
    if not isinstance(t_unix, (int, float)):
        return False, f"torn: {path} has no t_unix stamp", doc \
            if isinstance(doc, dict) else None
    age = (time.time() if now_unix is None else float(now_unix)) - t_unix
    if age > max_age_s:
        return False, f"stale: last beat {age:.1f}s ago " \
                      f"(max {max_age_s:g}s)", doc
    return True, f"fresh: last beat {age:.1f}s ago", doc


def scan_progress(base: float = 0, total: float | None = None,
                  label: str | None = None, echo=None):
    """A ``progress(i, n)``-shaped callback that feeds :func:`beat`.

    ``base`` seats the count for resumable scans that restored chunks
    (the heartbeat's ``done`` covers the whole scan, its rate window only
    the work this process performed). Completion beats force through the
    rate limit so a finished scan always leaves a 100% heartbeat.
    ``echo`` chains the caller's own callback (a printed status line, the
    previous ad-hoc lambda) after the beat.
    """
    state = {"calls": 0}

    def progress(i, n):
        state["calls"] += 1
        done = base + state["calls"]
        full = total if total is not None else n
        beat(done, full, label=label, force=done >= full)
        if echo is not None:
            echo(i, n)

    return progress
