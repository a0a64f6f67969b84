"""Spans + metrics core and the flight recorder.

Port of ``crimp_tpu/obs/core.py``; the manifest and the JSONL event stream
keep the JAX package's schema (``OBS_SCHEMA``), so one reporter reads both.

- **Disabled is free.** With ``CRIMP_TORCH_OBS`` off there is no active
  :class:`RunRecorder`; :func:`span` returns the shared :data:`NULL_SPAN`
  singleton after a module-global ``None`` check and one check of the
  profiler's flag, and :func:`counter_add`/:func:`gauge_set`/:func:`record_span`
  return after the ``None`` check alone.
- **Profiler ranges.** While ``torch.profiler`` records, every span (and
  every kernel span, ``costmodel.kernel_span``) is also a range of the
  profiler's timeline under the span's name, run or no run
  (:func:`profiler_range`), so a device trace names the host work around
  each idle gap on the trace's own clock. The range is the profiler's
  light record (``_RecordFunctionFast``): ``record_function`` would also
  put a copy of each range on the device's timeline, covering the range's
  first to last kernel, which a trace reader would count as device work.
- **Thread-safe.** Registry mutation happens under one re-entrant lock and
  span parentage is tracked per thread.
- **Crash-durable.** With events on, every span open/close, counter, gauge
  and heartbeat is appended (and flushed) to a JSONL stream; the manifest
  is written atomically (tmp + rename) at run end.
- **Device time in spans.** When a run is active and the card is already
  initialized, a span synchronizes the card as it opens and closes, so its
  duration covers the device work queued inside it; not while the profiler
  records, whose trace must show the idle time an unprofiled run has.
  Disabled, nothing synchronizes. Telemetry never initializes the card:
  identity and memory statistics come only from a card some other code
  already brought up.
- **Kernel spans in device time.** ``utils/profiling.timed`` brackets a
  kernel call on the card with two CUDA events and hands them over with
  :func:`record_device_span`; the span's duration is the events' elapsed
  time, read lazily when the enclosing stage span closes (which
  synchronizes anyway) or the run ends, so the kernel call itself gains no
  synchronization.
- **Cost rows.** :func:`record_cost` attaches one cost-model row per kernel
  name (``obs/costmodel.py``) to the manifest's ``costmodel`` table, which
  ``obs roofline`` joins against the kernel spans.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import threading
import time

import torch

from crimp_tpu_torch import knobs

logger = logging.getLogger("crimp_tpu_torch.obs")

OBS_SCHEMA = "crimp_tpu.obs"
OBS_SCHEMA_VERSION = 1

_LOCK = threading.RLock()
_RUN: "RunRecorder | None" = None
_LAST_MANIFEST: str | None = None
_RUN_SEQ = 0
_TLS = threading.local()


class _NullSpan:
    """The disabled-path span: a shared, stateless no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()

# the profiler's flag, read once a span: true while torch.profiler records
_profiler_on = torch.autograd._profiler_enabled
# the profiler's light range: a host event alone, no copy on the device's timeline
_record_function = torch._C._profiler._RecordFunctionFast


class _Range:
    """A profiler range alone (no clock, no synchronize, no attributes
    kept): a span while the profiler records and no run is active."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = _record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False

    def set(self, **attrs):
        return self


def profiler_range(name: str):
    """A profiler range named ``name`` while ``torch.profiler`` records, the
    shared no-op :data:`NULL_SPAN` otherwise."""
    return _Range(name) if _profiler_on() else NULL_SPAN


def _host_identity() -> tuple[int, int]:
    """``(host_index, host_count)`` for per-host artifact suffixing.

    ``CRIMP_TORCH_OBS_HOST`` overrides (its host count is only the lower
    bound ``max(2, idx + 1)``, enough to engage the suffix); otherwise the
    rank and world size of an initialized ``torch.distributed`` group."""
    idx = knobs.env_nonneg_int("CRIMP_TORCH_OBS_HOST")
    if idx is not None:
        return idx, max(2, idx + 1)
    from crimp_tpu_torch.parallel.multihost import process_identity

    return process_identity()


def _card_live() -> bool:
    """Whether some other code already brought the card up."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _sync() -> None:
    if _card_live():
        torch.cuda.synchronize()


def enabled() -> bool:
    """Whether ``CRIMP_TORCH_OBS`` asks for telemetry (malformed raises)."""
    return bool(knobs.env_onoff("CRIMP_TORCH_OBS"))


def active() -> "RunRecorder | None":
    """The in-flight run recorder, or None (the common, disabled case)."""
    return _RUN


def last_manifest_path() -> str | None:
    """Path of the most recently finalized manifest in this process."""
    return _LAST_MANIFEST


def _stack() -> list:
    try:
        return _TLS.stack
    except AttributeError:
        _TLS.stack = []
        return _TLS.stack


class Span:
    """A live hierarchical span; records on ``__exit__``.

    Parentage comes from the per-thread span stack, falling back to the run
    root. Construction reserves the span's slot in the recorder so children
    opened before the parent closes still point at a real index.
    """

    __slots__ = ("_rec", "_row", "_t0", "_range", "index")

    def __init__(self, rec: "RunRecorder", name: str, kind: str, attrs: dict):
        self._range = profiler_range(name)
        if self._range is NULL_SPAN:
            _sync()
        stack = _stack()
        parent = stack[-1] if stack else 0
        self._rec = rec
        self._t0 = time.perf_counter()
        self._row = {
            "name": str(name),
            "kind": str(kind),
            "t0_s": round(self._t0 - rec.t0, 6),
            "dur_s": None,
            "parent": parent,
            "thread": rec._thread_ordinal(),
            "attrs": dict(attrs),
        }
        if kind == "stage":
            stats = _hbm_stats()
            if stats and isinstance(stats.get("bytes_in_use"), (int, float)):
                self._row["attrs"]["hbm_enter_bytes"] = stats["bytes_in_use"]
        with _LOCK:
            self.index = len(rec.spans)
            rec.spans.append(self._row)
        stack.append(self.index)
        rec._emit({"ev": "span_open", "i": self.index,
                   **{k: self._row[k] for k in ("name", "kind", "t0_s", "parent", "thread")}})
        self._range.__enter__()

    def set(self, **attrs):
        """Attach attributes to the span while it is open."""
        self._row["attrs"].update(attrs)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self._range.__exit__(exc_type, exc, tb)
        if exc_type is None:
            if self._range is NULL_SPAN:
                _sync()
            self._rec._resolve_device_spans()
        dur = time.perf_counter() - self._t0
        stack = _stack()
        if stack and stack[-1] == self.index:
            stack.pop()
        elif self.index in stack:  # unbalanced exit (generator teardown)
            stack.remove(self.index)
        self._row["dur_s"] = round(dur, 6)
        if exc_type is not None:
            self._row["attrs"]["error"] = f"{exc_type.__name__}: {exc}"
        if self._row["kind"] == "stage":
            stats = _hbm_stats()
            if stats:
                if isinstance(stats.get("bytes_in_use"), (int, float)):
                    self._row["attrs"]["hbm_exit_bytes"] = stats["bytes_in_use"]
                if isinstance(stats.get("peak_bytes_in_use"), (int, float)):
                    self._row["attrs"]["hbm_peak_bytes"] = stats["peak_bytes_in_use"]
                self._rec._hbm_update(stats)
        self._rec._emit({"ev": "span", "i": self.index, **self._row})
        return False


class RunRecorder:
    """Accumulates one run's spans/counters/gauges; writes the artifacts.

    Span 0 is always the run root. ``finalize()`` closes the root span,
    gathers the knob snapshot and platform identity and atomically writes
    the manifest.
    """

    def __init__(self, name: str, attrs: dict):
        global _RUN_SEQ
        with _LOCK:
            _RUN_SEQ += 1
            seq = _RUN_SEQ
        self.name = str(name)
        self.t0 = time.perf_counter()
        self.t0_unix = time.time()
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(self.t0_unix))
        self.host, self.hosts = _host_identity()
        if self.hosts > 1:
            # host-invariant run id, so the per-host streams can be joined
            self.run_id = f"{self.name}-{stamp}-mh-r{seq}"
        else:
            self.run_id = f"{self.name}-{stamp}-p{os.getpid()}-r{seq}"
        self.host_tag = f".host{self.host}" if self.hosts > 1 else ""
        self.dir = knobs.env_str("CRIMP_TORCH_OBS_DIR", "obs_runs")
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.numeric_mode: dict | None = None
        self.error: str | None = None
        self.degraded: list[str] = []
        self.costmodel: dict[str, dict] = {}
        self._device_spans: list[tuple[int, object, object]] = []  # (span index, start, end)
        self.spans: list[dict] = [{
            "name": self.name, "kind": "run", "t0_s": 0.0, "dur_s": None,
            "parent": None, "thread": 0, "attrs": dict(attrs),
        }]
        self._threads: dict[int, int] = {threading.get_ident(): 0}
        self._events = None
        self.hb = None  # lazy per-run heartbeat state (obs/heartbeat.py)
        self.hbm_start = _hbm_stats()  # None on the CPU
        self._hbm_warned = False
        try:
            os.makedirs(self.dir, exist_ok=True)
            if knobs.env_onoff("CRIMP_TORCH_OBS_EVENTS") is not False:
                path = os.path.join(self.dir, self.run_id + self.host_tag + ".events.jsonl")
                self._events = open(path, "a", encoding="utf-8")
        except OSError:
            # a read-only or full obs dir just means no events stream
            self._note_write_error("events open")
        self._emit({"ev": "run_start", "schema": OBS_SCHEMA,
                    "schema_version": OBS_SCHEMA_VERSION,
                    "run_id": self.run_id, "name": self.name,
                    "host": self.host, "host_count": self.hosts,
                    "t_start_unix": round(self.t0_unix, 3),
                    "knobs": _knob_snapshot(),
                    "attrs": dict(attrs)})

    def _thread_ordinal(self) -> int:
        ident = threading.get_ident()
        with _LOCK:
            return self._threads.setdefault(ident, len(self._threads))

    def _note_write_error(self, where: str) -> None:
        """Record a telemetry write failure and stop writing for the run."""
        with _LOCK:
            if self._events is not None:
                try:
                    self._events.close()
                except OSError:
                    pass
                self._events = None
            self.counters["telemetry_write_errors"] = self.counters.get("telemetry_write_errors", 0) + 1
        logger.warning("obs %s write failed (ENOSPC/read-only?); further telemetry writes "
                       "disabled for run %s", where, self.run_id)

    def _emit(self, event: dict) -> None:
        if self._events is None:
            return
        with _LOCK:
            if self._events is None:  # closed by finalize on another thread
                return
            event.setdefault("t_s", round(time.perf_counter() - self.t0, 6))
            try:
                json.dump(event, self._events, default=str)
                self._events.write("\n")
                self._events.flush()
            except OSError:
                self._note_write_error("events")

    def _resolve_device_spans(self, wait: bool = False) -> None:
        """Fill the durations of kernel spans timed by CUDA events whose end
        event has completed (all of them with ``wait``, which waits for
        each end event on its own card), and emit their span events."""
        with _LOCK:
            pending, self._device_spans = self._device_spans, []
        later = []
        for idx, start, end in pending:
            if wait:
                end.synchronize()  # the end's own card (a span may cover several)
            elif not end.query():
                later.append((idx, start, end))
                continue
            row = self.spans[idx]
            row["dur_s"] = round(start.elapsed_time(end) / 1e3, 6)
            self._emit({"ev": "span", "i": idx, **row})
        if later:
            with _LOCK:
                self._device_spans[:0] = later

    def manifest(self) -> dict:
        """The manifest document (the JAX package's schema)."""
        return {
            "schema": OBS_SCHEMA,
            "schema_version": OBS_SCHEMA_VERSION,
            "run_id": self.run_id,
            "name": self.name,
            "host": self.host,
            "host_count": self.hosts,
            "t_start_unix": round(self.t0_unix, 3),
            "wall_s": self.spans[0]["dur_s"],
            "error": self.error,
            "degraded": bool(self.degraded),
            "degradations": list(self.degraded),
            "platform": _platform_identity(),
            "knobs": _knob_snapshot(),
            "numeric_mode": self.numeric_mode,
            "compile": _compile_snapshot(),
            "costmodel": dict(self.costmodel),
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "spans": list(self.spans),
        }

    def _hbm_update(self, stats: dict) -> None:
        """Fold one device memory sample into the run's HBM gauges; warns
        once per run when the peak passes CRIMP_TORCH_HBM_WARN_PCT (default
        90; 0 disables) percent of the card's memory."""
        in_use = stats.get("bytes_in_use")
        peak = stats.get("peak_bytes_in_use", in_use)
        limit = stats.get("bytes_limit")
        with _LOCK:
            if isinstance(in_use, (int, float)):
                self.gauges["hbm_bytes_in_use"] = in_use
            if isinstance(peak, (int, float)):
                self.gauges["hbm_peak_bytes"] = max(self.gauges.get("hbm_peak_bytes", 0), peak)
        if (not self._hbm_warned and isinstance(peak, (int, float))
                and isinstance(limit, (int, float)) and limit > 0):
            warn_pct = knobs.env_float("CRIMP_TORCH_HBM_WARN_PCT", 90.0)
            pct = 100.0 * peak / limit
            if warn_pct > 0 and pct >= warn_pct:
                self._hbm_warned = True
                with _LOCK:
                    self.counters["hbm_warn_trips"] = self.counters.get("hbm_warn_trips", 0) + 1
                logger.warning("HBM high water %.1f%% of the card's memory (%d / %d bytes), above "
                               "CRIMP_TORCH_HBM_WARN_PCT=%g", pct, peak, limit, warn_pct)
                self._emit({"ev": "ctr", "k": "hbm_warn_trips", "v": 1})

    def finalize(self) -> str | None:
        """Close the root span, write the manifest atomically, return its
        path; None (and a log line) when the obs dir rejects the write."""
        end = _hbm_stats()
        if end and isinstance(end.get("bytes_in_use"), (int, float)):
            with _LOCK:
                self.gauges["hbm_run_end_bytes"] = end["bytes_in_use"]
                start = (self.hbm_start or {}).get("bytes_in_use")
                if isinstance(start, (int, float)):
                    self.gauges["hbm_leak_bytes"] = end["bytes_in_use"] - start
            self._emit({"ev": "gauge", "k": "hbm_run_end_bytes", "v": end["bytes_in_use"]})
        self._resolve_device_spans(wait=True)
        with _LOCK:
            if self.spans[0]["dur_s"] is None:
                self.spans[0]["dur_s"] = round(time.perf_counter() - self.t0, 6)
            doc = self.manifest()
            path = os.path.join(self.dir, self.run_id + self.host_tag + ".manifest.json")
            tmp = path + ".tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump(doc, fh, indent=1, sort_keys=False, default=str)
                    fh.write("\n")
                os.replace(tmp, path)
            except OSError:
                self._note_write_error("manifest")
                return None
            if self._events is not None:
                self._emit({"ev": "run_end", "run_id": self.run_id,
                            "wall_s": self.spans[0]["dur_s"], "manifest": path, "error": self.error})
                if self._events is not None:
                    try:
                        self._events.close()
                    except OSError:
                        pass
                    self._events = None
        return path


def _knob_snapshot() -> dict[str, str]:
    """Raw env values of every *set* registered knob (missing key = unset)."""
    snap = {}
    for name in sorted(knobs.REGISTRY):
        val = knobs.raw(name)
        if val:
            snap[name] = val
    return snap


def _platform_identity() -> dict:
    """Backend and card identity, from a card already brought up only."""
    out = {"python": sys.version.split()[0], "torch": torch.__version__,
           "backend": None, "devices": []}
    if not _card_live():
        return out
    out["backend"] = "cuda"
    out["cuda"] = torch.version.cuda
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out["devices"].append({"id": i, "platform": "gpu", "kind": props.name,
                               "bytes_in_use": torch.cuda.memory_allocated(i),
                               "bytes_limit": props.total_memory})
    return out


def _compile_snapshot() -> dict | None:
    """What the port compiled so far (nvcc builds, CUDA-graph captures),
    from ``utils/profiling.compile_counters``."""
    from crimp_tpu_torch.utils import profiling

    return profiling.compile_counters()


def _hbm_stats() -> dict | None:
    """One ``torch.cuda.memory_stats`` sample of the current card, or None
    when no card has been brought up (CPU runs have no HBM gauges)."""
    if not _card_live():
        return None
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory}


@contextlib.contextmanager
def run(name: str, **attrs):
    """Flight-record a pipeline entry point.

    No-op (yields None) when obs is disabled. When a run is already active,
    the inner entry point becomes a ``kind="run"`` span of the outer run.
    Otherwise starts a RunRecorder and, on exit, error or not, finalizes it
    into an atomic manifest.
    """
    global _RUN, _LAST_MANIFEST
    if not enabled():
        yield None
        return
    with _LOCK:
        outer = _RUN
        if outer is None:
            rec = RunRecorder(name, attrs)
            _RUN = rec
    if outer is not None:
        with Span(outer, name, "run", attrs) as s:
            yield s
        return
    try:
        yield rec
    except BaseException as exc:
        rec.error = f"{type(exc).__name__}: {exc}"
        raise
    finally:
        with _LOCK:
            _RUN = None
        _stack().clear()
        manifest = rec.finalize()
        with _LOCK:
            _LAST_MANIFEST = manifest


def span(name: str, kind: str = "stage", **attrs):
    """A hierarchical span context; with no run active, a profiler range
    while the profiler records and the shared no-op otherwise."""
    rec = _RUN
    if rec is None:
        return profiler_range(name)
    return Span(rec, name, kind, attrs)


def record_span(name: str, dur_s: float, kind: str = "kernel", **attrs) -> None:
    """Record an already-timed interval, parented to the calling thread's
    innermost open span and back-dated so ``t0_s + dur_s`` lands at now."""
    rec = _RUN
    if rec is None:
        return
    stack = _stack()
    row = {
        "name": str(name), "kind": str(kind),
        "t0_s": round(max(0.0, time.perf_counter() - rec.t0 - dur_s), 6),
        "dur_s": round(float(dur_s), 6),
        "parent": stack[-1] if stack else 0,
        "thread": rec._thread_ordinal(),
        "attrs": dict(attrs),
    }
    with _LOCK:
        idx = len(rec.spans)
        rec.spans.append(row)
    rec._emit({"ev": "span", "i": idx, **row})


def record_device_span(name: str, start, end, kind: str = "kernel", **attrs) -> None:
    """Record a span timed on the card by two recorded CUDA events; its
    duration is filled in lazily (``RunRecorder._resolve_device_spans``),
    never by synchronizing here. No-op when no run is active."""
    rec = _RUN
    if rec is None:
        return
    stack = _stack()
    row = {
        "name": str(name), "kind": str(kind),
        "t0_s": round(time.perf_counter() - rec.t0, 6),
        "dur_s": None,
        "parent": stack[-1] if stack else 0,
        "thread": rec._thread_ordinal(),
        "attrs": dict(attrs),
    }
    with _LOCK:
        idx = len(rec.spans)
        rec.spans.append(row)
        rec._device_spans.append((idx, start, end))


def record_cost(name: str, row: dict) -> None:
    """Attach one cost-model row to the active run (no-op when none).

    Keyed by kernel name, the name its span carries, so the roofline join
    is a dict lookup. Last capture wins."""
    rec = _RUN
    if rec is None:
        return
    with _LOCK:
        rec.costmodel[str(name)] = dict(row)
    rec._emit({"ev": "cost", "k": str(name), "row": dict(row)})


def current_span_name(default: str | None = None) -> str | None:
    """Leaf name of the calling thread's innermost open span (the run root
    when none is open on this thread); ``default`` when no run is active."""
    rec = _RUN
    if rec is None:
        return default
    stack = _stack()
    idx = stack[-1] if stack else 0
    try:
        return rec.spans[idx]["name"]
    except (IndexError, KeyError):
        return default


def counter_add(name: str, value: float = 1) -> None:
    """Add to a monotonic counter of the active run (no-op when none)."""
    rec = _RUN
    if rec is None:
        return
    with _LOCK:
        rec.counters[name] = rec.counters.get(name, 0) + value
    rec._emit({"ev": "ctr", "k": str(name), "v": value})


def gauge_set(name: str, value: float) -> None:
    """Set a point-in-time gauge of the active run (no-op when none)."""
    rec = _RUN
    if rec is None:
        return
    with _LOCK:
        rec.gauges[name] = value
    rec._emit({"ev": "gauge", "k": str(name), "v": value})


def mark_degraded(reason: str) -> None:
    """Stamp the active run degraded (a ladder rung was taken); no-op when
    no run is active."""
    rec = _RUN
    if rec is None:
        return
    with _LOCK:
        rec.degraded.append(str(reason))
    rec._emit({"ev": "degraded", "reason": str(reason)})


def record_numeric_mode(mode: dict) -> None:
    """Attach a numeric-mode fingerprint to the run."""
    rec = _RUN
    if rec is None:
        return
    with _LOCK:
        rec.numeric_mode = json.loads(json.dumps(mode, default=str))
    rec._emit({"ev": "numeric_mode", "mode": rec.numeric_mode})
