"""Kernel timing, compile counters and torch.profiler tracing.

Port of ``crimp_tpu/utils/profiling.py``:

- ``timed(name)`` times a block and records it as a ``kind="kernel"`` span
  of the active obs run (and in the per-process registry that
  ``kernel_times()`` reads, which keeps the latest ``KERNEL_TIMES_KEEP``
  timings a name). On the card the duration is device time: two CUDA
  events on the current stream, their elapsed time resolved lazily (when
  the enclosing stage span closes or the run ends), so the timed call gains
  no synchronization. The host time of an asynchronous launch would read
  microseconds for a kernel that runs for milliseconds. When the block
  launches a hand kernel, whose wrapper marks its launch with
  ``launch_window()``, the events bracket the launches themselves (the
  first one's start to the last one's end), not the wrapper's host work
  before them. On an idle card such a span still holds the launch latency.
  A roofline measurement that wants the kernel's device time alone asks
  for ``primed_launches()``; a plain obs run never primes, so the flight
  recorder adds no device work to the timeline it records. Off the card it
  is host wall time. A raising body still records its measurement, with an
  ``error`` attribute on the span.
- ``compile_counters()``: what the port compiled, in place of JAX's
  compilation-cache listeners: the nvcc builds (``ops/z2_grid.BUILD_INFO``)
  and the CUDA-graph captures of the MCMC (``ops/mcmc.py``).
- ``trace(dir)``: a ``torch.profiler`` context writing a Chrome trace into
  ``dir`` (or CRIMP_TORCH_TRACE_DIR); a no-op without a directory.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import numpy as np
import torch

from crimp_tpu_torch import knobs, obs
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# timings kept per name: a long-lived engine or survey with obs on keeps
# timing kernels, and the registry must not grow with it
KERNEL_TIMES_KEEP = 1024
# name -> the latest durations (seconds), or (start, end) CUDA-event pairs
# until read
_KERNEL_TIMES: dict[str, collections.deque] = {}
_TIMES_LOCK = threading.Lock()
# CUDA-graph captures (ops/mcmc.py counts each one here)
_GRAPH_CAPTURES = {"count": 0, "seconds": 0.0}
# the open timed() block's launch events on this thread: {"start", "end",
# "primed"}; and whether primed_launches() is open on this thread
_LAUNCH = threading.local()
_PRIMED = threading.local()


def force(result):
    """Materialize a tensor (or a dict/tuple/list of them) on the host as
    numpy; anything else passes through."""
    if isinstance(result, dict):
        return {k: force(v) for k, v in result.items()}
    if isinstance(result, tuple) and hasattr(result, "_fields"):
        return type(result)(*(force(v) for v in result))
    if isinstance(result, (list, tuple)):
        return type(result)(force(v) for v in result)
    if isinstance(result, torch.Tensor):
        return result.detach().cpu().numpy()
    try:
        return np.asarray(result)
    except TypeError:
        return result


def _card_stream_live() -> bool:
    """Whether the card is up, so a CUDA event can time the block (timing
    never brings the card up itself)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def timed(name: str, sync=None):
    """Time a block as a kernel span; ``sync`` (a callable or a value) is
    forced to the host at exit, inside the timed window.

    On the card the span's duration is the device time between two CUDA
    events recorded on the current stream around the block; elsewhere it is
    host wall time."""
    events = slot = outer = None
    if _card_stream_live():
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record()
        outer, slot = getattr(_LAUNCH, "slot", None), {"start": None, "end": None, "primed": False}
        _LAUNCH.slot = slot
    t0 = time.perf_counter()
    error = None
    try:
        yield
        if sync is not None:
            force(sync() if callable(sync) else sync)
    except BaseException as exc:
        error = f"{type(exc).__name__}: {exc}"
        raise
    finally:
        attrs = {} if error is None else {"error": error}
        if events is not None:
            events[1].record()
            _LAUNCH.slot = outer
            if slot["start"] is not None:
                events = (slot["start"], slot["end"])
            if slot["primed"]:
                attrs["primed"] = True
            _keep(name, events)
            obs.record_device_span(name, *events, kind="kernel", **attrs)
        else:
            dt = time.perf_counter() - t0
            _keep(name, dt)
            obs.record_span(name, dt, kind="kernel", **attrs)
        if error is not None:
            logger.warning("[timing] %s failed: %s", name, error)


def _keep(name: str, entry) -> None:
    with _TIMES_LOCK:
        _KERNEL_TIMES.setdefault(name, collections.deque(maxlen=KERNEL_TIMES_KEEP)).append(entry)


# GPU cycles of the spin kernel queued before a primed launch's start event
# (about 1 ms at 1980 MHz): more than the host takes to record the event and
# launch the kernel, so the event is stamped when the kernel can start. It
# must hold after the host has idled for milliseconds, as between an
# engine's delta folds: there a 100 000-cycle spin ran out first and K4's
# spans read 0.0443-2.83 ms against 0.0440-0.0456 ms with this one
# (utils/k4_prime_ab.py, NVIDIA H100 80GB HBM3, 700.00 W)
PRIME_CYCLES = 2_000_000


@contextlib.contextmanager
def primed_launches():
    """Within the block, on this thread, every hand-kernel launch inside a
    ``timed`` block is primed: a spin kernel of about a millisecond
    (``PRIME_CYCLES``, a private torch call) queued before the span's start
    event keeps the card busy while the host records the event and
    launches, so the span is the
    kernel's own device time, without the launch latency an idle card adds
    to it (most of the span of a kernel as short as K4). Its span carries
    ``primed=True`` and ``obs roofline`` says so on the row. For roofline
    measurements only: the spin is device time the block adds to the
    timeline, so a plain obs run never primes."""
    outer = getattr(_PRIMED, "on", False)
    _PRIMED.on = True
    try:
        yield
    finally:
        _PRIMED.on = outer


@contextlib.contextmanager
def launch_window():
    """Mark a hand kernel's launch (its wrapper wraps the C call): inside a
    ``timed`` block on this thread, CUDA events around the launch become the
    block's span bounds; free otherwise. Under ``primed_launches()`` a spin
    kernel goes ahead of the start event."""
    slot = getattr(_LAUNCH, "slot", None)
    if slot is None:
        yield
        return
    if getattr(_PRIMED, "on", False):
        torch.cuda._sleep(PRIME_CYCLES)
        slot["primed"] = True
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    if slot["start"] is None:
        slot["start"] = start
    slot["end"] = end


def _seconds(entry) -> float:
    if isinstance(entry, tuple):
        entry[1].synchronize()
        return entry[0].elapsed_time(entry[1]) / 1e3
    return float(entry)


def kernel_times() -> dict[str, list[float]]:
    """The recorded block timings of this process, the latest
    ``KERNEL_TIMES_KEEP`` a name (name -> seconds); reading waits for the
    card to finish the timed blocks."""
    with _TIMES_LOCK:
        snap = {k: list(v) for k, v in _KERNEL_TIMES.items()}
    return {k: [_seconds(e) for e in v] for k, v in snap.items()}


def reset_kernel_times() -> None:
    with _TIMES_LOCK:
        _KERNEL_TIMES.clear()


def count_graph_capture(seconds: float) -> None:
    """Count one CUDA-graph capture (ops/mcmc.py) and its host seconds."""
    with _TIMES_LOCK:
        _GRAPH_CAPTURES["count"] += 1
        _GRAPH_CAPTURES["seconds"] += float(seconds)


def compile_counters() -> dict:
    """What the port compiled in this process: nvcc builds run and reused
    (``z2_grid.BUILD_INFO``) with the build's wall seconds, and CUDA-graph
    captures with their seconds."""
    from crimp_tpu_torch.ops import z2_grid

    with _TIMES_LOCK:
        graphs = dict(_GRAPH_CAPTURES)
    return {
        "nvcc_builds": int(z2_grid.BUILD_INFO.get("built", 0)),
        "nvcc_reused": int(z2_grid.BUILD_INFO.get("reused", 0)),
        "nvcc_build_s": round(float(z2_grid.BUILD_INFO.get("seconds", 0.0)), 4),
        "graph_captures": int(graphs["count"]),
        "graph_capture_s": round(graphs["seconds"], 4),
    }


def reset_compile_counters() -> None:
    with _TIMES_LOCK:
        _GRAPH_CAPTURES.update(count=0, seconds=0.0)


@contextlib.contextmanager
def trace(trace_dir: str | None = None):
    """``torch.profiler`` over the block (CPU and, with a card, CUDA
    activity), its Chrome trace written to ``trace_dir`` (else
    CRIMP_TORCH_TRACE_DIR) on exit; a no-op without a directory. Yields the
    profiler (None when off) so a caller can read ``key_averages()``."""
    target = trace_dir or knobs.env_str("CRIMP_TORCH_TRACE_DIR")
    if not target:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    with profile(activities=activities, acc_events=True) as prof:
        logger.info("[timing] torch.profiler trace -> %s", target)
        yield prof
    prof.export_chrome_trace(os.path.join(target, f"trace_{os.getpid()}_{int(time.time())}.json"))
