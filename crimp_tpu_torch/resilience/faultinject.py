"""Deterministic, off-by-default fault injector for chaos testing.

Port of ``crimp_tpu/resilience/faultinject.py``, with the same spec
grammar under ``CRIMP_TORCH_FAULTS``:
``"oom:fold_sources:2,corrupt:fold_cache:1"`` makes the named point raise
the named fault kind on exactly its N-th call (1-based); ``kind:point:n+``
fires on the n-th AND every later call. With the knob unset, ``fire()`` is
one knob read and an early return.

Fault points are a closed registry (``FAULT_POINTS``), limited to the
points whose modules the port has; a spec naming an unknown point or kind
raises ValueError at parse time. Call counting is per-process and
single-threaded by design: this is test instrumentation.
"""

from __future__ import annotations

from crimp_tpu_torch import knobs
from crimp_tpu_torch.resilience.taxonomy import (CacheCorruptError, DataError, FailureKind,
                                                 InjectedFault, NonfiniteResultError)

FAULT_POINTS = frozenset({
    "fold_sources",   # ops/multisource.py: stacked fold dispatch loop
    "fold_cache",     # ops/deltafold.py: disk cache load
    "harmonic_sums",  # ops/search.py: grid harmonic-sum dispatch
    "survey_bucket",  # pipelines/survey.py: batched bucket processing
    "mcmc_step",      # pipelines/fit_toas.py: delta-basis MCMC dispatch
    "tuner_cache",    # ops/autotune.py: verdict-cache JSON load
    "serve_admission",   # serve/admission.py: request admission
    "serve_dispatch",    # serve/engine.py: batched/warm request dispatch
    "serve_deadline",    # serve/scheduler.py: deadline-budget evaluation
    "serve_warm_batch",  # serve/engine.py: stacked warm-refold dispatch
    "scan_chunk",        # ops/resumable.py: chunk compute / checkpoint load
})

# Spec kind name -> FailureKind the injected exception will classify as.
KIND_NAMES = {
    "oom": FailureKind.RESOURCE_EXHAUSTED,
    "device": FailureKind.DEVICE_LOST,
    "nan": FailureKind.NONFINITE_RESULT,
    "corrupt": FailureKind.CACHE_CORRUPT,
    "timeout": FailureKind.TIMEOUT,
    "data": FailureKind.DATA_ERROR,
    "unknown": FailureKind.UNKNOWN,
}

# (spec string, {point: {"calls": int, "arms": [(kind_name, n, repeat), ...]}})
_PLAN: tuple[str, dict] | None = None


def _parse(spec: str) -> dict:
    plan: dict[str, dict] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        if len(parts) != 3:
            raise ValueError(f"CRIMP_TORCH_FAULTS entry {item!r}: want kind:point:n")
        kind_name, point, n_str = parts
        if kind_name not in KIND_NAMES:
            raise ValueError(f"CRIMP_TORCH_FAULTS kind {kind_name!r}: "
                             f"want one of {sorted(KIND_NAMES)}")
        if point not in FAULT_POINTS:
            raise ValueError(f"CRIMP_TORCH_FAULTS point {point!r}: "
                             f"want one of {sorted(FAULT_POINTS)}")
        repeat = n_str.endswith("+")
        if repeat:
            n_str = n_str[:-1]
        try:
            n = int(n_str)
        except ValueError:
            raise ValueError(f"CRIMP_TORCH_FAULTS entry {item!r}: n must be an int "
                             "(optionally with a trailing + for repeating fire)") from None
        if n < 1:
            raise ValueError(f"CRIMP_TORCH_FAULTS entry {item!r}: n must be >= 1")
        plan.setdefault(point, {"calls": 0, "arms": []})
        plan[point]["arms"].append((kind_name, n, repeat))
    return plan


def _make(kind_name: str, point: str, call_no: int) -> Exception:
    kind = KIND_NAMES[kind_name]
    # Corruption and data faults raise the plain typed error so the real
    # quarantine / validation machinery handles them.
    msg = f"injected {kind.value} fault at point '{point}' (call #{call_no})"
    if kind is FailureKind.CACHE_CORRUPT:
        return CacheCorruptError(msg)
    if kind is FailureKind.NONFINITE_RESULT:
        return NonfiniteResultError(msg)
    if kind is FailureKind.DATA_ERROR:
        return DataError(msg)
    return InjectedFault(kind, point, call_no)


def fire(point: str) -> None:
    """Raise the armed fault if ``point`` has reached its trigger count.
    No-op (one env read) when CRIMP_TORCH_FAULTS is unset."""
    spec = knobs.raw("CRIMP_TORCH_FAULTS")
    if not spec:
        return
    global _PLAN
    if _PLAN is None or _PLAN[0] != spec:
        _PLAN = (spec, _parse(spec))
    state = _PLAN[1].get(point)
    if state is None:
        return
    state["calls"] += 1
    for kind_name, n, repeat in state["arms"]:
        if state["calls"] == n or (repeat and state["calls"] >= n):
            raise _make(kind_name, point, state["calls"])


def reset() -> None:
    """Forget call counts (tests call this between injections)."""
    global _PLAN
    _PLAN = None


def plan_snapshot() -> dict:
    """Debug view of the armed plan (empty when disarmed)."""
    if _PLAN is None:
        return {}
    return {point: dict(state) for point, state in _PLAN[1].items()}


__all__ = ["FAULT_POINTS", "KIND_NAMES", "fire", "plan_snapshot", "reset"]
