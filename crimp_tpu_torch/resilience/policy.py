"""Retry and degradation policy: how a classified failure is recovered.

Port of ``crimp_tpu/resilience/policy.py``. Two recovery shapes:

* **Retry** (``retry_call``): re-run the same computation in the same
  numeric mode. For transient kinds (RESOURCE_EXHAUSTED, TIMEOUT,
  DEVICE_LOST, NONFINITE_RESULT, UNKNOWN); a successful retry is
  bit-identical to a clean run. Bounded attempts, exponential backoff,
  deterministic jitter (sha256 of point and attempt). A ``KernelError`` and
  a sticky CUDA error (an illegal address poisons the context) are never
  retried.
* **Degradation** (``record_degradation`` + the per-engine ``LADDERS``):
  fall to the next rung of an already parity-pinned path. The run
  completes but is stamped ``degraded`` in the obs manifest.

DATA_ERROR is never retried and never degrades. CACHE_CORRUPT has its own
recovery (``quarantine_file`` and rebuild), a repair, not a degradation. A
``KernelError`` is neither: every ladder re-raises it untouched. The JAX
package's pinned-CPU device rung is not ported: no ladder here moves work
off the card.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time

from crimp_tpu_torch import knobs, obs
from crimp_tpu_torch.resilience import taxonomy
from crimp_tpu_torch.resilience.taxonomy import FailureKind

logger = logging.getLogger("crimp_tpu_torch.resilience")

DEFAULT_RETRIES = 1
DEFAULT_BACKOFF_S = 0.05

# Kinds eligible for same-mode retry. DATA_ERROR and CACHE_CORRUPT are
# excluded: they have their own recovery domains (see the docstring).
RETRYABLE_KINDS = frozenset({
    FailureKind.RESOURCE_EXHAUSTED,
    FailureKind.TIMEOUT,
    FailureKind.DEVICE_LOST,
    FailureKind.NONFINITE_RESULT,
    FailureKind.UNKNOWN,
})

# Rung order per engine, first rung the normal path; each step down is a
# path that already exists and is parity-pinned by the tests. Only the
# engines the port has.
LADDERS = {
    "multisource": ("batched", "split_bucket", "per_source"),
    "grid": ("grid_mxu", "streamed", "exact"),
    "fold": ("delta_fold", "exact_refold"),
    "mcmc": ("delta_basis", "exact_likelihood"),
    "serve_warm": ("warm_batched", "solo"),
}


class RetryPolicy:
    """Bounded same-mode retry: attempts, backoff, per-kind eligibility."""

    __slots__ = ("retries", "backoff_s", "kinds")

    def __init__(self, retries: int = DEFAULT_RETRIES, backoff_s: float = DEFAULT_BACKOFF_S,
                 kinds: frozenset = RETRYABLE_KINDS):
        self.retries = max(int(retries), 0)
        self.backoff_s = max(float(backoff_s), 0.0)
        self.kinds = frozenset(kinds)

    def delay_s(self, attempt: int, point: str) -> float:
        """Exponential backoff with deterministic jitter in [0.5x, 1.0x]."""
        base = self.backoff_s * (2 ** attempt)
        digest = hashlib.sha256(f"{point}|{attempt}".encode()).digest()
        frac = int.from_bytes(digest[:4], "big") / 0xFFFFFFFF
        return base * (0.5 + 0.5 * frac)


def default_policy() -> RetryPolicy:
    """Policy from knobs: CRIMP_TORCH_RETRIES / CRIMP_TORCH_BACKOFF_S."""
    retries = knobs.env_nonneg_int("CRIMP_TORCH_RETRIES")
    if retries is None:
        retries = DEFAULT_RETRIES
    return RetryPolicy(retries=retries, backoff_s=knobs.env_float("CRIMP_TORCH_BACKOFF_S", DEFAULT_BACKOFF_S))


def retry_call(fn, *, point: str, policy: RetryPolicy | None = None, deadline_s: float | None = None):
    """Call ``fn()``; retry retryable kinds up to ``policy.retries`` times.

    A successful retry is bit-identical to a clean first attempt (same
    numeric mode, same inputs). Non-retryable kinds, a ``KernelError``, a
    sticky CUDA error and exhausted budgets re-raise the original exception.

    ``deadline_s`` is the caller's remaining budget, counted from this
    call's start: when the backoff sleep would overrun what is left of it,
    the retry is skipped and the exception re-raises at once. A budget
    exactly equal to the delay still retries.
    """
    if policy is None:
        policy = default_policy()
    t0 = time.perf_counter() if deadline_s is not None else None
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:
            if isinstance(exc, taxonomy.KernelError) or taxonomy.sticky_cuda_error(exc):
                raise
            kind = taxonomy.classify(exc)
            if kind not in policy.kinds or attempt >= policy.retries:
                raise
            delay = policy.delay_s(attempt, point)
            if deadline_s is not None:
                remaining = deadline_s - (time.perf_counter() - t0)
                if delay > remaining:
                    obs.counter_add("retries_deadline_skipped", 1)
                    logger.warning("not retrying %s after %s: backoff %.3fs exceeds remaining deadline "
                                   "budget %.3fs", point, kind.value, delay, remaining)
                    raise
            obs.counter_add("retries", 1)
            obs.counter_add(f"retries_{point}", 1)
            logger.warning("retrying %s after %s (%s; attempt %d of %d)", point, kind.value,
                           type(exc).__name__, attempt + 1, policy.retries)
            if delay > 0:
                time.sleep(delay)
            attempt += 1


def record_degradation(engine: str, rung: str, kind: FailureKind | None = None) -> None:
    """Stamp the active run degraded and count the ladder step taken."""
    if engine in LADDERS and rung not in LADDERS[engine]:
        raise ValueError(f"unknown rung {rung!r} for engine {engine!r}")
    obs.counter_add("degradations", 1)
    obs.counter_add(f"degraded_{engine}_{rung}", 1)
    reason = f"{engine}:{rung}" + (f":{kind.value}" if kind else "")
    obs.mark_degraded(reason)
    logger.warning("degraded %s -> %s (%s)", engine, rung, kind.value if kind else "unclassified")


def quarantine_file(path, label: str = "cache") -> str | None:
    """Atomically rename a corrupt cache product to ``*.corrupt``.

    Returns the quarantine path, or None if the file vanished. Never raises.
    """
    src = os.fspath(path)
    target = src + ".corrupt"
    try:
        os.replace(src, target)
    except OSError:
        return None
    obs.counter_add("quarantined_files", 1)
    obs.counter_add(f"quarantined_{label}", 1)
    logger.warning("quarantined corrupt %s file %s -> %s; rebuilding", label, src, target)
    return target


__all__ = ["DEFAULT_BACKOFF_S", "DEFAULT_RETRIES", "LADDERS", "RETRYABLE_KINDS", "RetryPolicy",
           "default_policy", "quarantine_file", "record_degradation", "retry_call"]
