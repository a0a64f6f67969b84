"""Deadline-aware rung scheduler: degrade pre-emptively, never fail.

Port of ``crimp_tpu/serve/scheduler.py``. The scheduler keeps an EWMA
(alpha 0.3) of the observed per-request latency at every rung of
``resilience.LADDERS["multisource"]`` and, before a dispatch, picks the
highest rung that its circuit breaker admits and the remaining budget can
afford. A pick below the top rung is stamped degraded with the kind that
forced it: TIMEOUT for the budget, the breaker's last classified kind for a
shed. The bottom rung is always eligible: an admitted request completes.

The latencies fed to :meth:`DeadlineScheduler.observe` are host-clock spans
that end after the round's numbers reached the host (the engine's frames
are numpy), so an asynchronous card can never make a rung look cheaper than
it is.

The ``serve_deadline`` fault point fires inside the budget evaluation; an
injected fault there classifies and forces the bottom rung.
"""

from __future__ import annotations

import logging

from crimp_tpu_torch import knobs, resilience
from crimp_tpu_torch.resilience import faultinject, taxonomy
from crimp_tpu_torch.resilience.taxonomy import FailureKind
from crimp_tpu_torch.serve import breaker as breaker_mod

logger = logging.getLogger("crimp_tpu_torch.serve")

LADDER = resilience.LADDERS["multisource"]  # ("batched", "split_bucket", "per_source")
# The warm (delta-fold) path's rung labels, distinct from the cold ladder
# so warm observations never move the cold rungs' estimates: pick_rung
# walks LADDER only. WARM_BATCH_RUNG tops LADDERS["serve_warm"] (a failed
# stacked dispatch stamps "serve_warm:solo"); WARM_RUNG labels the
# per-request warm dispatch.
WARM_BATCH_RUNG = resilience.LADDERS["serve_warm"][0]  # "warm_batched"
WARM_RUNG = "warm"
EWMA_ALPHA = 0.3


def default_deadline_s() -> float | None:
    """CRIMP_TORCH_SERVE_DEADLINE_MS in seconds, or None when unset."""
    ms = knobs.env_pos_float("CRIMP_TORCH_SERVE_DEADLINE_MS")
    return None if ms is None else ms / 1000.0


class DeadlineScheduler:
    """Pick the best affordable ladder rung for each dispatch."""

    def __init__(self, ladder: tuple = LADDER, alpha: float = EWMA_ALPHA):
        if not ladder:
            raise ValueError("scheduler needs a non-empty ladder")
        self.ladder = tuple(ladder)
        self.alpha = float(alpha)
        self._est: dict[str, float] = {}

    def observe(self, rung: str, latency_s: float) -> None:
        """Feed one observed per-request latency at ``rung`` into the EWMA."""
        latency_s = float(latency_s)
        if latency_s < 0:
            return
        prev = self._est.get(rung)
        self._est[rung] = latency_s if prev is None else self.alpha * latency_s + (1.0 - self.alpha) * prev

    def estimate(self, rung: str) -> float | None:
        """EWMA latency estimate for ``rung`` (None until observed)."""
        return self._est.get(rung)

    def estimates(self) -> dict[str, float]:
        return dict(self._est)

    def pick_rung(self, remaining_s: float | None, breakers: breaker_mod.RungBreakers | None = None,
                  ) -> tuple[str, FailureKind | None]:
        """The rung this request dispatches at, and the kind that forced a
        pick below the top (None: the top rung, nothing to stamp). A rung is
        skipped when its breaker sheds or its estimate exceeds the remaining
        budget; the bottom rung is returned unconditionally."""
        forced: FailureKind | None = None
        try:
            faultinject.fire("serve_deadline")
        except Exception as exc:  # deadline-machinery failure domain: the budget counts as spent
            forced = taxonomy.classify(exc)
            logger.warning("deadline evaluation failed (%s); forcing the bottom rung", forced.value)
            return self.ladder[-1], forced
        for rung in self.ladder[:-1]:
            if breakers is not None and not breakers.allow(rung):
                forced = breakers.last_kind(rung) or FailureKind.UNKNOWN
                continue
            est = self._est.get(rung)
            if remaining_s is not None and est is not None and est > remaining_s:
                forced = FailureKind.TIMEOUT
                continue
            if remaining_s is not None and remaining_s <= 0.0:
                forced = FailureKind.TIMEOUT
                continue
            return rung, None if rung == self.ladder[0] else forced
        return self.ladder[-1], forced or (FailureKind.TIMEOUT if remaining_s is not None else None)


__all__ = ["DeadlineScheduler", "EWMA_ALPHA", "LADDER", "WARM_BATCH_RUNG", "WARM_RUNG", "default_deadline_s"]
