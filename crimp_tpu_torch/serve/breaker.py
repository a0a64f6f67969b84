"""Per-rung circuit breakers: a sick rung sheds to its ladder.

Port of ``crimp_tpu/serve/breaker.py``. After ``CRIMP_TORCH_SERVE_BREAKER``
(default 5) consecutive classified failures at a rung its breaker OPENS and
the scheduler routes around the rung. After a cooldown it HALF-OPENS: one
probe request goes through; a probe success closes the breaker, a probe
failure re-opens it.

The cooldown is counted in denied calls, not seconds, so the whole CLOSED ->
OPEN -> HALF_OPEN -> CLOSED cycle is deterministic in calls. Transitions are
counted (``serve_breaker_open`` / ``_half_open`` / ``_close`` / ``_reopen``,
plus per-rung variants) so a run's manifest shows the cycle.
"""

from __future__ import annotations

import logging

from crimp_tpu_torch import knobs, obs
from crimp_tpu_torch.resilience.taxonomy import FailureKind

logger = logging.getLogger("crimp_tpu_torch.serve")

DEFAULT_THRESHOLD = 5
DEFAULT_COOLDOWN_CALLS = 8

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


def breaker_threshold() -> int:
    """CRIMP_TORCH_SERVE_BREAKER (default 5; 0 disables)."""
    val = knobs.env_nonneg_int("CRIMP_TORCH_SERVE_BREAKER")
    return DEFAULT_THRESHOLD if val is None else val


class _Rung:
    __slots__ = ("state", "failures", "denials", "probing", "last_kind")

    def __init__(self):
        self.state = CLOSED
        self.failures = 0  # consecutive classified failures while CLOSED
        self.denials = 0  # calls shed while OPEN (the cooldown counter)
        self.probing = False  # a HALF_OPEN probe is in flight
        self.last_kind: FailureKind | None = None


class RungBreakers:
    """One breaker per ladder rung (created on first use, independent)."""

    def __init__(self, threshold: int | None = None, cooldown_calls: int = DEFAULT_COOLDOWN_CALLS):
        self.threshold = breaker_threshold() if threshold is None else int(threshold)
        self.cooldown_calls = max(int(cooldown_calls), 1)
        self._rungs: dict[str, _Rung] = {}

    def _rung(self, rung: str) -> _Rung:
        return self._rungs.setdefault(rung, _Rung())

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def allow(self, rung: str) -> bool:
        """Whether the scheduler may route a request to ``rung`` now. An
        OPEN rung sheds (each shed counts toward its cooldown); once the
        cooldown elapses it HALF-OPENS and admits one probe at a time."""
        if not self.enabled:
            return True
        r = self._rung(rung)
        if r.state == CLOSED:
            return True
        if r.state == OPEN:
            r.denials += 1
            if r.denials >= self.cooldown_calls:
                r.state = HALF_OPEN
                r.probing = False
                obs.counter_add("serve_breaker_half_open", 1)
                obs.counter_add(f"serve_breaker_half_open_{rung}", 1)
                logger.warning("breaker %s: open -> half_open (probe)", rung)
            else:
                obs.counter_add("serve_breaker_shed", 1)
                return False
        if r.probing:
            obs.counter_add("serve_breaker_shed", 1)
            return False
        r.probing = True
        return True

    def record_success(self, rung: str) -> None:
        if not self.enabled:
            return
        r = self._rung(rung)
        if r.state == HALF_OPEN:
            obs.counter_add("serve_breaker_close", 1)
            obs.counter_add(f"serve_breaker_close_{rung}", 1)
            logger.warning("breaker %s: half_open -> closed", rung)
        r.state = CLOSED
        r.failures = 0
        r.denials = 0
        r.probing = False
        r.last_kind = None

    def record_failure(self, rung: str, kind: FailureKind) -> None:
        if not self.enabled:
            return
        r = self._rung(rung)
        r.last_kind = kind
        if r.state == HALF_OPEN:
            r.state = OPEN
            r.denials = 0
            r.probing = False
            obs.counter_add("serve_breaker_reopen", 1)
            obs.counter_add(f"serve_breaker_reopen_{rung}", 1)
            logger.warning("breaker %s: probe failed (%s); half_open -> open", rung, kind.value)
            return
        r.failures += 1
        if r.state == CLOSED and r.failures >= self.threshold:
            r.state = OPEN
            r.denials = 0
            obs.counter_add("serve_breaker_open", 1)
            obs.counter_add(f"serve_breaker_open_{rung}", 1)
            logger.warning("breaker %s: closed -> open after %d classified failures (%s)", rung, r.failures,
                           kind.value)

    def state(self, rung: str) -> str:
        return self._rungs[rung].state if rung in self._rungs else CLOSED

    def last_kind(self, rung: str) -> FailureKind | None:
        return self._rungs[rung].last_kind if rung in self._rungs else None

    def snapshot(self) -> dict:
        """{rung: {state, failures, denials}} for stats and manifests."""
        return {rung: {"state": r.state, "failures": r.failures, "denials": r.denials}
                for rung, r in self._rungs.items()}


__all__ = ["CLOSED", "DEFAULT_COOLDOWN_CALLS", "DEFAULT_THRESHOLD", "HALF_OPEN", "OPEN", "RungBreakers",
           "breaker_threshold"]
