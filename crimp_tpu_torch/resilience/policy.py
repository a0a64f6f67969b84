"""Degradation policy: how a classified failure is recovered.

Port of ``crimp_tpu/resilience/policy.py``, the parts whose callers the
port has. **Degradation** (``record_degradation`` + the per-engine
``LADDERS``): fall to the next rung of an already parity-pinned path. The
run completes but is stamped ``degraded`` in the obs manifest.

DATA_ERROR never degrades. CACHE_CORRUPT has its own recovery
(``quarantine_file`` and rebuild), a repair, not a degradation. A
``KernelError`` is neither: every ladder re-raises it untouched. The JAX
package's same-mode retry (``retry_call``) and its pinned-CPU device rung
have no caller in the port: no ladder here moves work off the card.
"""

from __future__ import annotations

import logging
import os

from crimp_tpu_torch import obs
from crimp_tpu_torch.resilience.taxonomy import FailureKind

logger = logging.getLogger("crimp_tpu_torch.resilience")

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


__all__ = ["LADDERS", "quarantine_file", "record_degradation"]
