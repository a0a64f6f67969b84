"""Open-loop Poisson load generator for the serving engine.

Port of ``crimp_tpu/serve/loadgen.py``. Arrival times are drawn up front
from a seeded exponential inter-arrival distribution, and each request's
latency runs from its SCHEDULED arrival, however far behind the engine is,
so queue wait shows in the latency distribution as a real client would feel
it (coordinated omission cannot hide it). One loop submits every arrival
whose time has passed, runs one :meth:`ServingEngine.step`, and repeats.
Rejections (backpressure) are counted as an outcome, not raised. Latencies
and the wall are host clocks read after each round's numbers reached the
host.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from crimp_tpu_torch.serve.admission import AdmissionRejected, TimingRequest

logger = logging.getLogger("crimp_tpu_torch.serve")


def poisson_arrivals(rate_hz: float, n: int, seed: int = 0) -> np.ndarray:
    """``n`` arrival offsets (seconds from start) at ``rate_hz`` mean request
    rate, from ``np.random.RandomState(seed)``: the same schedule every run."""
    rate_hz = float(rate_hz)
    if rate_hz <= 0:
        raise ValueError(f"rate_hz={rate_hz!r} must be > 0")
    n = int(n)
    if n < 1:
        raise ValueError(f"n={n!r} must be >= 1")
    rng = np.random.RandomState(int(seed))
    return np.cumsum(rng.exponential(1.0 / rate_hz, size=n))


def run_load(engine, specs, rate_hz: float, seed: int = 0, deadline_s: float | None = None) -> dict:
    """Replay ``specs`` against ``engine`` at a Poisson ``rate_hz``, one
    request per spec, each pre-stamped with its scheduled arrival. Returns::

        {"rate_hz", "n_requests", "completed", "ok", "degraded", "errors",
         "rejected", "deadline_misses", "wall_s", "requests_per_s",
         "p50_latency_ms", "p99_latency_ms", "results": [RequestResult...]}
    """
    specs = list(specs)
    arrivals = poisson_arrivals(rate_hz, len(specs), seed=seed)
    t_start = time.perf_counter()
    results = []
    rejected = 0
    i = 0
    while i < len(specs) or len(engine.queue):
        now = time.perf_counter() - t_start
        while i < len(specs) and arrivals[i] <= now:
            req = TimingRequest(spec=specs[i], deadline_s=deadline_s, submitted_at=t_start + arrivals[i])
            try:
                engine.submit(req)
            except AdmissionRejected as exc:
                rejected += 1
                logger.info("request %s rejected at admission (%s)", req.client_id, exc.kind.value)
            i += 1
        if len(engine.queue):
            results.extend(engine.step())
        elif i < len(specs):
            # idle until the next scheduled arrival (open loop: arrivals are
            # never pulled forward to keep the engine busy)
            time.sleep(min(max(arrivals[i] - now, 0.0), 0.05))
    wall_s = time.perf_counter() - t_start

    lat_ms = np.asarray([r.latency_s for r in results if r.latency_s is not None]) * 1e3
    completed = len(results)
    return {
        "rate_hz": float(rate_hz),
        "n_requests": len(specs),
        "completed": completed,
        "ok": sum(1 for r in results if r.status == "ok"),
        "degraded": sum(1 for r in results if r.status == "degraded"),
        "errors": sum(1 for r in results if r.status == "error"),
        "rejected": rejected,
        "deadline_misses": sum(1 for r in results if r.deadline_miss),
        "wall_s": float(wall_s),
        "requests_per_s": float(completed / wall_s) if wall_s > 0 else 0.0,
        "p50_latency_ms": float(np.percentile(lat_ms, 50)) if lat_ms.size else 0.0,
        "p99_latency_ms": float(np.percentile(lat_ms, 99)) if lat_ms.size else 0.0,
        "results": results,
    }


__all__ = ["poisson_arrivals", "run_load"]
