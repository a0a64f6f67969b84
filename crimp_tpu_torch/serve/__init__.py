"""Serving layer: a resident timing service over the survey engine.

Port of ``crimp_tpu/serve``. :class:`ServingEngine` keeps the fold cache
and the built kernels resident, admits requests through bounded
per-priority-class queues (typed backpressure, deficit-round-robin drain),
forms continuous batches through the multisource engine (warm clients
refold in one K4 launch per round) and degrades along the resilience
ladders: pre-emptively when a deadline demands it, reactively when a
dispatch fails, with per-rung circuit breakers.

Every admitted request completes (``ok`` or ``degraded``, stamped through
``record_degradation``) or ends as a classified error; a refused one leaves
``submit`` as :class:`AdmissionRejected` with a taxonomy kind. A
``KernelError`` is no request outcome: it propagates. Nothing imports this
package unless serving is used, and batch pipelines are unchanged by it.
"""

from crimp_tpu_torch.serve.admission import (AdmissionQueue, AdmissionRejected, PRIORITY_CLASSES, TimingRequest,
                                             queue_capacity)
from crimp_tpu_torch.serve.breaker import RungBreakers, breaker_threshold
from crimp_tpu_torch.serve.engine import RequestResult, ServingEngine
from crimp_tpu_torch.serve.loadgen import poisson_arrivals, run_load
from crimp_tpu_torch.serve.scheduler import (DeadlineScheduler, LADDER, WARM_BATCH_RUNG, WARM_RUNG,
                                             default_deadline_s)

__all__ = [
    "AdmissionQueue", "AdmissionRejected", "DeadlineScheduler", "LADDER", "PRIORITY_CLASSES", "RequestResult",
    "RungBreakers", "ServingEngine", "TimingRequest", "WARM_BATCH_RUNG", "WARM_RUNG", "breaker_threshold",
    "default_deadline_s", "poisson_arrivals", "queue_capacity", "run_load",
]
