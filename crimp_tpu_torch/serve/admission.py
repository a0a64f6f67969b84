"""Bounded admission queue with priority classes and a fair-queue drain.

Port of ``crimp_tpu/serve/admission.py``. The serving engine's front door:
:meth:`AdmissionQueue.offer` either accepts a request (it becomes a row of
the next continuous-batching round) or raises a typed
:class:`AdmissionRejected` carrying a taxonomy :class:`FailureKind`: a full
queue is RESOURCE_EXHAUSTED backpressure, a malformed request DATA_ERROR.
The queue never blocks and never grows without bound.

Priority classes (``TimingRequest.priority``: high / normal / low) get their
own bounded sub-queues, so a low-priority flood can never block high
admission, and :meth:`AdmissionQueue.drain` interleaves the classes by
deficit round-robin with the :data:`PRIORITY_CLASSES` weights as quanta:
every non-empty class progresses each round, FIFO within a class.

Capacity comes from ``CRIMP_TORCH_SERVE_QUEUE`` (default 64, per class); the
``serve_admission`` fault point fires inside :meth:`AdmissionQueue.offer`,
where an injected fault becomes the same classified rejection an organic
one would.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from crimp_tpu_torch import knobs, obs
from crimp_tpu_torch.resilience import faultinject, taxonomy
from crimp_tpu_torch.resilience.taxonomy import CrimpError, FailureKind

DEFAULT_QUEUE_CAP = 64

# Priority classes in drain-precedence order, with their deficit-round-
# robin quanta (requests per drain round while backlogged): weighted fair
# queueing, not strict priority.
PRIORITY_CLASSES = {"high": 4, "normal": 2, "low": 1}


class AdmissionRejected(CrimpError):
    """A request refused at the front door; ``kind`` says why.

    RESOURCE_EXHAUSTED = queue full (backpressure: try again later);
    DATA_ERROR = the request itself is malformed (retrying is pointless);
    other kinds surface injected or organic admission-path failures.
    """

    def __init__(self, message: str, kind: FailureKind):
        super().__init__(message)
        self.kind = kind


@dataclass
class TimingRequest:
    """One timing request: a survey ``SourceSpec`` plus its latency budget.

    ``spec.name`` is the client identity: it names the client's fold-cache
    slot (``cache_tag``), so a returning client re-times as one refold
    against its cached fold product. ``deadline_s`` is the budget in seconds
    from submission; None defers to ``CRIMP_TORCH_SERVE_DEADLINE_MS`` (unset:
    no deadline). ``submitted_at`` (``time.perf_counter`` seconds) is stamped
    at admission; the load generator pre-stamps the scheduled arrival so
    open-loop latencies include queue wait. ``priority`` names one of the
    :data:`PRIORITY_CLASSES`.
    """

    spec: object
    deadline_s: float | None = None
    submitted_at: float | None = None
    fit_kwargs: dict = field(default_factory=dict)
    priority: str = "normal"

    @property
    def client_id(self) -> str:
        return str(getattr(self.spec, "name", ""))


def queue_capacity() -> int:
    """CRIMP_TORCH_SERVE_QUEUE (default 64); zero or negative raises."""
    cap = knobs.env_int("CRIMP_TORCH_SERVE_QUEUE", DEFAULT_QUEUE_CAP)
    if cap < 1:
        raise ValueError(f"CRIMP_TORCH_SERVE_QUEUE={cap!r} out of range (expected >= 1)")
    return cap


class AdmissionQueue:
    """Per-class FIFOs of admitted requests, each capped; full = typed
    rejection; drained by weighted deficit round-robin."""

    def __init__(self, capacity: int | None = None):
        self.capacity = int(capacity) if capacity is not None else queue_capacity()
        if self.capacity < 1:
            raise ValueError("admission queue capacity must be >= 1")
        self._queues: dict[str, deque[TimingRequest]] = {cls: deque() for cls in PRIORITY_CLASSES}
        self._deficit: dict[str, int] = {cls: 0 for cls in PRIORITY_CLASSES}
        self.admitted = 0
        self.rejected = 0

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _reject(self, message: str, kind: FailureKind, cause: Exception | None = None):
        self.rejected += 1
        obs.counter_add("serve_rejected", 1)
        raise AdmissionRejected(message, kind) from cause

    def offer(self, request: TimingRequest) -> TimingRequest:
        """Admit ``request`` or raise :class:`AdmissionRejected`; every
        failure on this path leaves through the typed rejection."""
        try:
            faultinject.fire("serve_admission")
        except Exception as exc:  # admission failure domain: a classified rejection
            self._reject(f"admission failed: {exc}", taxonomy.classify(exc), exc)
        if not isinstance(request, TimingRequest):
            self._reject(f"expected a TimingRequest, got {type(request).__name__}", FailureKind.DATA_ERROR)
        if not request.client_id:
            self._reject("request spec has no name (the client identity)", FailureKind.DATA_ERROR)
        if request.deadline_s is not None and not (float(request.deadline_s) > 0.0):
            self._reject(f"deadline_s={request.deadline_s!r} must be > 0", FailureKind.DATA_ERROR)
        if request.priority not in PRIORITY_CLASSES:
            self._reject(f"priority={request.priority!r} is not a declared class ({'/'.join(PRIORITY_CLASSES)})",
                         FailureKind.DATA_ERROR)
        if len(self._queues[request.priority]) >= self.capacity:
            obs.counter_add("serve_queue_full", 1)
            self._reject(f"admission queue full for class {request.priority!r} ({self.capacity} pending): "
                         "resource exhausted, retry after the next batch drains", FailureKind.RESOURCE_EXHAUSTED)
        if request.submitted_at is None:
            request.submitted_at = time.perf_counter()
        self._queues[request.priority].append(request)
        self.admitted += 1
        obs.counter_add("serve_admitted", 1)
        obs.counter_add(f"serve_admitted_{request.priority}", 1)
        return request

    def drain(self, n: int | None = None) -> list[TimingRequest]:
        """Pop up to ``n`` admitted requests (all when None): the next
        round's rows, by deficit round-robin across the classes. Unspent
        deficit carries to the next drain while a class stays backlogged and
        resets when its sub-queue empties."""
        total = len(self)
        take = total if n is None else min(int(n), total)
        out: list[TimingRequest] = []
        while len(out) < take:
            for cls, weight in PRIORITY_CLASSES.items():
                q = self._queues[cls]
                if not q:
                    self._deficit[cls] = 0
                    continue
                self._deficit[cls] += weight
                while q and self._deficit[cls] > 0 and len(out) < take:
                    out.append(q.popleft())
                    self._deficit[cls] -= 1
                if not q:
                    self._deficit[cls] = 0
        return out


__all__ = ["AdmissionQueue", "AdmissionRejected", "DEFAULT_QUEUE_CAP", "PRIORITY_CLASSES", "TimingRequest",
           "queue_capacity"]
