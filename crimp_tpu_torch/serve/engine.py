"""The resident serving engine: continuous batching over the survey core.

Port of ``crimp_tpu/serve/engine.py``. One long-lived
:class:`ServingEngine` serves many clients' re-timing requests on one
device: requests enter through the bounded admission queue
(``serve/admission.py``) and each :meth:`ServingEngine.step` is one
continuous-batching round, in which every admitted request becomes a row of
the next multisource dispatch (``bucket_sources`` -> ``survey.compute_bucket``).

Request lifecycle:

1. **admission**: accepted, or rejected with a taxonomy kind;
2. **scheduling**: the deadline scheduler (``serve/scheduler.py``) picks the
   highest ladder rung the remaining budget affords and the per-rung circuit
   breakers (``serve/breaker.py``) admit;
3. **dispatch**: cold clients batch at the picked rung and seed their
   fold-cache slot (``deltafold.store_product(tag=client)``). Returning
   (warm) clients take the delta-fold path: with the warm-batch knob on
   (``CRIMP_TORCH_SERVE_WARM_BATCH`` via ``resolve_serve_warm_batch``, the
   default; the verdict cache is read once per engine) the round's warm
   clients refold in one ``deltafold.delta_refold_batch`` call per bucket
   (grouped and bucketed as the cold path is), one launch of K4 each on the card (rung
   ``warm_batched``), and the fits ride the batched ``compute_bucket``; with
   the knob off, or for a client the batch demotes (cache miss, non-linear
   move, guard trip), the request re-times solo (rung ``warm``) through
   ``measure_source_toas(delta_fold=1)``, whose refold is K4 too;
4. **completion**: ``ok``, ``degraded`` (stamped via ``record_degradation``)
   or ``error`` with a classified record (DATA_ERROR never degrades).

Parity: the port holds two levels. Bit for bit: every fold, refold and
seeded product, so a warm client's refolded phases are the same bits on
both warm rungs, and a cold round's folds are the solo path's. To the
survey's parity contract: every fit and H-test column (phShift 1e-6 rad,
phShift_LL/UL one profile step, Hpower 1e-5 and redChi2 1e-6 relative; the
other columns exact), because the port sums events with ``torch.sum``
(``ops/reduce.event_sum``), whose rounding depends on the rows beside a
row. The JAX package promises bits there too; the difference is deliberate
(``pipelines/survey.py``).

Failure domains are the survey's: a failed bucket splits and retries, a
one-request bucket demotes to the per-source rung, and a per-source failure
ends as its classified error record. Unlike the JAX package there is no
pinned-CPU rung: no ladder of the port moves work off the device it was
given. A ``KernelError`` (a hand kernel that failed to build or launch) is
re-raised before any classification at every catch site, so a K4 failure in
a warm batch leaves :meth:`step` as that error: it is never demoted to the
solo rung (which would launch K4 again) or to an exact fold. The
``serve_dispatch`` fault point fires on every batched and warm dispatch,
not on the per-source floor; ``serve_warm_batch`` fires inside the stacked
warm dispatch, whose failure walks ``LADDERS["serve_warm"]``
(``warm_batched -> solo``).

Host-side prep (``survey._prep_source``, numpy only, so the worker thread
issues no device work) overlaps the previous round's dispatch on one worker
thread; futures are consumed in drain order, so results are bit-identical
to serial prep (``CRIMP_TORCH_SERVE_PREP_OVERLAP=0`` pins serial prep).

Clocks: latencies, the scheduler's EWMA and the load generator's wall are
host clocks read after a round's numbers reached the host (frames are
numpy), never at enqueue time.
"""

from __future__ import annotations

import concurrent.futures
import logging
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from crimp_tpu_torch import knobs, obs, resilience
from crimp_tpu_torch.ops import autotune, deltafold, multisource
from crimp_tpu_torch.parallel import multihost
from crimp_tpu_torch.pipelines import survey
from crimp_tpu_torch.resilience import faultinject
from crimp_tpu_torch.resilience.taxonomy import FailureKind
from crimp_tpu_torch.serve import breaker as breaker_mod
from crimp_tpu_torch.serve import scheduler as scheduler_mod
from crimp_tpu_torch.serve.admission import AdmissionQueue, AdmissionRejected, TimingRequest
from crimp_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("crimp_tpu_torch.serve")


@dataclass
class RequestResult:
    """One request's terminal state.

    ``status``: ``ok`` (completed on the reference path), ``degraded``
    (completed on a lower rung, stamped in the obs manifest) or ``error``
    (a classified failure record; ``kind`` from the closed taxonomy).
    Rejected requests never reach a result: they leave
    :meth:`ServingEngine.submit` as :class:`AdmissionRejected`.
    """

    client_id: str
    status: str
    frame: object = None
    rung: str | None = None
    path: str | None = None  # delta_fold:<mode> / batched / per_source
    kind: str | None = None
    latency_s: float | None = None
    deadline_miss: bool = False
    error: dict | None = None


@dataclass
class _Pending:
    """A drained request moving through one batching round."""

    req: TimingRequest
    prep: object = None
    degraded: bool = False
    rung: str | None = None
    result: RequestResult | None = None
    extra: dict = field(default_factory=dict)


class ServingEngine:
    """Long-lived timing service over the multisource batch engine, on
    ``device`` (None: the card, raising without one)."""

    def __init__(self, queue: AdmissionQueue | None = None,
                 scheduler: scheduler_mod.DeadlineScheduler | None = None,
                 breakers: breaker_mod.RungBreakers | None = None, phShiftRes: int = 1000, nbrBins: int = 15,
                 varyAmps: bool = False, mesh=None, warm_batch: int | None = None,
                 prep_overlap: bool | None = None, device=None):
        self.device = resolve_device(device)
        self.queue = queue if queue is not None else AdmissionQueue()
        self.scheduler = scheduler if scheduler is not None else scheduler_mod.DeadlineScheduler()
        self.breakers = breakers if breakers is not None else breaker_mod.RungBreakers()
        self.phShiftRes = int(phShiftRes)
        self.nbrBins = int(nbrBins)
        self.varyAmps = bool(varyAmps)
        self._default_deadline = scheduler_mod.default_deadline_s()
        self._warm: set[str] = set()  # clients with a seeded fold product
        # None resolves per round through the knob and the verdict cache;
        # 0/1 pin the path (the A/B arms use this)
        self._warm_batch = warm_batch
        self._prep_overlap = prep_overlap
        self._prep_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._prep_futures: dict[int, concurrent.futures.Future] = {}
        self._verdicts: dict | None = None  # the verdict cache, read on first use
        self._closed = False
        self.counts = {"ok": 0, "degraded": 0, "error": 0, "deadline_miss": 0, "steps": 0}
        # capacity note: the (optionally multi-process) mesh the engine
        # serves on, for stats(); the dispatch paths keep routing through the
        # multisource engine's own mesh selection, so passing a mesh never
        # changes a result
        self.mesh = mesh
        self.capacity = self._capacity_note(mesh, self.device)

    @staticmethod
    def _capacity_note(mesh, device) -> dict:
        """The serving capacity: the process identity, the device, and with a
        mesh its shard count and axes (else one device and no axes), so a
        multi-process deployment's stats say which part of the fleet this
        engine fronts."""
        pidx, pcount = multihost.process_identity()
        note = {"process_index": pidx, "process_count": pcount, "devices": 1, "mesh_axes": None,
                "device": str(device)}
        if mesh is not None:
            note["devices"] = int(mesh.size)
            note["mesh_axes"] = {str(a): int(mesh.shape[a]) for a in mesh.axis_names}
        return note

    # -- lifecycle ----------------------------------------------------------

    def warmup(self) -> dict:
        """Build and load the hand kernels the serving path launches before
        the first request: ``z2_grid.build()`` (one nvcc per source), then
        K4's library. No fallback: a failure raises ``KernelError``. The
        CPU path launches no hand kernel, so a CPU engine builds nothing."""
        if self.device.type != "cuda":
            return {"device": str(self.device), "built": {}, "seconds": 0.0}
        from crimp_tpu_torch.ops import z2_grid

        t0 = time.perf_counter()
        built = {name: str(path) for name, path in z2_grid.build().items()}
        deltafold._lib()
        return {"device": str(self.device), "built": built, "seconds": time.perf_counter() - t0}

    def close(self) -> None:
        """Shut down: join the prep worker, drop pending prep futures, and
        refuse later :meth:`submit` calls with a classified rejection.
        Idempotent."""
        self._closed = True
        pool, self._prep_pool = self._prep_pool, None
        self._prep_futures.clear()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def submit(self, spec, deadline_s: float | None = None, priority: str = "normal") -> TimingRequest:
        """Admit one request (a survey ``SourceSpec`` or a prebuilt
        :class:`TimingRequest`); raises :class:`AdmissionRejected` with a
        taxonomy kind on refusal."""
        if self._closed:
            raise AdmissionRejected("engine is closed", FailureKind.RESOURCE_EXHAUSTED)
        req = spec if isinstance(spec, TimingRequest) else TimingRequest(spec=spec, deadline_s=deadline_s,
                                                                         priority=priority)
        if req.deadline_s is None:
            req.deadline_s = self._default_deadline
        req = self.queue.offer(req)
        if self._prep_overlap_on():
            self._schedule_prep(req)
        return req

    def _prep_overlap_on(self) -> bool:
        """Constructor pin > CRIMP_TORCH_SERVE_PREP_OVERLAP > on."""
        if self._prep_overlap is not None:
            return bool(self._prep_overlap)
        env = knobs.env_onoff("CRIMP_TORCH_SERVE_PREP_OVERLAP")
        return True if env is None else env

    def _schedule_prep(self, req: TimingRequest) -> None:
        """Queue the request's host-side prep on the single worker. Prep is a
        pure numpy function of the spec and the futures are consumed in drain
        order, so results are bit-identical to serial prep."""
        if self._prep_pool is None:
            self._prep_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                                    thread_name_prefix="crimp-serve-prep")
        self._prep_futures[id(req)] = self._prep_pool.submit(survey._prep_source, req.spec, self.phShiftRes,
                                                             self.nbrBins, self.varyAmps)

    # -- one continuous-batching round ----------------------------------------

    def step(self) -> list[RequestResult]:
        """Process everything admitted since the last round; one terminal
        :class:`RequestResult` per drained request, in drain order. Every
        knob resolved inside the round reads the engine's one copy of the
        verdict cache (``autotune.entries_scope``)."""
        with autotune.entries_scope(self._entries()):
            return self._step()

    def _step(self) -> list[RequestResult]:
        batch = self.queue.drain()
        if not batch:
            return []
        self.counts["steps"] += 1
        pend = [_Pending(req=r) for r in batch]
        obs.beat(0, len(pend), label="serve", force=True)

        futures = [self._prep_futures.pop(id(p.req), None) for p in pend]
        obs.gauge_set("serve_prep_overlap_ready", sum(1 for f in futures if f is not None and f.done()))
        warm: list[_Pending] = []
        cold: list[_Pending] = []
        for p, fut in zip(pend, futures):
            try:
                p.prep = fut.result() if fut is not None else \
                    survey._prep_source(p.req.spec, self.phShiftRes, self.nbrBins, self.varyAmps)
            except resilience.KernelError:
                raise
            except Exception as exc:  # per-request domain: a malformed spec fails classified
                p.result = self._error_result(p, resilience.error_record(exc))
                continue
            (warm if p.req.client_id in self._warm else cold).append(p)

        if warm:
            self._dispatch_warm_group(warm)
        if cold:
            self._dispatch_cold(cold)

        for done, p in enumerate(pend, start=1):
            if p.result is None:  # every dispatch path resolves its requests
                p.result = self._error_result(p, resilience.error_record(
                    RuntimeError("request left unresolved by dispatch")))
            self._finalize(p)
            obs.beat(done, len(pend), label="serve")
        return [p.result for p in pend]

    def drain_all(self, max_steps: int = 1000) -> list[RequestResult]:
        """Step until the queue is empty."""
        out: list[RequestResult] = []
        for _ in range(max_steps):
            if not len(self.queue):
                break
            out.extend(self.step())
        return out

    # -- warm clients: the delta-fold path ------------------------------------

    def _dispatch_warm_group(self, warm: list[_Pending]) -> None:
        """One stacked refold when the warm-batch knob resolves on
        (constructor pin > CRIMP_TORCH_SERVE_WARM_BATCH > cached verdict >
        on), else the per-request loop; the refolded phases are the same
        bits either way."""
        max_seg = max(max((p.prep.max_seg for p in warm), default=1), 1)
        enabled = self._warm_batch
        if enabled is None:
            enabled = autotune.resolve_serve_warm_batch(len(warm), max_seg, self._entries(), self.device)["serve_warm_batch"]
        if not enabled or len(warm) < 2:
            for p in warm:
                self._dispatch_warm(p)
            return
        for bucket in self._buckets(warm, autotune.resolve_multisource(len(warm), max_seg, self._entries(), self.device)):
            self._dispatch_warm_bucket(bucket)

    def _dispatch_warm_bucket(self, bucket: list[_Pending]) -> None:
        """A bucket's refolds in one ``delta_refold_batch`` call (rung
        ``warm_batched``), then its fits through the batched
        ``compute_bucket``. A client the batch cannot serve demotes alone to
        the solo warm rung (the precision machinery choosing the exact path,
        not a degradation); a failure of the stacked dispatch walks the
        ``serve_warm`` ladder for the whole bucket, stamped degraded."""
        t0 = time.perf_counter()
        try:
            faultinject.fire("serve_warm_batch")
            phase_lists, t_refs, infos = deltafold.delta_refold_batch(
                [m.prep.tm for m in bucket], [m.prep.seg_times for m in bucket],
                tags=[m.req.client_id for m in bucket], device=self.device)
        except resilience.KernelError:
            raise
        except Exception as exc:  # stacked-refold domain: one serve_warm rung down
            self._demote_warm_bucket(bucket, exc, resilience.classify(exc))
            return
        keep: list[_Pending] = []
        kept_phases, kept_refs = [], []
        for m, pl, tr, info in zip(bucket, phase_lists, t_refs, infos):
            if pl is None:
                obs.counter_add("serve_warm_batch_demotes", 1)
                self._dispatch_warm(m)
                continue
            m.extra["fold_mode"] = info.get("mode") or "delta"
            keep.append(m)
            kept_phases.append(pl)
            kept_refs.append(tr)
        if not keep:
            return
        try:
            frames, _, _ = survey.compute_bucket([m.prep for m in keep], phase_lists=kept_phases,
                                                 t_refs=kept_refs, device=self.device)
        except resilience.KernelError:
            raise
        except Exception as exc:  # the batched fit shares the refold's domain
            self._demote_warm_bucket(keep, exc, resilience.classify(exc))
            return
        self.scheduler.observe(scheduler_mod.WARM_BATCH_RUNG, (time.perf_counter() - t0) / len(keep))
        obs.counter_add("serve_warm_batched", len(keep))
        for m, frame in zip(keep, frames):
            mode = m.extra["fold_mode"]
            obs.counter_add(f"serve_warm_{mode}", 1)
            m.result = RequestResult(client_id=m.req.client_id, status="degraded" if m.degraded else "ok",
                                     frame=frame, rung=scheduler_mod.WARM_BATCH_RUNG, path=f"delta_fold:{mode}")

    def _demote_warm_bucket(self, bucket: list[_Pending], exc, fkind) -> None:
        """The stacked dispatch failed: every member re-dispatches at the
        solo warm rung, stamped degraded (DATA_ERROR errors out instead)."""
        if fkind is FailureKind.DATA_ERROR:
            for m in bucket:
                m.result = self._error_result(m, resilience.error_record(exc))
            return
        resilience.record_degradation("serve_warm", "solo", fkind)
        obs.counter_add("serve_warm_batch_demotes", len(bucket))
        logger.warning("warm batch of %d failed (%s); demoting to solo warm dispatches", len(bucket), fkind.value,
                       exc_info=True)
        for m in bucket:
            m.degraded = True
            self._dispatch_warm(m)

    def _dispatch_warm(self, p: _Pending) -> None:
        t0 = time.perf_counter()
        try:
            faultinject.fire("serve_dispatch")
            frame = survey.measure_source_toas(p.req.spec, self.phShiftRes, self.nbrBins, self.varyAmps,
                                               _prep=p.prep, delta_fold=1, device=self.device)
        except resilience.KernelError:
            raise
        except Exception as exc:  # warm-path domain: bad data errors out, anything
            # else falls to the per-source rung, stamped degraded
            fkind = resilience.classify(exc)
            if fkind is FailureKind.DATA_ERROR:
                p.result = self._error_result(p, resilience.error_record(exc))
                return
            resilience.record_degradation("multisource", "per_source", fkind)
            p.degraded = True
            self._dispatch_solo(p)
            return
        mode = deltafold.last_fold_info().get("mode") or "exact"
        p.result = RequestResult(client_id=p.req.client_id, status="degraded" if p.degraded else "ok", frame=frame,
                                 rung=scheduler_mod.WARM_RUNG, path=f"delta_fold:{mode}")
        obs.counter_add(f"serve_warm_{mode}", 1)
        self.scheduler.observe(scheduler_mod.WARM_RUNG, time.perf_counter() - t0)

    # -- cold clients: batched continuous dispatch ----------------------------

    def _dispatch_cold(self, cold: list[_Pending]) -> None:
        max_seg = max(max((p.prep.max_seg for p in cold), default=1), 1)
        resolved = autotune.resolve_multisource(len(cold), max_seg, self._entries(), self.device)
        rung_groups: dict[str, list[_Pending]] = {}
        now = time.perf_counter()
        for p in cold:
            if not resolved["multisource"]:
                # knob off: the per-source loop is the configured path, not a degradation
                rung_groups.setdefault("per_source", []).append(p)
                p.rung = "per_source"
                continue
            remaining = None
            if p.req.deadline_s is not None and p.req.submitted_at is not None:
                remaining = p.req.deadline_s - (now - p.req.submitted_at)
            rung, forced = self.scheduler.pick_rung(remaining, self.breakers)
            if forced is not None and rung != self.scheduler.ladder[0]:
                resilience.record_degradation("multisource", rung, forced)
                obs.counter_add("serve_preemptive_degrades", 1)
                p.degraded = True
            p.rung = rung
            rung_groups.setdefault(rung, []).append(p)

        for rung in ("batched", "split_bucket"):
            if rung_groups.get(rung):
                self._dispatch_buckets(rung_groups[rung], rung, resolved)
        for p in rung_groups.get("per_source", ()):
            self._dispatch_solo(p)

    def _dispatch_buckets(self, items: list[_Pending], rung: str, resolved: dict) -> None:
        queue: deque[list[_Pending]] = deque()
        for bucket in self._buckets(items, resolved):
            if rung == "split_bucket" and len(bucket) > 1:
                # the rung the scheduler picked: half-buckets before dispatch
                mid = (len(bucket) + 1) // 2
                queue.append(bucket[:mid])
                queue.append(bucket[mid:])
            else:
                queue.append(bucket)

        while queue:
            bucket = queue.popleft()
            t0 = time.perf_counter()
            try:
                faultinject.fire("serve_dispatch")
                frames, phase_lists, t_refs = survey.compute_bucket([m.prep for m in bucket], device=self.device)
            except resilience.KernelError:
                raise
            except Exception as exc:  # the bucket domain walks the multisource
                # ladder as the survey does: split and retry, demote a singleton
                fkind = resilience.classify(exc)
                self.breakers.record_failure(rung, fkind)
                if len(bucket) > 1:
                    mid = (len(bucket) + 1) // 2
                    queue.appendleft(bucket[mid:])
                    queue.appendleft(bucket[:mid])
                    resilience.record_degradation("multisource", "split_bucket", fkind)
                    for m in bucket:
                        m.degraded = True
                    continue
                resilience.record_degradation("multisource", "per_source", fkind)
                for m in bucket:
                    m.degraded = True
                    self._dispatch_solo(m)
                continue
            self.breakers.record_success(rung)
            self.scheduler.observe(rung, (time.perf_counter() - t0) / len(bucket))
            for m, frame, pl, tr in zip(bucket, frames, phase_lists, t_refs):
                self._seed_client(m, pl, tr)
                m.result = RequestResult(client_id=m.req.client_id, status="degraded" if m.degraded else "ok",
                                         frame=frame, rung=m.rung or rung, path="batched")

    # -- the ladder floor: per-source -------------------------------------------

    def _dispatch_solo(self, p: _Pending) -> None:
        """The per-source floor. delta_fold=1 routes the fold through the
        cache, so the first request stores the exact product and the client's
        next request takes the cache-hit or refold path. A failure here ends
        as the classified error record: there is no pinned-CPU rung."""
        t0 = time.perf_counter()
        try:
            frame = survey.measure_source_toas(p.req.spec, self.phShiftRes, self.nbrBins, self.varyAmps,
                                               _prep=p.prep, delta_fold=1, device=self.device)
        except resilience.KernelError:
            raise
        except Exception as exc:  # per-source domain: the classified record
            p.result = self._error_result(p, resilience.error_record(exc))
            return
        # warm only when the fold cache confirms it stored this client's
        # product (cache off keeps the client cold)
        info = deltafold.last_fold_info()
        if info.get("stored") and info.get("tag") == p.req.client_id:
            self._warm.add(p.req.client_id)
        self.scheduler.observe("per_source", time.perf_counter() - t0)
        p.result = RequestResult(client_id=p.req.client_id, status="degraded" if p.degraded else "ok", frame=frame,
                                 rung=p.rung or "per_source", path="per_source")

    # -- shared plumbing --------------------------------------------------------

    def _entries(self) -> dict:
        """The verdict cache, read once per engine rather than every round."""
        if self._verdicts is None:
            self._verdicts = autotune.load_entries()
        return self._verdicts

    @staticmethod
    def _buckets(items: list[_Pending], resolved: dict) -> list[list[_Pending]]:
        """Requests grouped by (fit kind, config, template width), each group
        bucketed by padded event width as the survey buckets its sources."""
        groups: dict[tuple, list[_Pending]] = {}
        for p in items:
            groups.setdefault((p.prep.kind, p.prep.cfg, int(p.prep.tpl.n_comp)), []).append(p)
        return [[members[j] for j in b] for members in groups.values()
                for b in multisource.bucket_sources([max(m.prep.max_seg, 1) for m in members],
                                                    max_pad_ratio=resolved["max_pad"],
                                                    batch_cap=resolved["batch_cap"])]

    def _seed_client(self, m: _Pending, phase_list, t_ref) -> None:
        """Seed the fold cache from a batched fold (the solo fold's bits), so
        this client's next request re-times as one refold."""
        try:
            seg_times = m.prep.seg_times
            sizes = [t.size for t in seg_times]
            times_cat = np.concatenate(seg_times) if seg_times else np.zeros(0)
            phases_cat = np.concatenate([np.asarray(ph) for ph in phase_list]) if phase_list else np.zeros(0)
            key = deltafold.store_product(m.prep.tm, times_cat, sizes, np.asarray(t_ref), phases_cat,
                                          tag=m.req.client_id, device=self.device)
            if key is not None:  # cache tier off returns None: stay cold
                self._warm.add(m.req.client_id)
        except resilience.KernelError:
            raise
        except Exception as exc:  # seeding is a throughput optimization: its
            # failure is telemetry, never a request failure (the client stays cold)
            logger.warning("fold-cache seed failed for %s (%s)", m.req.client_id, resilience.error_record(exc))

    def _error_result(self, p: _Pending, rec: dict) -> RequestResult:
        obs.counter_add("serve_errors", 1)
        logger.warning("request %s failed: %s", p.req.client_id, rec)
        return RequestResult(client_id=p.req.client_id, status="error", rung=p.rung, kind=rec["kind"], error=rec)

    def _finalize(self, p: _Pending) -> None:
        res = p.result
        if p.req.submitted_at is not None:
            res.latency_s = time.perf_counter() - p.req.submitted_at
            if p.req.deadline_s is not None and res.latency_s > p.req.deadline_s:
                res.deadline_miss = True
                self.counts["deadline_miss"] += 1
                obs.counter_add("serve_deadline_miss", 1)
        self.counts[res.status] = self.counts.get(res.status, 0) + 1
        obs.counter_add(f"serve_{res.status}", 1)
        obs.record_span("serve_request", res.latency_s or 0.0, kind="request", client=res.client_id,
                        status=res.status, rung=res.rung or "", path=res.path or "")

    def stats(self) -> dict:
        """Admission, completion, breaker and scheduler state."""
        return {
            "admitted": self.queue.admitted,
            "rejected": self.queue.rejected,
            "pending": len(self.queue),
            "ok": self.counts["ok"],
            "degraded": self.counts["degraded"],
            "errors": self.counts["error"],
            "deadline_misses": self.counts["deadline_miss"],
            "steps": self.counts["steps"],
            "warm_clients": len(self._warm),
            "breakers": self.breakers.snapshot(),
            "rung_latency_est_s": self.scheduler.estimates(),
            "capacity": dict(self.capacity),
        }


__all__ = ["RequestResult", "ServingEngine"]
