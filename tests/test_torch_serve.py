"""The port's serving state machines (crimp_tpu_torch.serve) against
crimp_tpu.serve on the same call sequences.

- admission: the same offers give the same admissions, rejections and
  taxonomy kinds, and the weighted deficit-round-robin drain pops the same
  clients in the same order, on seeded random sequences of offers and
  partial drains;
- breakers: the same allow / success / failure sequence gives the same
  answers, states, snapshots and transition counters (CLOSED -> OPEN ->
  HALF_OPEN -> CLOSED or OPEN, deterministic in calls);
- scheduler: the same observations and budgets pick the same rungs with the
  same forcing kinds, and the EWMA estimates agree to 1e-15;
- load generator: ``poisson_arrivals`` is bitwise crimp_tpu's, and latency
  runs from the scheduled arrival (queue wait shows);
- each knob is read under the port's prefix only (CRIMP_TORCH_SERVE_*);
  crimp_tpu's CRIMP_TPU_SERVE_* steer nothing here.
"""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from crimp_tpu import obs as jax_obs
from crimp_tpu import serve as jax_serve
from crimp_tpu.resilience import faultinject as jax_faultinject
from crimp_tpu.resilience.taxonomy import FailureKind as JaxKind
from crimp_tpu_torch import obs, serve
from crimp_tpu_torch.resilience import faultinject
from crimp_tpu_torch.resilience.taxonomy import FailureKind
from crimp_tpu_torch.serve import breaker as breaker_mod
from crimp_tpu_torch.serve import scheduler as scheduler_mod

torch.set_num_threads(2)

SERVE_SUFFIXES = ("SERVE_QUEUE", "SERVE_DEADLINE_MS", "SERVE_BREAKER", "SERVE_WARM_BATCH", "SERVE_PREP_OVERLAP",
                  "FAULTS", "OBS", "OBS_DIR")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        for suffix in SERVE_SUFFIXES:
            monkeypatch.delenv(f"{prefix}_{suffix}", raising=False)
    faultinject.reset()
    jax_faultinject.reset()
    yield
    faultinject.reset()
    jax_faultinject.reset()


@pytest.fixture
def obs_on(monkeypatch, tmp_path):
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        monkeypatch.setenv(f"{prefix}_OBS", "1")
        monkeypatch.setenv(f"{prefix}_OBS_DIR", str(tmp_path / prefix.lower()))


def _counters(path) -> dict:
    with open(path) as fh:
        return json.load(fh)["counters"]


def _client(name):
    return SimpleNamespace(name=name)


def _outcome(pkg, fn):
    """'ok' and the return value, or the rejection's kind value."""
    try:
        return "ok", fn()
    except pkg.AdmissionRejected as exc:
        return "rejected", exc.kind.value


class TestAdmission:
    def test_capacity_knob(self, monkeypatch):
        assert serve.queue_capacity() == jax_serve.queue_capacity() == 64
        monkeypatch.setenv("CRIMP_TORCH_SERVE_QUEUE", "3")
        assert serve.queue_capacity() == 3
        for bad in ("0", "lots"):
            monkeypatch.setenv("CRIMP_TORCH_SERVE_QUEUE", bad)
            with pytest.raises(ValueError, match="CRIMP_TORCH_SERVE_QUEUE"):
                serve.queue_capacity()

    @pytest.mark.parametrize("case", ["not_a_request", "no_name", "zero_deadline", "nan_deadline",
                                      "unknown_priority"])
    def test_malformed_requests_reject_as_jax(self, case):
        def make(pkg):
            return {"not_a_request": lambda: _client("x"),
                    "no_name": lambda: pkg.TimingRequest(spec=_client("")),
                    "zero_deadline": lambda: pkg.TimingRequest(spec=_client("x"), deadline_s=0.0),
                    "nan_deadline": lambda: pkg.TimingRequest(spec=_client("x"), deadline_s=float("nan")),
                    "unknown_priority": lambda: pkg.TimingRequest(spec=_client("x"), priority="urgent")}[case]()

        q, jq = serve.AdmissionQueue(capacity=2), jax_serve.AdmissionQueue(capacity=2)
        got = _outcome(serve, lambda: q.offer(make(serve)))
        want = _outcome(jax_serve, lambda: jq.offer(make(jax_serve)))
        assert got == want == ("rejected", FailureKind.DATA_ERROR.value)
        assert (q.admitted, q.rejected, len(q)) == (jq.admitted, jq.rejected, len(jq)) == (0, 1, 0)

    def test_full_queue_is_typed_backpressure_as_jax(self, obs_on):
        port, ref = [], []
        with obs.run("admission"):
            q = serve.AdmissionQueue(capacity=2)
            for i in range(3):
                port.append(_outcome(serve, lambda: q.offer(serve.TimingRequest(spec=_client(f"c{i}"))).client_id))
            port.append([r.client_id for r in q.drain()])
            port.append(_outcome(serve, lambda: q.offer(serve.TimingRequest(spec=_client("c3"))).client_id))
        with jax_obs.run("admission"):
            jq = jax_serve.AdmissionQueue(capacity=2)
            for i in range(3):
                ref.append(_outcome(jax_serve,
                                    lambda: jq.offer(jax_serve.TimingRequest(spec=_client(f"c{i}"))).client_id))
            ref.append([r.client_id for r in jq.drain()])
            ref.append(_outcome(jax_serve, lambda: jq.offer(jax_serve.TimingRequest(spec=_client("c3"))).client_id))
        assert port == ref
        assert port[2] == ("rejected", FailureKind.RESOURCE_EXHAUSTED.value)
        assert _counters(obs.last_manifest_path()) == _counters(jax_obs.last_manifest_path())

    def test_injected_admission_fault_rejects_classified_as_jax(self, monkeypatch):
        for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
            monkeypatch.setenv(f"{prefix}_FAULTS", "device:serve_admission:2")
        q, jq = serve.AdmissionQueue(capacity=4), jax_serve.AdmissionQueue(capacity=4)
        got = [_outcome(serve, lambda: q.offer(serve.TimingRequest(spec=_client(f"c{i}"))).client_id)
               for i in range(3)]
        want = [_outcome(jax_serve, lambda: jq.offer(jax_serve.TimingRequest(spec=_client(f"c{i}"))).client_id)
                for i in range(3)]
        assert got == want
        assert got[1] == ("rejected", FailureKind.DEVICE_LOST.value)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_drain_order_matches_jax(self, seed):
        """Seeded random offers across the three classes (some past a class's
        bound), interleaved with partial drains: the same admissions and
        rejections, and the deficit round-robin pops the same clients."""
        rng = np.random.RandomState(seed)
        q, jq = serve.AdmissionQueue(capacity=5), jax_serve.AdmissionQueue(capacity=5)
        classes = list(serve.PRIORITY_CLASSES)
        assert serve.PRIORITY_CLASSES == jax_serve.PRIORITY_CLASSES
        got, want = [], []
        for i in range(120):
            if rng.uniform() < 0.2:
                n = int(rng.randint(0, 9)) or None
                got.append([r.client_id for r in q.drain(n)])
                want.append([r.client_id for r in jq.drain(n)])
                continue
            cls = classes[rng.choice(3, p=[0.2, 0.3, 0.5])]
            got.append(_outcome(serve, lambda: q.offer(serve.TimingRequest(spec=_client(f"{cls}{i}"),
                                                                           priority=cls)).client_id))
            want.append(_outcome(jax_serve, lambda: jq.offer(jax_serve.TimingRequest(spec=_client(f"{cls}{i}"),
                                                                                     priority=cls)).client_id))
        got.append([r.client_id for r in q.drain()])
        want.append([r.client_id for r in jq.drain()])
        assert got == want
        assert any(isinstance(o, tuple) and o[0] == "rejected" for o in got)
        assert (q.admitted, q.rejected) == (jq.admitted, jq.rejected)

    def test_per_class_bounds_isolate_backpressure(self):
        q = serve.AdmissionQueue(capacity=2)
        for i in range(2):
            q.offer(serve.TimingRequest(spec=_client(f"low{i}"), priority="low"))
        with pytest.raises(serve.AdmissionRejected) as e:
            q.offer(serve.TimingRequest(spec=_client("low2"), priority="low"))
        assert e.value.kind is FailureKind.RESOURCE_EXHAUSTED
        assert q.offer(serve.TimingRequest(spec=_client("high0"), priority="high")).priority == "high"
        assert [r.client_id for r in q.drain()] == ["high0", "low0", "low1"]


def _breaker_script(seed, n=200):
    """A seeded call sequence over two rungs: allow / success / failure."""
    rng = np.random.RandomState(seed)
    kinds = [k.value for k in FailureKind]
    return [(("allow", "success", "failure")[rng.choice(3, p=[0.5, 0.2, 0.3])], ("batched", "split_bucket")[
        rng.randint(2)], kinds[rng.randint(len(kinds))]) for _ in range(n)]


class TestBreaker:
    def test_threshold_knob(self, monkeypatch):
        assert serve.breaker_threshold() == jax_serve.breaker_threshold() == breaker_mod.DEFAULT_THRESHOLD
        monkeypatch.setenv("CRIMP_TORCH_SERVE_BREAKER", "2")
        assert serve.breaker_threshold() == 2
        monkeypatch.setenv("CRIMP_TORCH_SERVE_BREAKER", "many")
        with pytest.raises(ValueError, match="CRIMP_TORCH_SERVE_BREAKER"):
            serve.breaker_threshold()

    @pytest.mark.parametrize("threshold,cooldown,seed", [(1, 1, 0), (2, 3, 1), (3, 2, 2), (5, 8, 3), (0, 8, 4)])
    def test_transitions_and_counters_match_jax(self, obs_on, threshold, cooldown, seed):
        script = _breaker_script(seed)

        def drive(pkg, kind_cls):
            b = pkg.RungBreakers(threshold=threshold, cooldown_calls=cooldown)
            trace = []
            for op, rung, kind in script:
                if op == "allow":
                    trace.append(b.allow(rung))
                elif op == "success":
                    b.record_success(rung)
                else:
                    b.record_failure(rung, kind_cls(kind))
                last = b.last_kind(rung)
                trace.append((b.state(rung), None if last is None else last.value))
            return trace, b.snapshot()

        with obs.run("breaker"):
            got = drive(serve, FailureKind)
        with jax_obs.run("breaker"):
            want = drive(jax_serve, JaxKind)
        assert got == want
        counters = _counters(obs.last_manifest_path())
        assert counters == _counters(jax_obs.last_manifest_path())
        if threshold:
            assert counters.get("serve_breaker_open", 0) >= 1
        if threshold and cooldown < 8:
            assert counters.get("serve_breaker_half_open", 0) >= 1

    def test_full_cycle_is_deterministic_in_calls(self):
        b = serve.RungBreakers(threshold=2, cooldown_calls=3)
        b.record_failure("batched", FailureKind.DEVICE_LOST)
        assert b.state("batched") == breaker_mod.CLOSED
        b.record_failure("batched", FailureKind.DEVICE_LOST)
        assert b.state("batched") == breaker_mod.OPEN
        assert [b.allow("batched") for _ in range(3)] == [False, False, True]  # the third denial half-opens
        assert b.state("batched") == breaker_mod.HALF_OPEN and not b.allow("batched")  # one probe at a time
        b.record_success("batched")
        assert b.state("batched") == breaker_mod.CLOSED and b.allow("split_bucket")


def _scheduler_script(seed, n=150):
    rng = np.random.RandomState(seed)
    rungs = scheduler_mod.LADDER + (scheduler_mod.WARM_RUNG, scheduler_mod.WARM_BATCH_RUNG)
    out = []
    for _ in range(n):
        if rng.uniform() < 0.5:
            out.append(("observe", rungs[rng.randint(len(rungs))], float(rng.exponential(0.05))))
        else:
            budget = None if rng.uniform() < 0.2 else float(rng.uniform(-0.01, 0.12))
            out.append(("pick", budget, bool(rng.uniform() < 0.5)))
    return out


class TestScheduler:
    def test_ladders_and_labels_are_jax(self):
        assert scheduler_mod.LADDER == jax_serve.LADDER == ("batched", "split_bucket", "per_source")
        assert (scheduler_mod.WARM_BATCH_RUNG, scheduler_mod.WARM_RUNG) == (jax_serve.WARM_BATCH_RUNG,
                                                                            jax_serve.WARM_RUNG)
        assert scheduler_mod.EWMA_ALPHA == 0.3

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_picks_and_ewma_match_jax(self, seed):
        script = _scheduler_script(seed)

        def drive(pkg, breakers):
            s = pkg.DeadlineScheduler()
            picks, ests = [], []
            for step in script:
                if step[0] == "observe":
                    s.observe(step[1], step[2])
                    ests.append(s.estimates())
                else:
                    rung, forced = s.pick_rung(step[1], breakers if step[2] else None)
                    picks.append((rung, None if forced is None else forced.value))
            return picks, ests

        b = serve.RungBreakers(threshold=1, cooldown_calls=2)
        jb = jax_serve.RungBreakers(threshold=1, cooldown_calls=2)
        b.record_failure("batched", FailureKind.RESOURCE_EXHAUSTED)
        jb.record_failure("batched", JaxKind.RESOURCE_EXHAUSTED)
        picks, ests = drive(serve, b)
        jpicks, jests = drive(jax_serve, jb)
        assert picks == jpicks
        assert {p[0] for p in picks} >= {"batched", "split_bucket", "per_source"}
        assert len(ests) == len(jests)
        for e, j in zip(ests, jests):
            assert e.keys() == j.keys()
            for rung in e:
                assert abs(e[rung] - j[rung]) <= 1e-15, rung

    def test_default_deadline_knob(self, monkeypatch):
        assert scheduler_mod.default_deadline_s() is None
        monkeypatch.setenv("CRIMP_TORCH_SERVE_DEADLINE_MS", "1500")
        assert scheduler_mod.default_deadline_s() == pytest.approx(1.5)
        monkeypatch.setenv("CRIMP_TORCH_SERVE_DEADLINE_MS", "-3")
        with pytest.raises(ValueError, match="CRIMP_TORCH_SERVE_DEADLINE_MS"):
            scheduler_mod.default_deadline_s()

    def test_injected_deadline_fault_forces_bottom_rung_as_jax(self, monkeypatch):
        for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
            monkeypatch.setenv(f"{prefix}_FAULTS", "timeout:serve_deadline:1")
        rung, forced = serve.DeadlineScheduler().pick_rung(10.0)
        jrung, jforced = jax_serve.DeadlineScheduler().pick_rung(10.0)
        assert (rung, forced.value) == (jrung, jforced.value) == ("per_source", "timeout")


class _StubEngine:
    """A one-request-per-round engine whose round takes ``dt`` seconds."""

    def __init__(self, dt, capacity=64):
        self.queue = serve.AdmissionQueue(capacity=capacity)
        self.dt = dt

    def submit(self, req):
        return self.queue.offer(req)

    def step(self):
        time.sleep(self.dt)
        out = []
        for req in self.queue.drain(1):
            out.append(serve.RequestResult(client_id=req.client_id, status="ok",
                                           latency_s=time.perf_counter() - req.submitted_at))
        return out


class TestLoadgen:
    @pytest.mark.parametrize("rate,n,seed", [(5.0, 100, 7), (200.0, 8, 3), (0.5, 1, 0), (1e4, 1000, 11)])
    def test_poisson_arrivals_bitwise_jax(self, rate, n, seed):
        a = serve.poisson_arrivals(rate, n, seed=seed)
        assert np.array_equal(a, jax_serve.poisson_arrivals(rate, n, seed=seed))
        assert np.array_equal(a, serve.poisson_arrivals(rate, n, seed=seed)) and np.all(np.diff(a) > 0)

    def test_bad_rates_and_counts_raise(self):
        with pytest.raises(ValueError):
            serve.poisson_arrivals(0.0, 10)
        with pytest.raises(ValueError):
            serve.poisson_arrivals(5.0, 0)

    def test_latency_runs_from_the_scheduled_arrival(self):
        """Five arrivals within ~5 ms, served one per 20 ms round: the last
        waits four rounds, and its latency says so (no coordinated omission)."""
        specs = [_client(f"c{i}") for i in range(5)]
        summary = serve.run_load(_StubEngine(0.02), specs, rate_hz=1000.0, seed=0)
        assert summary["completed"] == 5 and summary["ok"] == 5 and summary["rejected"] == 0
        lat = sorted(r.latency_s for r in summary["results"])
        assert lat[-1] >= 4 * 0.02
        assert summary["p99_latency_ms"] >= summary["p50_latency_ms"] > 0
        assert summary["requests_per_s"] == pytest.approx(5 / summary["wall_s"])

    def test_overload_rejections_are_measured_not_raised(self):
        specs = [_client(f"c{i}") for i in range(6)]
        summary = serve.run_load(_StubEngine(0.05, capacity=1), specs, rate_hz=2000.0, seed=1)
        assert summary["rejected"] >= 1
        assert summary["completed"] + summary["rejected"] == len(specs)


class TestKnobPrefix:
    def test_crimp_tpu_serve_knobs_steer_nothing(self, monkeypatch):
        for suffix, value in (("SERVE_QUEUE", "1"), ("SERVE_BREAKER", "garbage"), ("SERVE_DEADLINE_MS", "x"),
                              ("SERVE_WARM_BATCH", "7"), ("SERVE_PREP_OVERLAP", "maybe")):
            monkeypatch.setenv(f"CRIMP_TPU_{suffix}", value)
        assert serve.queue_capacity() == 64
        assert serve.breaker_threshold() == 5
        assert scheduler_mod.default_deadline_s() is None
        from crimp_tpu_torch.ops import autotune

        monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE", "0")
        assert autotune.resolve_serve_warm_batch(4, 60) == {"serve_warm_batch": 1}
        eng = serve.ServingEngine(device="cpu")
        assert eng._prep_overlap_on() and eng.queue.capacity == 64 and eng.breakers.threshold == 5
