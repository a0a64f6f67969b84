"""The port's serving engine (crimp_tpu_torch.serve.ServingEngine) against
crimp_tpu's on the same requests, on the CPU.

Inputs are tests/test_serve.py's small specs (two intervals of 60 events,
the two-harmonic Fourier template, phShiftRes 200). Two levels of parity,
as the engine's docstring states:

- bit for bit within the port: every seeded fold product equals the solo
  fold of the same client, and a warm client's refolded phases are the same
  bits on both warm rungs (``warm_batch`` 1 and 0); against crimp_tpu the
  folds and refolds agree within 1e-9 cycles, the port's fold tolerance
  (tests/test_torch_fold.py), since torch and XLA round the anchored fold
  apart;
- to the survey's parity contract: every frame against the port's solo
  ``measure_source_toas`` (tests/test_torch_survey.py's
  ``assert_matches_loop``) and against crimp_tpu's frame for the same
  request (phShift 1e-6 rad, phShift_LL/UL one profile step, Hpower 1e-5 and
  redChi2 1e-6 relative, ToA_mid 1e-13 relative, the rest exact).

Statuses, rungs, paths, degradations and the serve_* / delta_fold_*
counters equal crimp_tpu's where its tests pin them. Where the port differs
on purpose, the tests pin the port's behaviour: a per-source failure ends
as a classified error with no pinned-CPU rung, and a ``KernelError`` leaves
``step()`` from every catch site of the engine.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from crimp_tpu import obs as jax_obs
from crimp_tpu import serve as jax_serve
from crimp_tpu.ops import deltafold as jax_deltafold
from crimp_tpu.pipelines import survey as jax_survey
from crimp_tpu.resilience import faultinject as jax_faultinject
from crimp_tpu_torch import obs, serve
from crimp_tpu_torch.ops import anchored, deltafold
from crimp_tpu_torch.pipelines import survey
from crimp_tpu_torch.resilience import KernelError, faultinject
from crimp_tpu_torch.resilience.taxonomy import FailureKind
from crimp_tpu_torch.serve import breaker as breaker_mod
from crimp_tpu_torch.serve import scheduler as scheduler_mod
from tests.test_torch_survey import TPL, as_jax, assert_matches_loop

torch.set_num_threads(2)

RES = 200
FOLD_TOL = 1e-9  # cycles: the port's fold against crimp_tpu's
KNOB_SUFFIXES = ("FAULTS", "FOLD_CACHE", "DELTA_FOLD", "MULTISOURCE", "MULTISOURCE_MAX_PAD", "MULTISOURCE_BATCH",
                 "SERVE_QUEUE", "SERVE_DEADLINE_MS", "SERVE_BREAKER", "SERVE_WARM_BATCH", "SERVE_PREP_OVERLAP",
                 "OBS", "OBS_DIR")
SHARED_COUNTERS = ("serve_", "delta_fold_", "degrad")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        for suffix in KNOB_SUFFIXES:
            monkeypatch.delenv(f"{prefix}_{suffix}", raising=False)
        monkeypatch.setenv(f"{prefix}_AUTOTUNE", "0")
    for inj in (faultinject, jax_faultinject):
        inj.reset()
    for df in (deltafold, jax_deltafold):
        df.clear_cache()
    yield
    for inj in (faultinject, jax_faultinject):
        inj.reset()
    for df in (deltafold, jax_deltafold):
        df.clear_cache()


@pytest.fixture
def obs_on(monkeypatch, tmp_path):
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        monkeypatch.setenv(f"{prefix}_OBS", "1")
        monkeypatch.setenv(f"{prefix}_OBS_DIR", str(tmp_path / prefix.lower()))


def both_env(monkeypatch, suffix, value):
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        monkeypatch.setenv(f"{prefix}_{suffix}", value)
    faultinject.reset()
    jax_faultinject.reset()


def make_spec(i, rng, n_per=60, n_int=2, name=None):
    """tests/test_serve.py's spec: equal per-interval counts (exact padding)."""
    edges = np.linspace(58000.0, 58008.0, n_int + 1)
    times = np.sort(np.concatenate([rng.uniform(lo + 1e-6, hi - 1e-6, n_per) for lo, hi in zip(edges[:-1],
                                                                                              edges[1:])]))
    iv = {"ToA_tstart": edges[:-1], "ToA_tend": edges[1:],
          "ToA_exposure": np.full(n_int, (edges[1] - edges[0]) * 86400.0)}
    tm = {"PEPOCH": 58000.0, "F0": 0.14 + 0.003 * (i % 53), "F1": -1e-13}
    return survey.SourceSpec(name=name or f"src{i}", times=times, timing_model=tm, template=dict(TPL),
                             intervals=iv)


def reissue(spec, f0_bump=0.0):
    """The same client returning with a (possibly nudged) ephemeris."""
    return survey.SourceSpec(name=spec.name, times=spec.times,
                             timing_model={**spec.timing_model, "F0": spec.timing_model["F0"] + f0_bump},
                             template=dict(TPL), intervals=spec.intervals)


def port_engine(**kw):
    kw.setdefault("phShiftRes", RES)
    return serve.ServingEngine(device="cpu", **kw)


def jax_engine(**kw):
    kw.setdefault("phShiftRes", RES)
    return jax_serve.ServingEngine(**kw)


def rounds(eng, batches, as_ref=False):
    """Submit each batch of specs and step once per batch."""
    out = []
    for specs in batches:
        for s in specs:
            eng.submit(as_jax(s) if as_ref else s)
        out.append(eng.step())
    return out


def solo(spec):
    return survey.measure_source_toas(spec, phShiftRes=RES, device="cpu")


def assert_matches_jax(frame, ref, ctx=""):
    """The survey's contract against crimp_tpu's frame for the same request."""
    for col in ("ToA", "ToA_start", "ToA_end", "ToA_lenInt", "ToA_exp", "nbr_events", "count_rate"):
        np.testing.assert_array_equal(frame[col], ref[col].to_numpy(), err_msg=f"{ctx} {col}")
    np.testing.assert_allclose(frame["ToA_mid"], ref["ToA_mid"].to_numpy(), rtol=1e-13, err_msg=ctx)
    np.testing.assert_allclose(frame["phShift"], ref["phShift"].to_numpy(), rtol=0, atol=1e-6, err_msg=ctx)
    for col in ("phShift_LL", "phShift_UL"):
        assert np.max(np.abs(frame[col] - ref[col].to_numpy())) <= 2 * np.pi / RES * (1 + 1e-9), (ctx, col)
    np.testing.assert_allclose(frame["Hpower"], ref["Hpower"].to_numpy(), rtol=1e-5, err_msg=ctx)
    np.testing.assert_allclose(frame["redChi2"], ref["redChi2"].to_numpy(), rtol=1e-6, err_msg=ctx)


def labels(results):
    return [(r.client_id, r.status, r.rung, r.path, r.kind) for r in results]


def manifests():
    docs = []
    for path in (obs.last_manifest_path(), jax_obs.last_manifest_path()):
        with open(path) as fh:
            docs.append(json.load(fh))
    return docs


def shared(counters):
    return {k: v for k, v in counters.items() if k.startswith(SHARED_COUNTERS)}


def wrap_dev(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return float(np.max(np.minimum(d, 1.0 - d), initial=0.0))


@pytest.fixture
def seeded(monkeypatch):
    """Record the fold products each package seeds: {tag: phases}."""
    got = {"port": {}, "jax": {}}
    for key, mod in (("port", deltafold), ("jax", jax_deltafold)):
        real = mod.store_product

        def record(tm, times_cat, sizes, t_ref, phases, tag=None, _real=real, _into=got[key], **kw):
            _into[tag] = np.array(phases, dtype=np.float64)
            return _real(tm, times_cat, sizes, t_ref, phases, tag=tag, **kw)

        monkeypatch.setattr(mod, "store_product", record)
    return got


@pytest.fixture
def refolds(monkeypatch):
    """Record the port's refolded phases per client on both warm rungs."""
    got = {"batched": {}, "solo": {}}
    real_batch, real_fold = deltafold.delta_refold_batch, deltafold.cached_fold

    def batch(tms, seg_lists, tags=None, **kw):
        out = real_batch(tms, seg_lists, tags=tags, **kw)
        for tag, pl, info in zip(tags, out[0], out[2]):
            if pl is not None and info.get("mode") == "delta":
                got["batched"][tag] = np.concatenate(pl)
        return out

    def fold(*args, tag=None, **kw):
        folded, info = real_fold(*args, tag=tag, **kw)
        if info.get("mode") == "delta":
            got["solo"][tag] = np.array(folded)
        return folded, info

    monkeypatch.setattr(deltafold, "delta_refold_batch", batch)
    monkeypatch.setattr(deltafold, "cached_fold", fold)
    return got


class TestColdAndWarmParity:
    def test_cold_round_matches_jax_and_the_solo_path(self, obs_on, seeded):
        rng = np.random.RandomState(11)
        specs = [make_spec(i, rng) for i in range(3)]
        with obs.run("serve_parity"):
            (res,) = rounds(port_engine(), [specs])
        with jax_obs.run("serve_parity"):
            (ref,) = rounds(jax_engine(), [specs], as_ref=True)
        assert labels(res) == labels(ref)
        assert [r.rung for r in res] == ["batched"] * 3 and all(r.status == "ok" for r in res)
        for r, j, s in zip(res, ref, specs):
            assert_matches_loop(r.frame, solo(s), s.name)
            assert_matches_jax(r.frame, j.frame, s.name)
            prep = survey._prep_source(s, RES, 15, False)
            exact, _ = anchored.fold_segments(prep.tm, prep.seg_times, delta_fold=0, device="cpu")
            assert np.array_equal(seeded["port"][s.name], np.concatenate(exact)), s.name
            assert wrap_dev(seeded["port"][s.name], seeded["jax"][s.name]) < FOLD_TOL
        port_doc, jax_doc = manifests()
        assert shared(port_doc["counters"]) == shared(jax_doc["counters"])
        assert port_doc["counters"]["delta_fold_seeded"] == 3 and not port_doc["degraded"]

    def test_warm_unchanged_retiming_hits_the_cache(self, obs_on):
        rng = np.random.RandomState(12)
        specs = [make_spec(i, rng) for i in range(2)]
        batches = [specs, [reissue(s) for s in specs]]
        with obs.run("serve_warm"):
            _, warm = rounds(port_engine(), batches)
        with jax_obs.run("serve_warm"):
            _, jwarm = rounds(jax_engine(), batches, as_ref=True)
        assert labels(warm) == labels(jwarm)
        assert all(r.path == "delta_fold:cache" for r in warm)
        for r, j, s in zip(warm, jwarm, specs):
            assert_matches_loop(r.frame, solo(s), s.name)
            assert_matches_jax(r.frame, j.frame, s.name)
        port_doc, jax_doc = manifests()
        assert shared(port_doc["counters"]) == shared(jax_doc["counters"])

    @pytest.mark.parametrize("warm_batch", [0, 1])
    def test_perturbed_retiming_refolds_as_jax(self, obs_on, warm_batch):
        rng = np.random.RandomState(13)
        specs = [make_spec(i, rng) for i in range(3)]
        moved = [reissue(s, f0_bump=1e-11) for s in specs]
        with obs.run("serve_delta"):
            eng = port_engine(warm_batch=warm_batch)
            rounds(eng, [specs])
            before = dict(obs.active().counters)
            (warm,) = rounds(eng, [moved])
            after = dict(obs.active().counters)
        with jax_obs.run("serve_delta"):
            _, jwarm = rounds(jax_engine(warm_batch=warm_batch), [specs, moved], as_ref=True)
        assert labels(warm) == labels(jwarm)
        rung = scheduler_mod.WARM_BATCH_RUNG if warm_batch else scheduler_mod.WARM_RUNG
        assert [(r.status, r.rung, r.path) for r in warm] == [("ok", rung, "delta_fold:delta")] * 3
        # the steady-state pin: refolds moved, exact folds did not
        assert after["delta_fold_refolds"] - before.get("delta_fold_refolds", 0) == 3
        assert after.get("delta_fold_exact_folds", 0) == before.get("delta_fold_exact_folds", 0)
        for r, j, s in zip(warm, jwarm, moved):
            assert_matches_jax(r.frame, j.frame, s.name)
        port_doc, jax_doc = manifests()
        assert shared(port_doc["counters"]) == shared(jax_doc["counters"])

    def test_both_warm_rungs_refold_the_same_bits(self, obs_on, refolds, monkeypatch):
        """warm_batch=1 (one stacked refold) against warm_batch=0 (the
        per-request loop): the refolded phases are the same bits, the frames
        within the survey contract; and the refolds lie within 1e-9 cycles of
        crimp_tpu's stacked refold."""
        rng = np.random.RandomState(30)
        specs = [make_spec(i, rng) for i in range(3)]
        moved = [reissue(s, f0_bump=1e-11 * (i + 1)) for i, s in enumerate(specs)]
        arms = {}
        for pin in (0, 1):
            deltafold.clear_cache()
            arms[pin] = rounds(port_engine(warm_batch=pin), [specs, moved])[1]
        assert set(refolds["batched"]) == set(refolds["solo"]) == {s.name for s in specs}
        for s in specs:
            assert np.array_equal(refolds["batched"][s.name], refolds["solo"][s.name]), s.name
        for a, b in zip(arms[0], arms[1]):
            assert a.client_id == b.client_id
            assert_matches_loop(b.frame, a.frame, a.client_id)
        jax_refolds = {}
        real = jax_deltafold.delta_refold_batch

        def record(tms, seg_lists, tags=None, **kw):
            out = real(tms, seg_lists, tags=tags, **kw)
            for tag, pl in zip(tags, out[0]):
                jax_refolds[tag] = np.concatenate([np.asarray(p) for p in pl])
            return out

        monkeypatch.setattr(jax_deltafold, "delta_refold_batch", record)
        rounds(jax_engine(warm_batch=1), [specs, moved], as_ref=True)
        for s in specs:
            assert wrap_dev(refolds["batched"][s.name], jax_refolds[s.name]) < FOLD_TOL, s.name

    def test_guard_trip_demotes_only_the_offender(self, obs_on):
        rng = np.random.RandomState(33)
        specs = [make_spec(i, rng) for i in range(3)]
        moved = [reissue(specs[0], f0_bump=1.0), reissue(specs[1], f0_bump=1e-11), reissue(specs[2], f0_bump=1e-11)]
        with obs.run("serve_warm_guard"):
            _, warm = rounds(port_engine(warm_batch=1), [specs, moved])
        with jax_obs.run("serve_warm_guard"):
            _, jwarm = rounds(jax_engine(warm_batch=1), [specs, moved], as_ref=True)
        assert labels(warm) == labels(jwarm)
        by_id = {r.client_id: r for r in warm}
        assert (by_id["src0"].status, by_id["src0"].rung, by_id["src0"].path) == ("ok", "warm", "delta_fold:exact")
        port_doc, jax_doc = manifests()
        assert port_doc["counters"]["serve_warm_batch_demotes"] == 1 and not port_doc["degraded"]
        assert shared(port_doc["counters"]) == shared(jax_doc["counters"])
        for r, j, s in zip(warm, jwarm, moved):
            assert_matches_jax(r.frame, j.frame, s.name)

    def test_knob_off_pins_the_per_request_loop(self, obs_on, monkeypatch):
        both_env(monkeypatch, "SERVE_WARM_BATCH", "0")
        rng = np.random.RandomState(31)
        specs = [make_spec(i, rng) for i in range(2)]
        batches = [specs, [reissue(s) for s in specs]]
        _, warm = rounds(port_engine(), batches)
        _, jwarm = rounds(jax_engine(), batches, as_ref=True)
        assert labels(warm) == labels(jwarm)
        assert [r.rung for r in warm] == [scheduler_mod.WARM_RUNG] * 2

    def test_warm_rung_labels_never_move_the_cold_estimates(self):
        rng = np.random.RandomState(32)
        specs = [make_spec(i, rng) for i in range(2)]
        eng = port_engine(warm_batch=1)
        rounds(eng, [specs])
        cold_est = dict(eng.scheduler.estimates())
        (warm,) = rounds(eng, [[reissue(s, f0_bump=1e-11) for s in specs]])
        est = eng.scheduler.estimates()
        assert scheduler_mod.WARM_BATCH_RUNG in est and scheduler_mod.WARM_BATCH_RUNG not in scheduler_mod.LADDER
        for rung in scheduler_mod.LADDER:
            assert est.get(rung) == cold_est.get(rung)
        assert {r.rung for r in warm} == {scheduler_mod.WARM_BATCH_RUNG}

    def test_multisource_off_uses_per_source_without_degrading(self, obs_on, monkeypatch):
        both_env(monkeypatch, "MULTISOURCE", "0")
        rng = np.random.RandomState(14)
        spec = make_spec(0, rng)
        with obs.run("serve_msoff"):
            (res,) = rounds(port_engine(), [[spec]])
        with jax_obs.run("serve_msoff"):
            (ref,) = rounds(jax_engine(), [[spec]], as_ref=True)
        assert labels(res) == labels(ref) == [(spec.name, "ok", "per_source", "per_source", None)]
        monkeypatch.delenv("CRIMP_TORCH_MULTISOURCE")
        assert_matches_loop(res[0].frame, solo(spec), spec.name)
        assert not manifests()[0]["degraded"]

    def test_failed_seed_keeps_the_client_cold(self, monkeypatch):
        both_env(monkeypatch, "FOLD_CACHE", "0")
        rng = np.random.RandomState(35)
        specs = [make_spec(i, rng) for i in range(2)]
        eng = port_engine()
        _, again = rounds(eng, [specs, [reissue(s) for s in specs]])
        assert eng.stats()["warm_clients"] == 0
        _, jagain = rounds(jax_engine(), [specs, [reissue(s) for s in specs]], as_ref=True)
        assert labels(again) == labels(jagain) == [(s.name, "ok", "batched", "batched", None) for s in specs]


class TestFailures:
    def test_bad_spec_fails_classified_and_poisons_nothing(self, obs_on):
        rng = np.random.RandomState(15)
        good = make_spec(0, rng)
        bad = survey.SourceSpec(name="empty", times=np.zeros(0), timing_model={"PEPOCH": 58000.0, "F0": 0.1},
                                template=dict(TPL), intervals=good.intervals)
        (res,) = rounds(port_engine(), [[bad, good]])
        (ref,) = rounds(jax_engine(), [[bad, good]], as_ref=True)
        assert labels(res) == labels(ref)
        assert res[0].status == "error" and res[0].kind == FailureKind.DATA_ERROR.value
        assert {k: res[0].error[k] for k in ("kind", "type")} == {k: ref[0].error[k] for k in ("kind", "type")}
        assert_matches_loop(res[1].frame, solo(good), good.name)

    def test_preemptive_degrade_is_stamped_as_jax(self, obs_on):
        rng = np.random.RandomState(16)
        spec = make_spec(0, rng)
        out = []
        for eng, o, as_ref in ((port_engine(), obs, False), (jax_engine(), jax_obs, True)):
            eng.scheduler.observe("batched", 5.0)
            eng.scheduler.observe("split_bucket", 1e-4)
            with o.run("serve_deadline"):
                eng.submit(as_jax(spec) if as_ref else spec, deadline_s=0.5)
                out.append(eng.step())
        assert labels(out[0]) == labels(out[1]) == [(spec.name, "degraded", "split_bucket", "batched", None)]
        port_doc, jax_doc = manifests()
        assert port_doc["degradations"] == jax_doc["degradations"] == ["multisource:split_bucket:timeout"]
        assert port_doc["counters"]["serve_preemptive_degrades"] == 1

    def test_default_deadline_and_a_missed_deadline_still_completes(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_SERVE_DEADLINE_MS", "1500")
        rng = np.random.RandomState(17)
        eng = port_engine()
        assert eng.submit(make_spec(0, rng)).deadline_s == pytest.approx(1.5)
        eng.step()
        eng.submit(make_spec(1, rng), deadline_s=1e-9)
        (res,) = eng.step()
        assert res.status in ("ok", "degraded") and res.deadline_miss and res.frame is not None
        assert eng.stats()["deadline_misses"] == 1

    def test_dispatch_faults_degrade_every_request_as_jax(self, obs_on, monkeypatch):
        both_env(monkeypatch, "FAULTS", "device:serve_dispatch:1,oom:serve_dispatch:2")
        rng = np.random.RandomState(19)
        specs = [make_spec(i, rng) for i in range(3)]
        with obs.run("serve_chaos1"):
            (res,) = rounds(port_engine(), [specs])
        with jax_obs.run("serve_chaos1"):
            (ref,) = rounds(jax_engine(), [specs], as_ref=True)
        assert labels(res) == labels(ref)
        assert all(r.status in ("ok", "degraded") for r in res) and any(r.status == "degraded" for r in res)
        port_doc, jax_doc = manifests()
        assert port_doc["degradations"] == jax_doc["degradations"]
        assert shared(port_doc["counters"]) == shared(jax_doc["counters"])
        monkeypatch.delenv("CRIMP_TORCH_FAULTS")
        for r, s in zip(res, specs):
            assert_matches_loop(r.frame, solo(s), s.name)

    def test_breaker_cycle_lands_in_the_manifest_as_jax(self, obs_on, monkeypatch):
        rng = np.random.RandomState(20)
        specs = [make_spec(i, rng) for i in range(3)]
        out = []
        for pkg, o, as_ref in ((serve, obs, False), (jax_serve, jax_obs, True)):
            eng = (port_engine if not as_ref else jax_engine)(breakers=pkg.RungBreakers(threshold=1,
                                                                                          cooldown_calls=1))
            with o.run("serve_breaker"):
                both_env(monkeypatch, "FAULTS", "device:serve_dispatch:1+")
                (r1,) = rounds(eng, [[specs[0]]], as_ref)
                state1 = eng.breakers.state("batched")
                (r2,) = rounds(eng, [[specs[1]]], as_ref)
                state2 = eng.breakers.state("batched")
                for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
                    monkeypatch.delenv(f"{prefix}_FAULTS")
                (r3,) = rounds(eng, [[specs[2]]], as_ref)
                out.append((labels(r1 + r2 + r3), state1, state2, eng.breakers.state("batched")))
        assert out[0] == out[1]
        assert out[0][1:] == (breaker_mod.OPEN, breaker_mod.OPEN, breaker_mod.CLOSED)
        assert [lab[1] for lab in out[0][0]] == ["degraded", "degraded", "ok"]
        port_doc, jax_doc = manifests()
        breaker_counters = {k: v for k, v in port_doc["counters"].items() if k.startswith("serve_breaker")}
        assert breaker_counters == {k: v for k, v in jax_doc["counters"].items() if k.startswith("serve_breaker")}
        assert breaker_counters["serve_breaker_half_open_batched"] == 2

    def test_injected_warm_batch_fault_demotes_the_batch_as_jax(self, obs_on, monkeypatch):
        rng = np.random.RandomState(34)
        warm_specs = [make_spec(i, rng) for i in range(2)]
        cold = make_spec(7, rng, name="latecomer")
        out = []
        for make, o, as_ref in ((port_engine, obs, False), (jax_engine, jax_obs, True)):
            eng = make(warm_batch=1)
            with o.run("serve_warm_fault"):
                rounds(eng, [warm_specs], as_ref)
                both_env(monkeypatch, "FAULTS", "device:serve_warm_batch:1")
                out.append(rounds(eng, [[reissue(s, f0_bump=1e-11) for s in warm_specs] + [cold]], as_ref)[0])
                for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
                    monkeypatch.delenv(f"{prefix}_FAULTS")
        assert labels(out[0]) == labels(out[1])
        assert [(r.status, r.rung) for r in out[0]] == [("degraded", "warm")] * 2 + [("ok", "batched")]
        port_doc, jax_doc = manifests()
        assert port_doc["degradations"] == jax_doc["degradations"] == ["serve_warm:solo:device_lost"]
        assert port_doc["counters"]["serve_warm_batch_demotes"] == jax_doc["counters"]["serve_warm_batch_demotes"] == 2
        assert_matches_loop(out[0][2].frame, solo(cold), "latecomer")

    def test_loadgen_chaos_holds_the_contract(self, obs_on, monkeypatch):
        """tests/test_serve.py's chaos load: every admitted request completes,
        the injected admission fault is a counted rejection."""
        monkeypatch.setenv("CRIMP_TORCH_FAULTS", "device:serve_dispatch:1,oom:serve_dispatch:3,"
                                                 "timeout:serve_deadline:2,oom:serve_admission:3")
        faultinject.reset()
        rng = np.random.RandomState(21)
        base = [make_spec(i, rng) for i in range(2)]
        specs = [reissue(base[i % 2], f0_bump=1e-12 * (i // 2)) for i in range(8)]
        eng = port_engine(breakers=serve.RungBreakers(threshold=1, cooldown_calls=1))
        with obs.run("serve_chaos2"):
            summary = serve.run_load(eng, specs, rate_hz=200.0, seed=3, deadline_s=30.0)
        kinds = {k.value for k in FailureKind}
        assert all(r.status in ("ok", "degraded") or r.kind in kinds for r in summary["results"])
        assert summary["completed"] + summary["rejected"] == len(specs)
        assert summary["rejected"] >= 1 and summary["degraded"] >= 1 and summary["errors"] == 0
        assert summary["p99_latency_ms"] >= summary["p50_latency_ms"] > 0
        with open(obs.last_manifest_path()) as fh:
            doc = json.load(fh)
        assert doc["degraded"] and doc["counters"]["serve_rejected"] >= 1

    def test_per_source_failure_is_classified_with_no_cpu_rung(self, monkeypatch):
        """A device-shaped failure on the per-source floor ends as its
        classified error record; crimp_tpu would retry it on a pinned CPU,
        the port moves no work off the device it was given."""
        monkeypatch.setenv("CRIMP_TORCH_MULTISOURCE", "0")
        calls = []

        def lost(spec, *args, device=None, **kw):
            calls.append(device)
            raise RuntimeError("CUDA error: the device is lost (ECC error)")

        monkeypatch.setattr(survey, "measure_source_toas", lost)
        rng = np.random.RandomState(42)
        (res,) = rounds(port_engine(), [[make_spec(0, rng)]])
        assert len(res) == 1 and res[0].status == "error"
        assert res[0].kind == FailureKind.DEVICE_LOST.value and res[0].error["type"] == "RuntimeError"
        assert calls == [torch.device("cpu")]  # one attempt, on the engine's device

    @pytest.mark.parametrize("site", ["prep", "warm_refold", "warm_fit", "warm_solo", "bucket", "solo", "seed"])
    def test_kernel_error_escapes_step(self, monkeypatch, site):
        """No catch site of the engine classifies or demotes a KernelError:
        a K4 failure in a warm batch is neither retried on the solo rung nor
        folded exactly, and a cold or solo one is no error record."""
        rng = np.random.RandomState(43)
        specs = [make_spec(i, rng) for i in range(2)]
        eng = port_engine(warm_batch=0 if site == "warm_solo" else 1, prep_overlap=False)
        warm = site.startswith("warm")
        if warm:
            rounds(eng, [specs])
            specs = [reissue(s, f0_bump=1e-11) for s in specs]
        if site == "solo":
            monkeypatch.setenv("CRIMP_TORCH_MULTISOURCE", "0")

        def boom(*args, **kw):
            raise KernelError("deltafold_refold: CUDA error 700 (an illegal memory access)")

        solo_calls = []
        real_solo, real_bucket = survey.measure_source_toas, survey.compute_bucket
        target = {"prep": (survey, "_prep_source"), "warm_refold": (deltafold, "refold_batch"),
                  "warm_solo": (deltafold, "refold"), "solo": (survey, "measure_source_toas"),
                  "bucket": (survey, "compute_bucket"), "seed": (deltafold, "store_product")}.get(site)
        if target is not None:
            monkeypatch.setattr(*target, boom)
        if site == "warm_fit":
            monkeypatch.setattr(survey, "compute_bucket",
                                lambda ps, phase_lists=None, **kw: boom() if phase_lists is not None
                                else real_bucket(ps, phase_lists=phase_lists, **kw))
        if site != "solo":
            monkeypatch.setattr(survey, "measure_source_toas",
                                lambda *a, **kw: solo_calls.append(1) or real_solo(*a, **kw))
        for s in specs:
            eng.submit(s)
        with pytest.raises(KernelError):
            eng.step()
        if site in ("warm_refold", "warm_fit"):
            assert not solo_calls  # never demoted to the solo rung

    def test_bucket_queue_keeps_results_and_order(self, monkeypatch):
        """200 buckets, two of which fail once and split: every request
        resolves in place, the split halves retried right after the failure."""
        from crimp_tpu_torch.serve.engine import ServingEngine, _Pending

        items = []
        for i in range(400):
            name = f"g{i // 2:03d}m{i % 2}"
            p = _Pending(req=serve.TimingRequest(spec=SimpleNamespace(name=name)))
            p.prep = SimpleNamespace(kind="fourier", cfg=f"cfg{i // 2:03d}", tpl=SimpleNamespace(n_comp=2),
                                     max_seg=60, name=name)
            p.rung = "batched"
            items.append(p)
        calls, fail_once = [], {"cfg007", "cfg123"}

        def stub_compute(ps, phase_lists=None, t_refs=None, device=None):
            names = [p.name for p in ps]
            calls.append(names)
            grp = names[0][:4].replace("g", "cfg")
            if len(ps) > 1 and grp in fail_once:
                fail_once.discard(grp)
                raise RuntimeError("injected bucket failure")
            return [f"frame-{n}" for n in names], [None] * len(ps), [None] * len(ps)

        monkeypatch.setattr(survey, "compute_bucket", stub_compute)
        monkeypatch.setattr(ServingEngine, "_seed_client", lambda self, m, pl, tr: None)
        port_engine()._dispatch_buckets(items, "batched", {"max_pad": 0.3, "batch_cap": 2})
        assert [p.result.frame for p in items] == [f"frame-{p.req.client_id}" for p in items]
        assert [p.req.client_id for p in items if p.result.status == "degraded"] == ["g007m0", "g007m1", "g123m0",
                                                                                      "g123m1"]
        i7 = calls.index(["g007m0", "g007m1"])
        assert calls[i7 + 1] == ["g007m0"] and calls[i7 + 2] == ["g007m1"]


class TestPrepOverlapAndLifecycle:
    def test_overlap_is_bitwise_with_serial_prep(self, monkeypatch):
        """Three rounds (cold, warm cache, warm delta) with admissions landing
        while the previous round's prep futures drain: overlapped prep gives
        the serial arm's frames bit for bit, pinned by the constructor and by
        CRIMP_TORCH_SERVE_PREP_OVERLAP."""
        rng = np.random.RandomState(38)
        specs = [make_spec(i, rng) for i in range(3)]
        batches = [specs, [reissue(s) for s in specs] + [reissue(s, f0_bump=1e-11) for s in specs]]
        arms = []
        for pin, env in ((False, None), (True, None), (None, "0"), (None, "1")):
            if env is not None:
                monkeypatch.setenv("CRIMP_TORCH_SERVE_PREP_OVERLAP", env)
            deltafold.clear_cache()
            arms.append(rounds(port_engine(prep_overlap=pin), batches))
        for arm in arms[1:]:
            for r_ref, r_arm in zip(arms[0], arm):
                assert labels(r_ref) == labels(r_arm)
                for a, b in zip(r_ref, r_arm):
                    for col in survey.SURVEY_TOA_COLUMNS:
                        assert np.array_equal(a.frame[col], b.frame[col]), (a.client_id, col)

    def test_knob_pins_serial_prep(self, monkeypatch):
        rng = np.random.RandomState(37)
        assert port_engine()._prep_overlap_on()
        monkeypatch.setenv("CRIMP_TORCH_SERVE_PREP_OVERLAP", "0")
        eng = port_engine()
        assert not eng._prep_overlap_on() and port_engine(prep_overlap=True)._prep_overlap_on()
        eng.submit(make_spec(0, rng))
        assert not eng._prep_futures

    def test_close_is_deterministic_idempotent_and_rejects(self):
        rng = np.random.RandomState(39)
        with port_engine(prep_overlap=True) as eng:
            eng.submit(make_spec(0, rng))
            workers = list(eng._prep_pool._threads)
        assert all(not t.is_alive() for t in workers)
        assert eng._prep_pool is None and not eng._prep_futures
        eng.close()
        with pytest.raises(serve.AdmissionRejected) as exc:
            eng.submit(make_spec(1, rng))
        assert exc.value.kind is FailureKind.RESOURCE_EXHAUSTED

    def test_device_mesh_and_warmup(self, monkeypatch):
        # a mesh is a capacity note now (parallel.mesh); it changes no result
        from crimp_tpu_torch.parallel import mesh as pmesh

        noted = serve.ServingEngine(mesh=pmesh.build_mesh(["cpu"] * 2), device="cpu")
        assert noted.capacity["devices"] == 2 and noted.capacity["mesh_axes"] == {"events": 2, "trials": 1}
        noted.close()
        assert port_engine().warmup() == {"device": "cpu", "built": {}, "seconds": 0.0}
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.ServingEngine()

    def test_saturating_low_traffic_cannot_starve_high(self):
        rng = np.random.RandomState(41)
        eng = port_engine(queue=serve.AdmissionQueue(capacity=4))
        for i in range(4):
            eng.submit(make_spec(i, rng, name=f"low{i}"), priority="low")
        with pytest.raises(serve.AdmissionRejected):
            eng.submit(make_spec(9, rng, name="lowX"), priority="low")
        for i in range(2):
            eng.submit(make_spec(10 + i, rng, name=f"high{i}"), priority="high")
        res = eng.step()
        assert [r.client_id for r in res[:2]] == ["high0", "high1"] and all(r.status == "ok" for r in res)


class TestOffPath:
    def test_survey_traffic_is_unchanged_by_serving_traffic(self, obs_on):
        """The same survey calls give the same bits before and after the
        engine served traffic (serving seeds its own cache slots only)."""
        rng = np.random.RandomState(23)
        specs = [make_spec(i, rng) for i in range(3)]
        before = [solo(s) for s in specs] + survey.survey_measure_toas(specs, phShiftRes=RES, device="cpu")
        rounds(port_engine(), [specs, [reissue(s, f0_bump=1e-11) for s in specs]])
        after = [solo(s) for s in specs] + survey.survey_measure_toas(specs, phShiftRes=RES, device="cpu")
        for fa, fb in zip(before, after):
            for col in survey.SURVEY_TOA_COLUMNS:
                assert np.array_equal(fa[col], fb[col]), col

    def test_serve_knobs_unread_off_path(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_SERVE_QUEUE", "garbage")
        survey.measure_source_toas(make_spec(0, np.random.RandomState(24)), phShiftRes=RES, device="cpu")
        jax_survey.measure_source_toas(as_jax(make_spec(0, np.random.RandomState(24))), phShiftRes=RES)
