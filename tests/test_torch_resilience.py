"""The port's resilience layer (crimp_tpu_torch.resilience) and its ladders
against crimp_tpu.resilience on the same faults.

- taxonomy: crimp_tpu's cases classify the same; torch's out-of-memory
  type is RESOURCE_EXHAUSTED; a lost card (no CUDA-capable device, ECC, a
  GPU fallen off the bus) is DEVICE_LOST; a kernel fault (illegal memory
  access, misaligned address, device-side assert, unspecified launch
  failure) is UNKNOWN, as is a ``KernelError``;
- the fault injector keeps crimp_tpu's grammar under CRIMP_TORCH_FAULTS and
  never reads crimp_tpu's knob;
- every ladder (grid, fold, mcmc, multisource) steps as crimp_tpu's does
  under each injected fault, with the same ``degraded_*`` counters and
  degradation reasons (tests/test_resilience.py's chaos cases), and the
  results are the lower rung's bits;
- no ladder ever catches a ``KernelError``.
"""

import errno
import json

import numpy as np
import pandas as pd
import pytest
import torch

from crimp_tpu import obs as jax_obs
from crimp_tpu.ops import anchored as jax_anchored
from crimp_tpu.ops import deltafold as jax_deltafold
from crimp_tpu.ops import search as jax_search
from crimp_tpu.pipelines import survey as jax_survey
from crimp_tpu.resilience import faultinject as jax_faultinject
from crimp_tpu.resilience import policy as jax_policy
from crimp_tpu.resilience import taxonomy as jax_taxonomy
from crimp_tpu_torch import obs, resilience
from crimp_tpu_torch.ops import anchored, deltafold, multisource, search
from crimp_tpu_torch.pipelines import survey
from crimp_tpu_torch.resilience import faultinject, policy, taxonomy
from crimp_tpu_torch.resilience.taxonomy import FailureKind, KernelError

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("CRIMP_TORCH_FAULTS", "CRIMP_TPU_FAULTS", "CRIMP_TORCH_GRID_MXU", "CRIMP_TORCH_FOLD_CACHE",
                 "CRIMP_TPU_FOLD_CACHE", "CRIMP_TORCH_MULTISOURCE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE", "0")
    faultinject.reset()
    jax_faultinject.reset()
    deltafold.clear_cache()
    jax_deltafold.clear_cache()
    yield
    faultinject.reset()
    jax_faultinject.reset()


@pytest.fixture
def obs_on(monkeypatch, tmp_path):
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        monkeypatch.setenv(f"{prefix}_OBS", "1")
        monkeypatch.setenv(f"{prefix}_OBS_DIR", str(tmp_path / prefix.lower()))
        monkeypatch.setenv(f"{prefix}_OBS_HEARTBEAT_S", "0")


def arm(monkeypatch, spec):
    """The same fault plan in both packages."""
    monkeypatch.setenv("CRIMP_TORCH_FAULTS", spec)
    monkeypatch.setenv("CRIMP_TPU_FAULTS", spec)
    faultinject.reset()
    jax_faultinject.reset()


def manifests():
    """(port manifest, crimp_tpu manifest) of the last runs."""
    with open(obs.last_manifest_path()) as fh:
        port = json.load(fh)
    with open(jax_obs.last_manifest_path()) as fh:
        ref = json.load(fh)
    return port, ref


def degraded(doc) -> dict:
    return {k: v for k, v in doc["counters"].items() if k.startswith(("degrad", "quarantined"))}


def assert_same_ladder(port, ref):
    assert port["degraded"] == ref["degraded"]
    assert port["degradations"] == ref["degradations"]
    assert degraded(port) == degraded(ref)


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------


def _json_error():
    try:
        json.loads("{broken")
    except json.JSONDecodeError as exc:
        return exc


class TestTaxonomy:
    @pytest.mark.parametrize("make", [
        lambda: MemoryError("boom"), lambda: TimeoutError("slow"), lambda: FloatingPointError("nan"),
        lambda: ValueError("bad shape"), lambda: KeyError("F0"), lambda: EOFError("truncated"),
        lambda: OSError(errno.ENOSPC, "no space"), lambda: OSError(errno.EACCES, "denied"),
        lambda: RuntimeError("mystery"), _json_error,
        lambda: RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 2.1G"),
        lambda: RuntimeError("DEADLINE_EXCEEDED: collective timed out"),
        lambda: RuntimeError("device halted unexpectedly"),
    ])
    def test_builtins_and_messages_match_jax(self, make):
        exc = make()
        assert taxonomy.classify(exc).value == jax_taxonomy.classify(exc).value

    @pytest.mark.parametrize("cls,kind", [
        ("NonfiniteResultError", "nonfinite_result"), ("CacheCorruptError", "cache_corrupt"),
        ("DataError", "data_error"),
    ])
    def test_typed_errors(self, cls, kind):
        assert taxonomy.classify(getattr(taxonomy, cls)("x")).value == kind
        assert taxonomy.error_record(ValueError("nope")) == jax_taxonomy.error_record(ValueError("nope"))

    def test_torch_out_of_memory_by_type(self):
        exc = torch.cuda.OutOfMemoryError("tried to allocate a lot")
        assert taxonomy.classify(exc) is FailureKind.RESOURCE_EXHAUSTED
        assert taxonomy.classify(torch.OutOfMemoryError("plain wording")) is FailureKind.RESOURCE_EXHAUSTED
        assert taxonomy.classify(RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")) \
            is FailureKind.RESOURCE_EXHAUSTED

    @pytest.mark.parametrize("msg", [
        "CUDA error: no CUDA-capable device is detected",
        "CUDA error: uncorrectable ECC error encountered",
        "GPU has fallen off the bus",
    ])
    def test_lost_card_is_device_lost(self, msg):
        assert taxonomy.classify(RuntimeError(msg)) is FailureKind.DEVICE_LOST
        assert taxonomy.classify(torch.AcceleratorError(msg)) is FailureKind.DEVICE_LOST

    @pytest.mark.parametrize("msg", [
        "CUDA error: an illegal memory access was encountered",
        "CUDA error: misaligned address",
        "CUDA error: device-side assert triggered",
        "CUDA error: unspecified launch failure",
    ])
    def test_kernel_faults_are_unknown(self, msg):
        assert taxonomy.classify(RuntimeError(msg)) is FailureKind.UNKNOWN
        assert taxonomy.classify(torch.AcceleratorError(msg)) is FailureKind.UNKNOWN

    def test_kernel_error(self):
        exc = KernelError("z2_grid_sums: CUDA error 2 at launch")
        assert isinstance(exc, RuntimeError)
        assert taxonomy.classify(exc) is FailureKind.UNKNOWN
        assert resilience.KernelError is KernelError


# ---------------------------------------------------------------------------
# fault injector and policy
# ---------------------------------------------------------------------------


class TestFaultInjector:
    def test_points_are_a_subset_of_jax(self):
        assert faultinject.FAULT_POINTS == {"fold_sources", "fold_cache", "harmonic_sums", "survey_bucket",
                                            "mcmc_step", "tuner_cache", "serve_admission", "serve_dispatch",
                                            "serve_deadline", "serve_warm_batch", "scan_chunk"}
        assert faultinject.FAULT_POINTS <= jax_faultinject.FAULT_POINTS
        assert faultinject.KIND_NAMES.keys() == jax_faultinject.KIND_NAMES.keys()

    @pytest.mark.parametrize("spec", ["zap:fold_cache:1", "oom:fold_cache:x", "oom:fold_cache:0",
                                      "oom:fold_cache:0+", "oom:fold_cache:x+", "oom:fold_cache",
                                      "oom:scan_chunks:1"])
    def test_typos_fail_loudly(self, monkeypatch, spec):
        monkeypatch.setenv("CRIMP_TORCH_FAULTS", spec)
        with pytest.raises(ValueError, match="CRIMP_TORCH_FAULTS"):
            faultinject.fire("fold_cache")

    def test_nth_call_and_repeating_form(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_FAULTS", "oom:fold_cache:2,device:mcmc_step:2+")
        faultinject.fire("fold_cache")
        with pytest.raises(taxonomy.InjectedFault) as info:
            faultinject.fire("fold_cache")
        assert taxonomy.classify(info.value) is FailureKind.RESOURCE_EXHAUSTED
        faultinject.fire("fold_cache")  # disarmed
        faultinject.fire("mcmc_step")
        for _ in range(3):
            with pytest.raises(taxonomy.InjectedFault):
                faultinject.fire("mcmc_step")
        assert faultinject.plan_snapshot()["mcmc_step"]["calls"] == 4

    def test_typed_kinds_and_the_other_packages_knob(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TPU_FAULTS", "oom:fold_cache:1")
        faultinject.fire("fold_cache")  # crimp_tpu's knob arms nothing here
        assert faultinject._PLAN is None
        monkeypatch.setenv("CRIMP_TORCH_FAULTS", "corrupt:fold_cache:1,nan:survey_bucket:1,data:mcmc_step:1")
        with pytest.raises(taxonomy.CacheCorruptError):
            faultinject.fire("fold_cache")
        with pytest.raises(taxonomy.NonfiniteResultError):
            faultinject.fire("survey_bucket")
        with pytest.raises(taxonomy.DataError):
            faultinject.fire("mcmc_step")


class TestPolicy:
    def test_ladders(self, obs_on):
        """crimp_tpu's ladders for the engines the port has; none moves work
        off the card (no pinned-CPU device rung)."""
        assert policy.LADDERS == {k: v for k, v in jax_policy.LADDERS.items() if k in policy.LADDERS}
        assert set(policy.LADDERS) == {"multisource", "grid", "fold", "mcmc", "serve_warm"}
        with pytest.raises(ValueError, match="rung"):
            policy.record_degradation("grid", "warp_drive")
        with obs.run("ladder"):
            policy.record_degradation("grid", "streamed", FailureKind.RESOURCE_EXHAUSTED)
        doc = json.load(open(obs.last_manifest_path()))
        assert doc["counters"]["degraded_grid_streamed"] == 1
        assert doc["degradations"] == ["grid:streamed:resource_exhausted"]


class TestRetry:
    """Same-mode retry (``retry_call``) against crimp_tpu's: the same kinds,
    attempts, deterministic backoff and deadline skip; never a KernelError or
    a sticky CUDA error."""

    def test_defaults_and_knobs_are_jax(self, monkeypatch):
        for suffix, value in ((None, None), ("RETRIES", "3"), ("BACKOFF_S", "0.2")):
            if suffix:
                monkeypatch.setenv(f"CRIMP_TORCH_{suffix}", value)
                monkeypatch.setenv(f"CRIMP_TPU_{suffix}", value)
            got, want = policy.default_policy(), jax_policy.default_policy()
            assert (got.retries, got.backoff_s) == (want.retries, want.backoff_s)
            assert {k.value for k in got.kinds} == {k.value for k in want.kinds}
            for attempt in range(3):
                assert got.delay_s(attempt, "scan_chunk") == want.delay_s(attempt, "scan_chunk")
        monkeypatch.setenv("CRIMP_TORCH_RETRIES", "many")
        with pytest.raises(ValueError, match="CRIMP_TORCH_RETRIES"):
            policy.default_policy()

    def test_same_bits_after_one_retry(self, obs_on, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_BACKOFF_S", "0")
        t = grid_events()
        want = search.z2_power_grid(t, 0.1425, 1e-6, 128, 2, mxu=False, device="cpu")
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) == 1:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return search.z2_power_grid(t, 0.1425, 1e-6, 128, 2, mxu=False, device="cpu")

        with obs.run("retry"):
            got = policy.retry_call(flaky, point="scan_chunk")
        assert torch.equal(got, want) and len(calls) == 2
        counters = json.load(open(obs.last_manifest_path()))["counters"]
        assert counters["retries"] == 1 and counters["retries_scan_chunk"] == 1

    def test_budget_and_non_retryable_kinds_reraise(self):
        for exc in (ValueError("bad input"), resilience.CacheCorruptError("torn")):
            calls = []
            with pytest.raises(type(exc)):
                policy.retry_call(lambda: calls.append(1) or (_ for _ in ()).throw(exc), point="p",
                                  policy=policy.RetryPolicy(retries=3, backoff_s=0.0))
            assert len(calls) == 1
        calls = []
        with pytest.raises(TimeoutError):
            policy.retry_call(lambda: calls.append(1) or (_ for _ in ()).throw(TimeoutError("slow")), point="p",
                              policy=policy.RetryPolicy(retries=2, backoff_s=0.0))
        assert len(calls) == 3

    def test_deadline_skips_a_retry_that_cannot_fit(self, obs_on):
        calls = []

        def slow():
            calls.append(1)
            raise TimeoutError("slow")

        with obs.run("deadline"):
            with pytest.raises(TimeoutError):
                policy.retry_call(slow, point="p", policy=policy.RetryPolicy(retries=3, backoff_s=10.0),
                                  deadline_s=1.0)
        assert len(calls) == 1
        assert json.load(open(obs.last_manifest_path()))["counters"]["retries_deadline_skipped"] == 1
        ref_calls = []
        with pytest.raises(TimeoutError):
            jax_policy.retry_call(lambda: ref_calls.append(1) or (_ for _ in ()).throw(TimeoutError("slow")),
                                  point="p", policy=jax_policy.RetryPolicy(retries=3, backoff_s=10.0),
                                  deadline_s=1.0)
        assert len(ref_calls) == len(calls)

    @pytest.mark.parametrize("exc", [KernelError("z2_grid_sums: CUDA error 700 at launch"),
                                     RuntimeError("CUDA error: an illegal memory access was encountered"),
                                     RuntimeError("CUDA error: device-side assert triggered")])
    def test_kernel_errors_and_sticky_cuda_errors_are_never_retried(self, exc):
        assert taxonomy.classify(exc) in policy.RETRYABLE_KINDS  # UNKNOWN: retryable by kind alone
        calls = []
        with pytest.raises(type(exc)):
            policy.retry_call(lambda: calls.append(1) or (_ for _ in ()).throw(exc), point="p",
                              policy=policy.RetryPolicy(retries=3, backoff_s=0.0))
        assert len(calls) == 1
        assert taxonomy.sticky_cuda_error(exc) == (not isinstance(exc, KernelError))


# ---------------------------------------------------------------------------
# the ladders, step for step against crimp_tpu
# ---------------------------------------------------------------------------


def grid_events(n=3000, seed=7):
    return np.sort(np.random.RandomState(seed).uniform(0.0, 5000.0, n))


class TestGridLadder:
    @pytest.mark.parametrize("kind", sorted(faultinject.KIND_NAMES))
    def test_every_kind_drops_mxu_to_streamed_rung(self, monkeypatch, obs_on, kind):
        times = grid_events()
        args = (times, 0.1425, 1e-6, 128, 2)
        expected = search.z2_power_grid(*args, poly=False, mxu=False, device="cpu")
        arm(monkeypatch, f"{kind}:harmonic_sums:1")
        with obs.run("grid_chaos"):
            got = search.z2_power_grid(*args, poly=False, mxu=True, device="cpu")
        with jax_obs.run("grid_chaos"):
            jax_search.z2_power_grid(*args, mxu=True)
        assert torch.equal(got, expected)  # the streamed rung is K2, bit for bit
        port, ref = manifests()
        assert_same_ladder(port, ref)
        assert port["counters"]["degraded_grid_streamed"] == 1
        assert port["counters"]["grid_trials"] == ref["counters"]["grid_trials"] == 128

    def test_cube_steps_to_streamed_and_weights_skip_to_exact(self, monkeypatch, obs_on):
        times = grid_events()
        fd, fdd = np.array([0.0, 1e-9]), np.array([0.0])
        w = np.ones(times.size)
        expected = search.z2_power_3d_grid(times, 0.1425, 1e-6, 64, fd, fdd, 2, device="cpu", mxu=False)
        exact_w = search._grid3d_sums_dispatch(times, 0.1425, 1e-6, 64, fd, fdd, 2, mxu=False, weights=w,
                                               device="cpu")[0]
        arm(monkeypatch, "oom:harmonic_sums:1,device:harmonic_sums:2")
        with obs.run("cube_chaos"):
            got = search.z2_power_3d_grid(times, 0.1425, 1e-6, 64, fd, fdd, 2, device="cpu", mxu=True)
            c = search._grid3d_sums_dispatch(times, 0.1425, 1e-6, 64, fd, fdd, 2, mxu=True, weights=w,
                                             device="cpu")[0]
            search.z2_power_3d_grid(times, 0.1425, 1e-6, 64, fd, fdd, 2, device="cpu", mxu=True)
        assert torch.equal(got, expected) and torch.equal(c, exact_w)
        doc = json.load(open(obs.last_manifest_path()))
        assert doc["degradations"] == ["grid:streamed:resource_exhausted", "grid:exact:device_lost"]
        # one exact-sincos reseed row per 64 trials per cube row, counted
        # once the factorized rung is entered (the third call only)
        assert doc["counters"]["grid_mxu_reseeds"] == 2
        assert doc["counters"]["grid_trials"] == 3 * 64 * 2

    def test_no_fault_no_degradation_and_2d_has_no_ladder(self, monkeypatch, obs_on):
        times = grid_events()
        with obs.run("grid_clean"):
            search.z2_power_grid(times, 0.1425, 1e-6, 128, 2, mxu=False, device="cpu")
        doc = json.load(open(obs.last_manifest_path()))
        assert doc["degraded"] is False and doc["degradations"] == []
        arm(monkeypatch, "oom:harmonic_sums:1")
        search.z2_power_2d_grid(times, 0.1425, 1e-6, 64, [0.0], 2, mxu=True, device="cpu")
        # the 2-D wrapper has no harmonic_sums fault point (its knob
        # resolution reads the verdict cache, whose tuner_cache point fires)
        assert faultinject.plan_snapshot()["harmonic_sums"]["calls"] == 0

    def test_kernel_error_passes_through(self, monkeypatch, obs_on):
        times = grid_events()

        def broken(*a, **k):
            raise KernelError("z2_grid_sums: CUDA error 700 at launch")

        mxu_grid_sums = search._mxu_grid_sums
        monkeypatch.setattr(search, "_mxu_grid_sums", broken)
        with obs.run("grid_kernel"):
            with pytest.raises(KernelError):
                search.z2_power_grid(times, 0.1425, 1e-6, 128, 2, mxu=True, device="cpu")
        assert json.load(open(obs.last_manifest_path()))["degradations"] == []
        monkeypatch.setattr(search, "_mxu_grid_sums", mxu_grid_sums)
        arm(monkeypatch, "oom:harmonic_sums:1")
        monkeypatch.setattr(search, "_streamed_uniform_sums", broken)
        with obs.run("grid_kernel_streamed"):
            with pytest.raises(KernelError):
                search.z2_power_grid(times, 0.1425, 1e-6, 128, 2, mxu=True, device="cpu")
        # the injected fault stepped one rung; the kernel fault stepped none
        assert json.load(open(obs.last_manifest_path()))["degradations"] == ["grid:streamed:resource_exhausted"]


FOLD_TM = {"PEPOCH": 58359.55765869704, "F0": 0.14328254547263483, "F1": -9.746993965547238e-15,
           "GLEP_1": 58400.0, "GLPH_1": 0.01, "GLF0_1": 3e-8}


def fold_segments_(n_per=600, n_seg=3, seed=0):
    rng = np.random.default_rng(seed)
    return [np.sort(58320.0 + 120.0 * i + rng.uniform(0.0, 100.0, n_per)) for i in range(n_seg)]


class TestFoldLadder:
    @pytest.mark.parametrize("kind", ["oom", "corrupt", "device", "nan"])
    def test_cache_fault_degrades_to_exact_refold_bitwise(self, monkeypatch, tmp_path, obs_on, kind):
        monkeypatch.setenv("CRIMP_TORCH_FOLD_CACHE", str(tmp_path / "fc_port"))
        monkeypatch.setenv("CRIMP_TPU_FOLD_CACHE", str(tmp_path / "fc_jax"))
        segs = fold_segments_()
        baseline, _ = anchored.fold_segments(FOLD_TM, segs, delta_fold=1, device="cpu")
        jax_anchored.fold_segments(FOLD_TM, segs, delta_fold=1)
        arm(monkeypatch, f"{kind}:fold_cache:1")
        deltafold.clear_cache()
        jax_deltafold.clear_cache()
        with obs.run("fold_chaos"):
            got, _ = anchored.fold_segments(FOLD_TM, segs, delta_fold=1, device="cpu")
        with jax_obs.run("fold_chaos"):
            jax_anchored.fold_segments(FOLD_TM, segs, delta_fold=1)
        for a, b in zip(got, baseline):
            np.testing.assert_array_equal(a, b)
        port, ref = manifests()
        assert_same_ladder(port, ref)
        if kind == "corrupt":
            assert port["counters"]["quarantined_fold_cache"] == 1
            assert list((tmp_path / "fc_port").glob("*.corrupt"))
        else:
            assert port["counters"]["degraded_fold_exact_refold"] == 1
            assert deltafold.last_fold_info()["fallback"] == faultinject.KIND_NAMES[kind].value

    def test_refold_is_no_rung_its_failures_propagate(self, monkeypatch, obs_on):
        """The refold is K4's: unlike crimp_tpu's ladder, a refold that fails
        (out of memory here, a launch error below) is never answered by the
        exact fold. Nothing is recorded as a degradation."""
        segs = fold_segments_()
        anchored.fold_segments(FOLD_TM, segs, delta_fold=1, device="cpu", cache_tag="ladder")
        moved = {**FOLD_TM, "F0": FOLD_TM["F0"] + 1e-12}

        def oom(*a, **k):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

        monkeypatch.setattr(deltafold, "refold", oom)
        with obs.run("refold_oom"):
            with pytest.raises(torch.cuda.OutOfMemoryError):
                anchored.fold_segments(moved, segs, delta_fold=1, device="cpu", cache_tag="ladder")
        doc = json.load(open(obs.last_manifest_path()))
        assert doc["degradations"] == [] and "delta_fold_exact_folds" not in doc["counters"]

        def broken(*a, **k):
            raise KernelError("deltafold_refold: CUDA error 700 at launch")

        monkeypatch.setattr(deltafold, "refold", broken)
        with obs.run("refold_kernel"):
            with pytest.raises(KernelError):
                anchored.fold_segments({**FOLD_TM, "F0": FOLD_TM["F0"] + 2e-12}, segs, delta_fold=1,
                                       device="cpu", cache_tag="ladder")
        assert json.load(open(obs.last_manifest_path()))["degradations"] == []

    def test_a_move_k4_cannot_take_folds_exactly_undegraded(self, monkeypatch, obs_on):
        """Whether K4 takes a move is decided before the launch: a basis
        wider than its shared memory holds (or no event) folds exactly, as a
        normal mode, and the refold is never called."""

        class Lib:
            @staticmethod
            def deltafold_max_params():
                return 225

        monkeypatch.setattr(deltafold, "_lib", lambda: Lib())
        assert deltafold.refold_supported(10, 7, "cpu") and deltafold.refold_supported(0, 500, "cpu")
        assert deltafold.refold_supported(10, 225, "cuda") and not deltafold.refold_supported(10, 226, "cuda")
        assert not deltafold.refold_supported(0, 13, "cuda")

        segs = fold_segments_()
        anchored.fold_segments(FOLD_TM, segs, delta_fold=1, device="cpu", cache_tag="wide")
        moved = {**FOLD_TM, "F0": FOLD_TM["F0"] + 1e-12}
        exact, _ = anchored.fold_segments(moved, segs, delta_fold=0, device="cpu")
        monkeypatch.setattr(deltafold, "refold_supported", lambda n_events, n_params, device: False)
        monkeypatch.setattr(deltafold, "refold", lambda *a, **k: pytest.fail("refold called"))
        with obs.run("refold_unsupported"):
            got, _ = anchored.fold_segments(moved, segs, delta_fold=1, device="cpu", cache_tag="wide")
        for a, b in zip(got, exact):
            np.testing.assert_array_equal(a, b)
        assert deltafold.last_fold_info()["fallback"] == "unsupported"
        doc = json.load(open(obs.last_manifest_path()))
        assert doc["degradations"] == [] and doc["counters"]["delta_fold_exact_folds"] == 1

    def test_a_device_fault_at_the_copy_is_a_kernel_error(self):
        from crimp_tpu_torch.ops import z2_grid

        class Faulted:
            device = torch.device("cuda", 0)

            def cpu(self):
                raise RuntimeError("CUDA error: an illegal memory access was encountered")

        with pytest.raises(KernelError, match="deltafold_refold: device fault"):
            z2_grid.to_host(Faulted(), "deltafold_refold")
        np.testing.assert_array_equal(z2_grid.to_host(torch.arange(3.0), "k"), [0.0, 1.0, 2.0])


class TestMcmcLadder:
    def test_delta_failure_falls_to_the_exact_likelihood(self, monkeypatch, obs_on):
        """tests/test_mcmc_delta.py's glitch-bearing fit: an injected fault on
        the delta-basis run steps to the exact likelihood in both packages,
        and the port's chain is then its mcmc_delta=0 chain bit for bit."""
        from crimp_tpu.pipelines import fit_toas as jax_fit_toas
        from crimp_tpu_torch.io.yamlcfg import Prior
        from crimp_tpu_torch.pipelines import fit_toas
        from tests.test_mcmc_delta import KEYS, _problem

        par, jax_prior, t, y, yerr = _problem(n_toas=40)
        prior = Prior(dict(jax_prior.bounds), {})
        kw = dict(steps=30, burn=10, walkers=8, seed=1)
        exact = fit_toas.run_mcmc(t, y, yerr, par, KEYS, prior, mcmc_delta=0, device="cpu", **kw)[0]
        arm(monkeypatch, "oom:mcmc_step:1")
        with obs.run("mcmc_chaos"):
            got = fit_toas.run_mcmc(t, y, yerr, par, KEYS, prior, mcmc_delta=1, device="cpu", **kw)[0]
        with jax_obs.run("mcmc_chaos"):
            jax_fit_toas.run_mcmc(t, y, yerr, par, KEYS, jax_prior, mcmc_delta=1, **kw)
        np.testing.assert_array_equal(got, exact)
        port, ref = manifests()
        assert_same_ladder(port, ref)
        assert port["degradations"] == ["mcmc:exact_likelihood:resource_exhausted"]
        for key in ("mcmc_proposals_evaluated",):
            assert port["counters"][key] == ref["counters"][key] == 30 * 8
        arm(monkeypatch, "")

        def broken(*a, **k):
            raise KernelError("deltafold_refold: CUDA error 700 at launch")

        monkeypatch.setattr(fit_toas.mcmc_ops, "ensemble_sample", broken)
        with obs.run("mcmc_kernel"):
            with pytest.raises(KernelError):
                fit_toas.run_mcmc(t, y, yerr, par, KEYS, prior, mcmc_delta=1, device="cpu", **kw)
        assert json.load(open(obs.last_manifest_path()))["degradations"] == []


TPL = {"model": "fourier", "nbrComp": 2, "norm": 1.0, "amp_1": 0.3, "amp_2": 0.1, "ph_1": 0.2, "ph_2": 0.05}


def make_spec(i, rng, n_per=60, n_int=2, name=None):
    """tests/test_resilience.py's chaos-matrix source."""
    edges = np.linspace(58000.0, 58008.0, n_int + 1)
    times = np.sort(np.concatenate([rng.uniform(lo + 1e-6, hi - 1e-6, n_per)
                                    for lo, hi in zip(edges[:-1], edges[1:])]))
    iv = {"ToA_tstart": edges[:-1], "ToA_tend": edges[1:],
          "ToA_exposure": np.full(n_int, (edges[1] - edges[0]) * 86400.0)}
    tm = {"PEPOCH": 58000.0, "F0": 0.14 + 0.003 * (i % 53), "F1": -1e-13}
    return survey.SourceSpec(name=name or f"src{i}", times=times, timing_model=tm, template=dict(TPL),
                             intervals=iv)


def as_jax(spec):
    return jax_survey.SourceSpec(name=spec.name, times=spec.times, timing_model=spec.timing_model,
                                 template=dict(spec.template), intervals=pd.DataFrame(spec.intervals))


def assert_bitwise(frame, solo, ctx):
    for col in survey.SURVEY_TOA_COLUMNS:
        assert np.array_equal(frame[col], solo[col]), (ctx, col)


def assert_matches_loop(frame, solo, ctx):
    from tests.test_torch_survey import assert_matches_loop as contract

    contract(frame, solo, ctx, res=200)


class TestSurveyLadder:
    def test_bucket_oom_splits_and_recovers(self, monkeypatch, obs_on):
        rng = np.random.RandomState(31)
        specs = [make_spec(i, rng) for i in range(2)]
        solos = [survey.measure_source_toas(s, phShiftRes=200, device="cpu") for s in specs]
        arm(monkeypatch, "oom:survey_bucket:1")
        frames = survey.survey_measure_toas(specs, phShiftRes=200, device="cpu")
        info = survey.last_survey_info()
        jax_survey.survey_measure_toas([as_jax(s) for s in specs], phShiftRes=200)
        assert info["bucket_splits"] == jax_survey.last_survey_info()["bucket_splits"] == 1
        assert info["errors"] == {} and info["demoted"] == {}
        for spec, frame, solo in zip(specs, frames, solos):
            assert_matches_loop(frame, solo, spec.name)
        port, ref = manifests()
        assert_same_ladder(port, ref)
        assert port["counters"]["degraded_multisource_split_bucket"] == 1
        assert "multisource:split_bucket:resource_exhausted" in port["degradations"]
        for key in ("sources_batched", "bucket_count", "events_folded", "toas_fit"):
            assert port["counters"][key] == ref["counters"][key], key
        assert port["gauges"]["bucket_occupancy_pct"] == ref["gauges"]["bucket_occupancy_pct"]

    @pytest.mark.parametrize("point", ["survey_bucket", "fold_sources", "harmonic_sums"])
    def test_single_source_bucket_demotes_per_source(self, monkeypatch, obs_on, point):
        rng = np.random.RandomState(32)
        spec = make_spec(0, rng)
        solo = survey.measure_source_toas(spec, phShiftRes=200, device="cpu")
        arm(monkeypatch, f"oom:{point}:1")
        frames = survey.survey_measure_toas([spec], phShiftRes=200, device="cpu")
        info = survey.last_survey_info()
        jax_survey.survey_measure_toas([as_jax(spec)], phShiftRes=200)
        assert info["errors"] == {}
        assert info["demoted"][spec.name].startswith("bucket: resource_exhausted: InjectedFault")
        assert info["demoted"] == jax_survey.last_survey_info()["demoted"]
        assert_bitwise(frames[0], solo, spec.name)
        port, ref = manifests()
        assert_same_ladder(port, ref)
        assert port["counters"]["degraded_multisource_per_source"] == 1

    def test_failed_source_error_is_classified(self):
        rng = np.random.RandomState(33)
        bad = make_spec(0, rng, name="badsrc")
        bad.times = bad.times[bad.times < 58004.0]  # last interval empty
        frames = survey.survey_measure_toas([bad, make_spec(1, rng)], phShiftRes=200, device="cpu")
        rec = survey.last_survey_info()["errors"]["badsrc"]
        assert frames[0] is None and frames[1] is not None
        assert set(rec) == {"kind", "type", "message"}
        assert rec["kind"] in {k.value for k in FailureKind} and rec["type"] == "ValueError"

    def test_knob_off_pins(self, monkeypatch):
        times = grid_events()
        a = search.z2_power_grid(times, 0.1425, 1e-6, 128, 2, device="cpu")
        b = search.z2_power_grid(times, 0.1425, 1e-6, 128, 2, device="cpu")
        assert torch.equal(a, b) and faultinject._PLAN is None
        rng = np.random.RandomState(34)
        spec = make_spec(0, rng)
        baseline = survey.survey_measure_toas([spec], phShiftRes=200, device="cpu")
        monkeypatch.setenv("CRIMP_TORCH_FAULTS", "")  # set-but-empty == unset
        frames = survey.survey_measure_toas([spec], phShiftRes=200, device="cpu")
        assert_bitwise(frames[0], baseline[0], spec.name)
        assert survey.last_survey_info()["demoted"] == {}

    def test_device_failure_is_recorded_never_moved_to_the_cpu(self, monkeypatch, obs_on):
        """A solo run that dies RESOURCE_EXHAUSTED ends at its classified
        record, as any other failure does: the port has no pinned-CPU rung,
        so no source is run again, on the CPU or elsewhere."""
        rng = np.random.RandomState(35)
        specs = [make_spec(0, rng), make_spec(1, rng), make_spec(2, rng)]
        monkeypatch.setenv("CRIMP_TORCH_MULTISOURCE", "0")
        real = survey.measure_source_toas
        seen = []

        def flaky(spec, *a, device=None, **k):
            seen.append((spec.name, torch.device(device).type))
            if spec.name == "src0":
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            if spec.name == "src1":
                raise RuntimeError("mystery")
            return real(spec, *a, device=device, **k)

        monkeypatch.setattr(survey, "measure_source_toas", flaky)
        with obs.run("no_cpu_rung"):
            frames = survey._survey_impl(specs, 200, 15, False, torch.device("cpu"))
        info = survey.last_survey_info()
        assert seen == [("src0", "cpu"), ("src1", "cpu"), ("src2", "cpu")]
        assert frames[0] is None and frames[1] is None and frames[2] is not None
        assert info["errors"]["src0"]["kind"] == "resource_exhausted"
        assert info["errors"]["src1"]["kind"] == "unknown"
        assert info["demoted"]["src0"] == "knob: multisource off"
        doc = json.load(open(obs.last_manifest_path()))
        assert doc["degraded"] is False
        assert not any(k.startswith("degraded_device") for k in doc["counters"])

    def test_kernel_error_passes_through_the_survey(self, monkeypatch):
        rng = np.random.RandomState(36)
        specs = [make_spec(i, rng) for i in range(3)]

        def broken(*a, **k):
            raise KernelError("deltafold_refold: CUDA error 700 at launch")

        monkeypatch.setattr(multisource, "fold_sources", broken)
        with pytest.raises(KernelError):
            survey.survey_measure_toas(specs, phShiftRes=200, device="cpu")
        monkeypatch.undo()
        monkeypatch.setenv("CRIMP_TORCH_MULTISOURCE", "0")
        monkeypatch.setattr(anchored, "fold_segments", broken)
        with pytest.raises(KernelError):
            survey.survey_measure_toas(specs, phShiftRes=200, device="cpu")
