"""The port's launch-plan tuner and knob resolvers (crimp_tpu_torch.ops.autotune)
against crimp_tpu.ops.autotune (tests/test_autotune.py's cases).

- ``resolve_blocks``: explicit arguments > CRIMP_TORCH_GRID_BLOCKS (grid
  kernels, malformed raises, a trial tile other than the kernel's raises)
  > a cached winner > eager tuning on a miss > the static plan, which is
  exactly the plan the kernels choose themselves; a corrupt cache, another
  device's key, another cache version or a malformed entry fall to it; the
  key and the plan are the call's device's, so a card's verdict never
  steers a CPU call and a CPU call never starts a sweep on the card;
- ``tune`` on the CPU twins at a tiny size writes the cache and a later
  ``resolve_blocks`` reads it with no timing run; the static plan is always
  a candidate; a failing candidate is an error row, a ``KernelError``
  propagates out of the sweep and out of ``tune``; without a card, ``tune``
  and the sweep raise unless asked for ``device="cpu"``;
- the toafit, grid_mxu, grid3d_mxu, delta_fold and mcmc_delta resolvers
  resolve as crimp_tpu's on the same environment and cache scenarios;
- ``resolve_toafit`` feeds the fit, and the bf16 Fourier sweep agrees with
  crimp_tpu's bf16 sweep at ``TestMxuBf16``'s tolerance (the phShift
  deviation under half the error bar, tests/test_toafit.py:470-490); bf16
  off is bitwise the default.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from crimp_tpu.models import profiles as jax_profiles
from crimp_tpu.ops import autotune as jax_autotune
from crimp_tpu_torch import resilience
from crimp_tpu_torch.models import convert
from crimp_tpu_torch.ops import autotune, search, toafit, z2_general, z2_grid
from crimp_tpu_torch.utils import benchwork
from tests.test_toafit import draw_phases, fit_one, template

torch.set_num_threads(2)

SUFFIXES = ("AUTOTUNE", "AUTOTUNE_CACHE", "GRID_BLOCKS", "TOA_DENSE_WINDOW", "MXU_BF16", "GRID_MXU", "DELTA_FOLD",
            "DELTA_FOLD_BUDGET", "MCMC_DELTA", "FAULTS")


@pytest.fixture(autouse=True)
def caches(monkeypatch, tmp_path):
    """Each package's cache file in its own temp dir; no stray knobs."""
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        for suffix in SUFFIXES:
            monkeypatch.delenv(f"{prefix}_{suffix}", raising=False)
    paths = {"port": tmp_path / "port" / "autotune.json", "jax": tmp_path / "jax" / "autotune.json"}
    monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE_CACHE", str(paths["port"]))
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE_CACHE", str(paths["jax"]))
    return paths


def both_env(monkeypatch, suffix, value):
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        monkeypatch.setenv(f"{prefix}_{suffix}", value)


def outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError:
        return ValueError


CPU = torch.device("cpu")
STATIC = autotune.static_defaults("grid", 10_000, 1000, device=CPU)


class TestStaticPlan:
    def test_static_plan_is_the_kernels_own(self):
        # off the card one split covers every event; the kernels' wrappers
        # take the same plan when none is given
        assert STATIC == (10240, z2_grid.TRIAL_TILE)
        assert autotune.static_defaults("general", 10_000, 1000, device=CPU) == (10240, z2_general.THREADS)
        assert autotune.static_defaults("grid_mxu") == (search.MXU_EVENT_BLOCK, search.MXU_TRIAL_BLOCK)
        assert autotune.static_defaults("multisource") == autotune.multisource_blocks()
        # off the card the K2 plan is one split of every event (on the card:
        # plan_splits over the kernel's resident blocks, tests/test_torch_z2_rotation.py)
        plan = z2_grid.default_per_split(839259, 40 * 10, torch.device("cpu"))
        assert plan == 820 * 1024

    def test_empty_cache_keeps_the_search_bits(self):
        t = np.sort(np.random.RandomState(5).uniform(0.0, 200.0, 3000))
        want = search.z2_power_grid(t, 0.2, 1e-5, 400, nharm=2, device="cpu", per_split=3072)
        got = search.z2_power_grid(t, 0.2, 1e-5, 400, nharm=2, device="cpu")
        assert torch.equal(got, want)


class TestResolvePrecedence:
    def test_off_mode_is_static_defaults(self, caches, monkeypatch):
        key = autotune.cache_key("grid", False, 10_000, 1000)
        autotune._store_entry(key, {"event_block": 2048, "trial_block": 256})
        monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE", "0")
        assert autotune.resolve_blocks("grid", 10_000, 1000, device=CPU) == STATIC
        assert autotune.resolve_blocks("general", 10_000, 1000, device=CPU) == \
            autotune.static_defaults("general", 10_000, 1000, device=CPU)

    def test_cached_winner_used_in_auto_mode(self):
        key = autotune.cache_key("grid", True, 10_000, 1000)
        autotune._store_entry(key, {"event_block": 2048, "trial_block": 256})
        assert autotune.resolve_blocks("grid", 10_000, 1000, poly=True, device=CPU) == (2048, 256)

    def test_env_beats_cached_winner(self, monkeypatch):
        key = autotune.cache_key("grid", False, 10_000, 1000)
        autotune._store_entry(key, {"event_block": 2048, "trial_block": 256})
        monkeypatch.setenv("CRIMP_TORCH_GRID_BLOCKS", "8192,256")
        assert autotune.resolve_blocks("grid", 10_000, 1000) == (8192, 256)

    @pytest.mark.parametrize("value", ["8192", "8192,128", "1000,256", "x,256", "0,256"])
    def test_env_malformed_still_raises(self, monkeypatch, value):
        monkeypatch.setenv("CRIMP_TORCH_GRID_BLOCKS", value)
        with pytest.raises(ValueError, match="CRIMP_TORCH_GRID_BLOCKS"):
            autotune.resolve_blocks("grid", 10_000, 1000)

    def test_env_does_not_apply_to_general_kernel(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_GRID_BLOCKS", "8192,256")
        assert autotune.resolve_blocks("general", 10_000, 1000, device=CPU) == \
            autotune.static_defaults("general", 10_000, 1000, device=CPU)

    def test_explicit_args_beat_everything(self, monkeypatch):
        key = autotune.cache_key("grid", False, 10_000, 1000)
        autotune._store_entry(key, {"event_block": 2048, "trial_block": 256})
        monkeypatch.setenv("CRIMP_TORCH_GRID_BLOCKS", "8192,256")
        assert autotune.resolve_blocks("grid", 10_000, 1000, event_block=4096, trial_block=256) == (4096, 256)

    def test_partial_explicit_arg_overrides_one_component(self):
        key = autotune.cache_key("grid", False, 10_000, 1000)
        autotune._store_entry(key, {"event_block": 2048, "trial_block": 256})
        assert autotune.resolve_blocks("grid", 10_000, 1000, event_block=4096, device=CPU) == (4096, 256)

    def test_unknown_kernel_raises(self):
        with pytest.raises(ValueError, match="kernel"):
            autotune.resolve_blocks("pallas", 10_000, 1000)

    def test_the_search_runs_under_the_cached_plan(self, monkeypatch):
        t = np.sort(np.random.RandomState(5).uniform(0.0, 200.0, 3000))
        key = autotune.cache_key("grid", False, 3000, 400)  # the CPU's default trig
        autotune._store_entry(key, {"event_block": 1024, "trial_block": 256})
        seen = []
        real = z2_grid.z2_tile_sums
        monkeypatch.setattr(z2_grid, "z2_tile_sums", lambda *a, **k: seen.append(k["per_split"]) or real(*a, **k))
        got = search.z2_power_grid(t, 0.2, 1e-5, 400, nharm=2, device="cpu")
        assert seen == [1024]
        want = search.z2_power_grid(t, 0.2, 1e-5, 400, nharm=2, device="cpu", per_split=1024)
        assert torch.equal(got, want)


class TestCache:
    def test_corrupt_cache_falls_back_to_defaults(self, caches):
        caches["port"].parent.mkdir(parents=True)
        caches["port"].write_text("{not json")
        assert autotune.resolve_blocks("grid", 10_000, 1000, device=CPU) == STATIC

    def test_version_mismatch_invalidates(self, caches):
        key = autotune.cache_key("grid", False, 10_000, 1000)
        caches["port"].parent.mkdir(parents=True)
        caches["port"].write_text(json.dumps({"version": autotune.CACHE_VERSION + 1,
                                              "entries": {key: {"event_block": 2048, "trial_block": 256}}}))
        assert autotune.cached_blocks("grid", False, 10_000, 1000) is None

    def test_size_bucketing(self):
        k = autotune.cache_key("grid", True, 790_000, 100_000, "cuda", "x")
        assert k == autotune.cache_key("grid", True, 810_000, 100_000, "cuda", "x")
        assert k != autotune.cache_key("grid", True, 100_000_000, 100_000, "cuda", "x")
        assert k == jax_autotune.cache_key("grid", True, 790_000, 100_000, "cuda", "x")

    def test_device_fingerprint_invalidates(self, monkeypatch):
        monkeypatch.setattr(autotune, "device_fingerprint", lambda device=None: ("tpu", "TPU v5e"))
        key = autotune.cache_key("grid", False, 10_000, 1000)
        autotune._store_entry(key, {"event_block": 2048, "trial_block": 256})
        assert autotune.cached_blocks("grid", False, 10_000, 1000) == (2048, 256)
        monkeypatch.setattr(autotune, "device_fingerprint", lambda device=None: ("cpu", "cpu"))
        assert autotune.cached_blocks("grid", False, 10_000, 1000) is None

    @pytest.mark.parametrize("entry", [{"event_block": "big", "trial_block": 256},
                                       {"event_block": 2000, "trial_block": 256},
                                       {"event_block": 2048, "trial_block": 64}])
    def test_malformed_entry_rejected(self, entry):
        key = autotune.cache_key("grid", False, 10_000, 1000)
        autotune._store_entry(key, entry)
        assert autotune.cached_blocks("grid", False, 10_000, 1000) is None
        assert autotune.resolve_blocks("grid", 10_000, 1000, device=CPU) == STATIC


class TestTuneRoundTrip:
    CANDS = (1024, 2048)

    def test_tune_persists_and_second_resolve_times_nothing(self, caches, monkeypatch):
        out = autotune.tune("grid", 4000, 256, poly=False, candidates=self.CANDS, repeats=1, device=CPU)
        assert (out["event_block"], out["trial_block"]) in {(1024, 256), (2048, 256),
                                                            autotune.static_defaults("grid", 4000, 256, device=CPU)}
        assert caches["port"].exists()

        def boom(*a, **k):
            raise AssertionError("candidate_rate called on the cached path")

        monkeypatch.setattr(benchwork, "candidate_rate", boom)
        assert autotune.resolve_blocks("grid", 4000, 256, poly=False, device=CPU) == \
            (out["event_block"], out["trial_block"])

    def test_winner_at_least_static_default(self):
        out = autotune.tune("general", 4000, 256, poly=True, candidates=self.CANDS, repeats=1, device=CPU)
        static = [r for r in out["rows"] if r["static"]]
        assert len(static) == 1 and "trials_per_sec" in static[0]
        assert (static[0]["event_block"], static[0]["trial_block"]) == \
            autotune.static_defaults("general", 4000, 256, device=CPU)
        assert out["trials_per_sec"] >= static[0]["trials_per_sec"]

    def test_error_candidates_do_not_end_the_sweep(self, monkeypatch):
        real = benchwork.candidate_rate

        def flaky(kernel, sec, freqs, f0, df, n_trials, nharm, eb, tb, poly, repeats=3, device="cuda"):
            if eb == 1024:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return real(kernel, sec, freqs, f0, df, n_trials, nharm, eb, tb, poly, repeats=repeats, device=device)

        monkeypatch.setattr(benchwork, "candidate_rate", flaky)
        out = autotune.tune("grid", 4000, 256, poly=False, candidates=self.CANDS + ((2048, 64),), repeats=1,
                            device=CPU)
        errs = {r["event_block"]: r for r in out["rows"] if "error" in r}
        assert errs[1024]["kind"] == "resource_exhausted"
        assert "trial tile" in errs[2048]["error"]  # a tile the kernel is not compiled with
        assert out["event_block"] != 1024

    def test_kernel_error_propagates_out_of_the_sweep(self, monkeypatch):
        def dead(*a, **k):
            raise resilience.KernelError("z2_grid_sums: CUDA error 700 at launch")

        monkeypatch.setattr(benchwork, "candidate_rate", dead)
        for fn in (autotune.sweep_candidates, autotune.tune):
            with pytest.raises(resilience.KernelError):
                fn("grid", 4000, 256, candidates=self.CANDS, repeats=1, device=CPU)
        monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE", "eager")
        with pytest.raises(resilience.KernelError):
            autotune.resolve_blocks("grid", 4000, 256, device=CPU)

    def test_eager_mode_tunes_on_miss(self, monkeypatch):
        calls = []
        monkeypatch.setattr(autotune, "tune",
                            lambda *a, **k: calls.append(k["device"]) or {"event_block": 1024, "trial_block": 256})
        monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE", "eager")
        assert autotune.resolve_blocks("grid", 4000, 256, device=CPU) == (1024, 256)
        assert calls == [CPU]

    def test_tune_without_a_card_raises(self, caches, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("a sweep without a card measured the CPU twins")

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(benchwork, "candidate_rate", boom)
        for fn in (autotune.sweep_candidates, autotune.tune):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn("grid", 4000, 256, candidates=self.CANDS, repeats=1)
        assert not caches["port"].exists()

    def test_a_card_verdict_never_steers_a_cpu_call(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
        card = ("cuda", "NVIDIA H100 80GB HBM3")
        autotune._store_entry(autotune.cache_key("grid", True, 4000, 256, *card),
                              {"event_block": 131072, "trial_block": 256})
        autotune.store_toafit(84, 10_000, {"err_dense_window": 64, "mxu_bf16": 1}, device="cuda")
        assert autotune.cached_blocks("grid", True, 4000, 256, device="cuda") == (131072, 256)
        assert autotune.resolve_blocks("grid", 4000, 256, poly=True, device=CPU) == \
            autotune.static_defaults("grid", 4000, 256, device=CPU)
        assert autotune.resolve_toafit(84, 10_000, device=CPU) == autotune.toafit_defaults()
        assert autotune.resolve_toafit(84, 10_000, device="cuda") == {"err_dense_window": 64, "mxu_bf16": 1}
        # eager mode on a CPU call tunes the CPU twins, never the card
        calls = []
        monkeypatch.setattr(autotune, "tune",
                            lambda *a, **k: calls.append(k["device"]) or {"event_block": 1024, "trial_block": 256})
        monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE", "eager")
        assert autotune.resolve_blocks("grid", 8000, 256, poly=True, device=CPU) == (1024, 256)
        assert calls == [CPU]

    def test_eager_mode_on_the_twins_writes_the_cache(self, caches, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE", "1")
        monkeypatch.setattr(autotune, "DEFAULT_CANDIDATES", (1024,))
        t = np.sort(np.random.RandomState(5).uniform(0.0, 200.0, 3000))
        search.z2_power_grid(t, 0.2, 1e-5, 300, nharm=2, device="cpu")
        entries = json.loads(caches["port"].read_text())["entries"]
        assert autotune.cache_key("grid", False, 3000, 300) in entries  # the CPU's default trig

    def test_auto_mode_never_times_implicitly(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("auto mode must not time")

        monkeypatch.setattr(benchwork, "candidate_rate", boom)
        assert autotune.resolve_blocks("grid", 4000, 256, device=CPU) == \
            autotune.static_defaults("grid", 4000, 256, device=CPU)


# -- the knob resolvers against crimp_tpu -------------------------------------------

TOAFIT_CASES = {
    "neither": ({}, None),
    "cached": ({}, {"err_dense_window": 64, "mxu_bf16": 1}),
    "autotune_off": ({"AUTOTUNE": "0"}, {"err_dense_window": 64, "mxu_bf16": 1}),
    "off_env_wins": ({"AUTOTUNE": "0", "TOA_DENSE_WINDOW": "16", "MXU_BF16": "1"}, None),
    "env_over_cache": ({"TOA_DENSE_WINDOW": "0"}, {"err_dense_window": 64, "mxu_bf16": 1}),
    "malformed_window": ({"TOA_DENSE_WINDOW": "many"}, None),
    "malformed_bf16": ({"MXU_BF16": "2"}, None),
    "malformed_entry": ({}, {"err_dense_window": "wide", "mxu_bf16": 3}),
}
MXU_CASES = {
    "neither": ({}, None),
    "cached": ({}, {"grid_mxu": 1, "reseed": 128, "mxu_bf16": 0}),
    "autotune_off": ({"AUTOTUNE": "0"}, {"grid_mxu": 1, "reseed": 128, "mxu_bf16": 0}),
    "off_env_wins": ({"AUTOTUNE": "0", "GRID_MXU": "1"}, None),
    "env_off_over_cache": ({"GRID_MXU": "0"}, {"grid_mxu": 1, "reseed": 128, "mxu_bf16": 0}),
    "bf16_env": ({"MXU_BF16": "1"}, {"grid_mxu": 1, "reseed": 128, "mxu_bf16": 0}),
    "malformed_env": ({"GRID_MXU": "on"}, None),
    "malformed_entry": ({}, {"grid_mxu": 1, "reseed": "often", "mxu_bf16": 0}),
}
SWITCH_CASES = {
    "neither": ({}, None),
    "cached": ({}, {"budget": 2e-9}),
    "autotune_off": ({"AUTOTUNE": "0"}, {"budget": 2e-9}),
    "env_both_ways": ({"SWITCH": "0", "DELTA_FOLD_BUDGET": "5e-10"}, {"budget": 2e-9}),
    "malformed_env": ({"SWITCH": "2"}, None),
    "malformed_budget": ({"DELTA_FOLD_BUDGET": "-1"}, None),
    "malformed_entry": ({}, {"budget": float("inf")}),
}


def _arm(monkeypatch, env: dict, switch: str | None = None):
    for suffix, value in env.items():
        both_env(monkeypatch, switch if suffix == "SWITCH" else suffix, value)


class TestKnobResolvers:
    @pytest.mark.parametrize("case", list(TOAFIT_CASES))
    def test_toafit_resolves_as_jax(self, monkeypatch, case):
        env, entry = TOAFIT_CASES[case]
        _arm(monkeypatch, env)
        if entry is not None:
            autotune.store_toafit(84, 10_000, entry)
            jax_autotune.store_toafit(84, 10_000, entry)
        for n_events in (10_000, 9_000, 100_000):  # the 9000 bucket is 10000's
            got = outcome(autotune.resolve_toafit, 84, n_events)
            assert got == outcome(jax_autotune.resolve_toafit, 84, n_events), n_events

    @pytest.mark.parametrize("cube", [False, True])
    @pytest.mark.parametrize("case", list(MXU_CASES))
    def test_grid_mxu_resolves_as_jax(self, monkeypatch, case, cube):
        env, entry = MXU_CASES[case]
        _arm(monkeypatch, env)
        store = "store_grid3d_mxu" if cube else "store_grid_mxu"
        resolve = "resolve_grid3d_mxu" if cube else "resolve_grid_mxu"
        if entry is not None:
            getattr(autotune, store)(True, 800_000, 100_000, entry)
            getattr(jax_autotune, store)(True, 800_000, 100_000, entry)
        for poly in (True, False):  # the hardware-trig path has its own entry
            got = outcome(getattr(autotune, resolve), 800_000, 100_000, poly=poly)
            assert got == outcome(getattr(jax_autotune, resolve), 800_000, 100_000, poly=poly), poly

    @pytest.mark.parametrize("switch", ["DELTA_FOLD", "MCMC_DELTA"])
    @pytest.mark.parametrize("case", list(SWITCH_CASES))
    def test_delta_switches_resolve_as_jax(self, monkeypatch, case, switch):
        env, entry = SWITCH_CASES[case]
        _arm(monkeypatch, env, switch)
        name = switch.lower()
        if entry is not None:
            getattr(autotune, f"store_{name}")(800_000, {name: 1, **entry})
            getattr(jax_autotune, f"store_{name}")(800_000, {name: 1, **entry})
        for n in (800_000, 700_000, 1_000):
            got = outcome(getattr(autotune, f"resolve_{name}"), n)
            assert got == outcome(getattr(jax_autotune, f"resolve_{name}"), n), n

    def test_cache_failure_degrades_to_defaults(self, monkeypatch):
        def boom(*a, **k):
            raise RuntimeError("backend exploded")

        for name in ("toafit", "grid_mxu", "delta_fold", "mcmc_delta"):
            monkeypatch.setattr(autotune, f"cached_{name}", boom)
        assert autotune.resolve_toafit(84, 10_000) == jax_autotune.resolve_toafit(84, 10_000)
        assert autotune.resolve_grid_mxu(800_000, 100_000) == autotune.grid_mxu_defaults()
        assert autotune.resolve_delta_fold(800_000) == autotune.delta_fold_defaults()
        assert autotune.resolve_mcmc_delta(30) == autotune.mcmc_delta_defaults()

    def test_enable_keys_distinct_from_block_entries(self):
        assert autotune.grid_mxu_cache_key(False, 800_000, 100_000, "cuda", "x") != \
            autotune.cache_key("grid_mxu", False, 800_000, 100_000, "cuda", "x")
        for name, key in (("grid_mxu", autotune.grid_mxu_cache_key), ("grid3d_mxu", autotune.grid3d_mxu_cache_key)):
            assert key(True, 10, 20, "cuda", "x") == getattr(jax_autotune, f"{name}_cache_key")(True, 10, 20, "cuda",
                                                                                                "x")
        assert autotune.toafit_cache_key(84, 10_000, "cuda", "x") == jax_autotune.toafit_cache_key(84, 10_000, "cuda",
                                                                                                  "x")

    def test_consumers_take_the_cached_verdicts(self):
        autotune.store_grid_mxu(True, 3000, 300, {"grid_mxu": 1, "reseed": 16, "mxu_bf16": 0})
        assert search.resolve_grid_mxu(n_events=3000, n_trials=300, poly=True) == (True, 16, False)
        assert search.resolve_grid_mxu(False, n_events=3000, n_trials=300, poly=True) == (False, 16, False)
        autotune.store_toafit(3, 1000, {"err_dense_window": 8, "mxu_bf16": 1})
        cfg = toafit.resolve_runtime_cfg(toafit.ToAFitConfig(), 3, 1000)
        assert (cfg.err_dense_window, cfg.mxu_bf16) == (8, 1)
        assert toafit.resolve_runtime_cfg(toafit.ToAFitConfig(mxu_bf16=0), 3, 1000).mxu_bf16 == 0
        from crimp_tpu_torch.ops import deltafold

        autotune.store_delta_fold(500, {"delta_fold": 1, "budget": 3e-9})
        assert deltafold.resolve_delta_fold(n_events=500) == (1, 3e-9)
        assert deltafold.resolve_delta_fold(0, None, n_events=500) == (0, 3e-9)


# -- the bf16 Fourier profile sweep ---------------------------------------------------


@pytest.fixture(scope="module")
def workload():
    rng = np.random.RandomState(77)
    kind = jax_profiles.FOURIER
    tpl = template(kind)
    phases = draw_phases(kind, tpl, 4000, rng, ph_shift=0.4)
    port_tpl = convert.profile_from_arrays(kind, {f.name: np.asarray(getattr(tpl, f.name))
                                                  for f in dataclasses.fields(tpl)})
    return kind, tpl, port_tpl, phases


def port_fit(kind, tpl, phases, **cfg):
    out = toafit.fit_toas_batch(kind, tpl, phases[None, :], np.ones((1, phases.size), dtype=bool),
                                np.array([phases.size / 17.0]), toafit.ToAFitConfig(kind=kind, **cfg), device="cpu")
    return {k: float(v[0]) for k, v in out.items() if v.dim() == 1}


class TestMxuBf16:
    def test_bf16_off_is_bitwise_default(self, workload):
        kind, _, tpl, phases = workload
        default, exact = port_fit(kind, tpl, phases), port_fit(kind, tpl, phases, mxu_bf16=0)
        for key in ("phShift", "phShift_LL", "phShift_UL", "logLmax", "norm"):
            assert default[key] == exact[key], key

    def test_bf16_agrees_with_jax_and_stays_under_the_error_bar(self, workload):
        kind, jax_tpl, tpl, phases = workload
        exact = port_fit(kind, tpl, phases, mxu_bf16=0)
        bf16 = port_fit(kind, tpl, phases, mxu_bf16=1)
        jax_bf16 = fit_one(kind, jax_tpl, phases, phases.size / 17.0, mxu_bf16=1)
        err = max(exact["phShift_UL"], exact["phShift_LL"])
        assert abs(bf16["phShift"] - exact["phShift"]) < 0.5 * err
        assert abs(bf16["phShift"] - jax_bf16["phShift"]) < 0.5 * err
        assert np.isfinite(bf16["logLmax"]) and bf16["phShift"] != exact["phShift"]

    def test_the_knob_reaches_the_sweep(self, workload, monkeypatch):
        kind, _, tpl, phases = workload
        seg = [phases[:2000], phases[2000:]]
        padded, masks = toafit.pad_segments(seg)
        exps = np.array([2000 / 17.0, 2000 / 17.0])
        cfg = toafit.ToAFitConfig(kind=kind)
        off = toafit.fit_toas_batch_auto(kind, tpl, padded, masks, exps, cfg, device="cpu")
        monkeypatch.setenv("CRIMP_TORCH_MXU_BF16", "1")
        on = toafit.fit_toas_batch_auto(kind, tpl, padded, masks, exps, cfg, device="cpu")
        want = toafit.fit_toas_batch(kind, tpl, padded, masks, exps, cfg._replace(mxu_bf16=1, err_dense_window=32),
                                     device="cpu")
        np.testing.assert_array_equal(on["phShift"], want["phShift"].numpy())
        assert not np.array_equal(on["logLmax"], off["logLmax"])


class TestKeptPlans:
    """A card's plan kept per shape (``autotune._kept``): the resolution
    runs once a shape, a repeat replays the cache counts it counted, and a
    knob change, a stored verdict, an entries scope, an armed fault or a
    CPU call resolve again. ``torch.device("cuda")`` names the card here
    without one: the memo keys on the name, and the resolution is stubbed."""

    def test_a_shape_resolves_once_and_replays_its_counts(self, monkeypatch, tmp_path):
        from crimp_tpu_torch import obs

        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path / "obs"))
        autotune._forget_plans()
        calls = []

        def resolve():
            calls.append(1)
            autotune._count_cache(False)
            return {"plan": len(calls)}

        card = torch.device("cuda")
        with obs.run("kept"):
            first = autotune._kept("t", (1, 2), None, card, resolve)
            first["plan"] = 99  # the caller's copy
            again = autotune._kept("t", (1, 2), None, card, resolve)
            other = autotune._kept("t", (1, 3), None, card, resolve)
        assert again == {"plan": 1} and other == {"plan": 2} and len(calls) == 2
        with open(obs.last_manifest_path()) as fh:
            assert json.load(fh)["counters"]["autotune_cache_misses"] == 3

    @pytest.mark.parametrize("change", ["knob", "store", "scope", "fault", "cpu"])
    def test_what_resolves_again(self, monkeypatch, change):
        autotune._forget_plans()
        calls = []

        def resolve():
            calls.append(1)
            return len(calls)

        card = torch.device("cuda")
        assert autotune._kept("t", (7,), None, card, resolve) == 1
        if change == "knob":
            monkeypatch.setenv("CRIMP_TORCH_GRID_BLOCKS", "50176,256")
            assert autotune._kept("t", (7,), None, card, resolve) == 2
        elif change == "store":
            autotune.store_grid_mxu(True, 10, 20, {"grid_mxu": 0, "reseed": 64, "mxu_bf16": 0})
            assert autotune._kept("t", (7,), None, card, resolve) == 2
        elif change == "scope":
            with autotune.entries_scope({}):
                assert autotune._kept("t", (7,), None, card, resolve) == 2
        elif change == "fault":
            monkeypatch.setenv("CRIMP_TORCH_FAULTS", "oom:harmonic_sums:9")
            assert autotune._kept("t", (7,), None, card, resolve) == 2
        else:
            assert autotune._kept("t", (7,), None, torch.device("cpu"), resolve) == 2
        # the kept plan again, or a new one kept; an armed fault keeps none
        assert autotune._kept("t", (7,), None, card, resolve) == {"scope": 1, "cpu": 1, "fault": 3}.get(change, 2)
