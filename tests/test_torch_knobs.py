"""The port's knob registry (crimp_tpu_torch.knobs) against crimp_tpu.knobs.

- every port knob is a crimp_tpu knob under the CRIMP_TORCH_ prefix, with
  crimp_tpu's suffix, kind and default; the port adds none of its own;
- the parse helpers read every spelling as crimp_tpu's do;
- neither package's setting steers the other;
- at every consumer the explicit argument beats the environment, which
  beats crimp_tpu's default: the grid fast path, the factorized grid
  (GRID_MXU, reseed 64), the stream threshold, the dense error window, the
  delta fold and its budget and cache, the delta MCMC and the multisource
  knobs, and the knobs of the measuring and tuning layer (GRID_BLOCKS,
  MXU_BF16, OBS_COST, OBS_LEDGER, RETRIES, BACKOFF_S, COMPILE_CACHE,
  TRACE_DIR), and of the parallel layer (SHARD, DIST).
"""

import numpy as np
import pytest
import torch

from crimp_tpu import knobs as jax_knobs
from crimp_tpu.ops import autotune as jax_autotune
from crimp_tpu_torch import knobs
from crimp_tpu_torch.ops import autotune, deltafold, search, toafit

torch.set_num_threads(2)

SUFFIXES = {"GRID_FASTPATH", "GRID_MXU", "STREAM_MIN_EVENTS", "TOA_DENSE_WINDOW", "DELTA_FOLD",
            "DELTA_FOLD_BUDGET", "FOLD_CACHE", "MCMC_DELTA", "MULTISOURCE", "MULTISOURCE_MAX_PAD",
            "MULTISOURCE_BATCH", "OBS", "OBS_DIR", "OBS_EVENTS", "OBS_HEARTBEAT_S", "OBS_HOST", "FAULTS",
            "AUTOTUNE", "AUTOTUNE_CACHE", "SERVE_QUEUE", "SERVE_DEADLINE_MS", "SERVE_BREAKER", "SERVE_WARM_BATCH",
            "SERVE_PREP_OVERLAP", "GRID_BLOCKS", "MXU_BF16", "OBS_COST", "OBS_LEDGER", "RETRIES", "BACKOFF_S",
            "COMPILE_CACHE", "TRACE_DIR", "SHARD", "DIST", "POLY_TRIG", "HBM_WARN_PCT"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for suffix in SUFFIXES:
        monkeypatch.delenv(f"CRIMP_TORCH_{suffix}", raising=False)
        monkeypatch.delenv(f"CRIMP_TPU_{suffix}", raising=False)
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE", "0")


class TestRegistry:
    def test_same_knobs_as_jax_under_the_port_prefix(self):
        assert {name[len(knobs.PREFIX):] for name in knobs.REGISTRY} == SUFFIXES
        for name, k in knobs.REGISTRY.items():
            ref = jax_knobs.REGISTRY["CRIMP_TPU_" + name[len(knobs.PREFIX):]]
            # the port keeps its own verdict-cache file, its compile cache is
            # the nvcc build directory of the checkout, and the card plays the
            # TPU's part in the poly-trig auto rule
            default = ref.default.replace("jax process index", "torch.distributed rank").replace(
                "auto (on for TPU backends)", "auto (on for the card, off on the CPU)").replace(
                "/crimp_tpu/", "/crimp_tpu_torch/").replace("~/.cache/crimp_tpu_torch/jax_cache",
                                                            "build/kernels (in the checkout)")
            assert (k.kind, k.default, k.numeric) == (ref.kind, default, ref.numeric), name
        assert knobs.REGISTRY["CRIMP_TORCH_MXU_BF16"].numeric_key == "grid_mxu"

    def test_unregistered_names_and_other_prefixes_raise(self):
        with pytest.raises(KeyError):
            knobs.raw("CRIMP_TORCH_NOT_A_KNOB")
        with pytest.raises(KeyError):
            knobs.raw("CRIMP_TPU_GRID_MXU")
        with pytest.raises(ValueError, match="namespace"):
            knobs._build_registry((knobs.Knob("CRIMP_TPU_X", "", "bool"),))

    @pytest.mark.parametrize("value", ["", "1", "on", "TRUE", " always ", "0", "off", "False", "never", "auto",
                                       "maybe", "yes", "3", "-1", "0.5", "1e-3", "inf", "nan", "x"])
    def test_parse_helpers_match_jax(self, monkeypatch, value):
        monkeypatch.setenv("CRIMP_TORCH_OBS", value)
        monkeypatch.setenv("CRIMP_TPU_OBS", value)

        def outcome(fn, *args):
            try:
                return fn(*args)
            except ValueError as exc:
                return type(exc)

        assert knobs.parse_onoff(value) == jax_knobs.parse_onoff(value)
        pairs = [(knobs.env_onoff, jax_knobs.env_onoff, ()), (knobs.env_nonneg_int, jax_knobs.env_nonneg_int, ()),
                 (knobs.env_nonneg_int, jax_knobs.env_nonneg_int, ((0, 1),)),
                 (knobs.env_pos_float, jax_knobs.env_pos_float, ()), (knobs.env_float, jax_knobs.env_float, (2.5,)),
                 (knobs.env_int, jax_knobs.env_int, (4,)), (knobs.env_str, jax_knobs.env_str, ("d",))]
        for port_fn, jax_fn, extra in pairs:
            got = outcome(port_fn, "CRIMP_TORCH_OBS", *extra)
            want = outcome(jax_fn, "CRIMP_TPU_OBS", *extra)
            if isinstance(want, float) and np.isnan(want):
                assert np.isnan(got)
            else:
                assert got == want, (port_fn.__name__, value)


class TestPrecedence:
    def test_grid_fastpath(self, monkeypatch):
        assert search.grid_fastpath_enabled(20) and not search.grid_fastpath_enabled(21)
        monkeypatch.setenv("CRIMP_TPU_GRID_FASTPATH", "0")
        assert search.grid_fastpath_enabled(2)  # the other package's knob
        monkeypatch.setenv("CRIMP_TORCH_GRID_FASTPATH", "0")
        assert not search.grid_fastpath_enabled(2)
        assert search.grid_fastpath_enabled(2, override=True)
        monkeypatch.setenv("CRIMP_TORCH_GRID_FASTPATH", "on")
        assert search.grid_fastpath_enabled(40)

    def test_grid_mxu_and_reseed(self, monkeypatch):
        assert search.resolve_grid_mxu() == (False, 64, False)
        assert search.GRID_MXU_RESEED == jax_autotune.grid_mxu_defaults()["reseed"] == 64
        monkeypatch.setenv("CRIMP_TPU_GRID_MXU", "1")
        assert search.resolve_grid_mxu() == (False, 64, False)
        assert jax_autotune.resolve_grid_mxu(100, 100)["grid_mxu"] == 1
        monkeypatch.setenv("CRIMP_TORCH_GRID_MXU", "1")
        assert search.resolve_grid_mxu() == (True, 64, False)
        assert search.resolve_grid_mxu(False, 16, True) == (False, 16, True)
        monkeypatch.setenv("CRIMP_TORCH_GRID_MXU", "on")
        with pytest.raises(ValueError, match="CRIMP_TORCH_GRID_MXU"):
            search.resolve_grid_mxu()

    def test_grid_mxu_knob_routes_the_grid(self, monkeypatch):
        t = np.sort(np.random.RandomState(3).uniform(-2e4, 2e4, 4000))
        exact = search.z2_power_grid(t, 0.25, 1e-6, 300, 2, device="cpu")
        fact = search.z2_power_grid(t, 0.25, 1e-6, 300, 2, device="cpu", mxu=True)
        assert not torch.equal(exact, fact)
        monkeypatch.setenv("CRIMP_TORCH_GRID_MXU", "1")
        assert torch.equal(search.z2_power_grid(t, 0.25, 1e-6, 300, 2, device="cpu"), fact)
        assert torch.equal(search.z2_power_grid(t, 0.25, 1e-6, 300, 2, device="cpu", mxu=False), exact)

    def test_stream_min_events(self, monkeypatch):
        assert search.stream_min_events() == 1 << 22
        monkeypatch.setenv("CRIMP_TORCH_STREAM_MIN_EVENTS", "off")
        assert search.stream_min_events() is None
        monkeypatch.setenv("CRIMP_TORCH_STREAM_MIN_EVENTS", "12345")
        assert search.stream_min_events() == 12345
        assert search.stream_min_events(77) == 77 and search.stream_min_events(None) is None
        monkeypatch.setenv("CRIMP_TORCH_STREAM_MIN_EVENTS", "lots")
        with pytest.raises(ValueError, match="stream_min_events"):
            search.stream_min_events()

    def test_dense_window(self, monkeypatch):
        cfg = toafit.ToAFitConfig(kind="fourier")
        assert toafit.resolve_runtime_cfg(cfg).err_dense_window == toafit.DENSE_WINDOW_DEFAULT == 32
        monkeypatch.setenv("CRIMP_TORCH_TOA_DENSE_WINDOW", "8")
        assert toafit.resolve_runtime_cfg(cfg).err_dense_window == 8
        assert toafit.resolve_runtime_cfg(cfg._replace(err_dense_window=4)).err_dense_window == 4

    def test_delta_fold_budget_and_cache(self, monkeypatch, tmp_path):
        assert deltafold.resolve_delta_fold() == (0, 1e-9)
        monkeypatch.setenv("CRIMP_TORCH_DELTA_FOLD", "1")
        monkeypatch.setenv("CRIMP_TORCH_DELTA_FOLD_BUDGET", "1e-7")
        assert deltafold.resolve_delta_fold() == (1, 1e-7)
        assert deltafold.resolve_delta_fold(0, 1e-8) == (0, 1e-8)
        monkeypatch.setenv("CRIMP_TORCH_DELTA_FOLD_BUDGET", "-1")
        with pytest.raises(ValueError):
            deltafold.resolve_delta_fold()
        assert deltafold.fold_cache_mode() == ("mem", None)
        for value, mode in (("off", "off"), ("0", "off"), ("auto", "mem"), ("mem", "mem"), ("disk", "disk")):
            monkeypatch.setenv("CRIMP_TORCH_FOLD_CACHE", value)
            assert deltafold.fold_cache_mode()[0] == mode
        monkeypatch.setenv("CRIMP_TORCH_FOLD_CACHE", str(tmp_path))
        assert deltafold.fold_cache_mode() == ("disk", tmp_path)
        assert deltafold.fold_cache_mode("off") == ("off", None)

    def test_delta_fold_knob_routes_fold_segments(self, monkeypatch):
        from crimp_tpu_torch.ops import anchored

        segs = [np.sort(58320.0 + np.random.RandomState(1).uniform(0.0, 50.0, 200))]
        tm = {"PEPOCH": 58330.0, "F0": 0.14, "F1": -1e-14}
        deltafold.clear_cache()
        monkeypatch.setenv("CRIMP_TORCH_DELTA_FOLD", "1")
        anchored.fold_segments(tm, segs, device="cpu")
        anchored.fold_segments(tm, segs, device="cpu")
        assert deltafold.last_fold_info()["mode"] == "cache"
        monkeypatch.setenv("CRIMP_TORCH_DELTA_FOLD", "0")
        deltafold.clear_cache()
        anchored.fold_segments(tm, segs, device="cpu")
        assert not deltafold._MEM_CACHE

    def test_multisource(self, monkeypatch):
        assert autotune.resolve_multisource(10, 100) == jax_autotune.resolve_multisource(10, 100) == \
            {"multisource": 1, "max_pad": 4.0, "batch_cap": 0}
        for suffix, value in (("MULTISOURCE", "0"), ("MULTISOURCE_MAX_PAD", "1.5"), ("MULTISOURCE_BATCH", "8")):
            monkeypatch.setenv(f"CRIMP_TORCH_{suffix}", value)
            monkeypatch.setenv(f"CRIMP_TPU_{suffix}", value)
            assert autotune.resolve_multisource(10, 100) == jax_autotune.resolve_multisource(10, 100)
        assert autotune.resolve_multisource(10, 100) == {"multisource": 0, "max_pad": 1.5, "batch_cap": 8}
        monkeypatch.setenv("CRIMP_TORCH_MULTISOURCE", "2")
        with pytest.raises(ValueError, match="CRIMP_TORCH_MULTISOURCE"):
            autotune.resolve_multisource(10, 100)
        assert autotune.multisource_blocks() == (1 << 15, 256)

    def test_new_knobs_read_as_jax(self, monkeypatch, tmp_path):
        from crimp_tpu_torch.obs import costmodel, ledger
        from crimp_tpu_torch.resilience import policy
        from crimp_tpu_torch.utils import platform, profiling

        monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
        # defaults: the static plan, bf16 off, capture on, no ledger, 1 retry
        # at 0.05 s, the checkout's build directory, no trace
        assert autotune.env_blocks_override("grid") is None
        assert autotune.resolve_toafit(1, 1)["mxu_bf16"] == jax_autotune.resolve_toafit(1, 1)["mxu_bf16"] == 0
        assert costmodel.cost_capture_on() and ledger.env_ledger_path() is None
        pol = policy.default_policy()
        assert (pol.retries, pol.backoff_s) == (1, 0.05)
        assert platform.compilation_cache_dir() == platform.DEFAULT_BUILD_DIR
        with profiling.trace() as prof:
            assert prof is None
        for suffix, value in (("GRID_BLOCKS", "2048,256"), ("MXU_BF16", "1"), ("OBS_COST", "0"),
                              ("OBS_LEDGER", str(tmp_path / "l.jsonl")), ("RETRIES", "0"), ("BACKOFF_S", "0"),
                              ("COMPILE_CACHE", str(tmp_path / "k")), ("TRACE_DIR", str(tmp_path / "t"))):
            monkeypatch.setenv(f"CRIMP_TORCH_{suffix}", value)
        assert autotune.resolve_blocks("grid", 100, 100) == (2048, 256)
        assert autotune.resolve_toafit(1, 1)["mxu_bf16"] == 1
        assert not costmodel.cost_capture_on() and ledger.env_ledger_path() == str(tmp_path / "l.jsonl")
        pol = policy.default_policy()
        assert (pol.retries, pol.backoff_s) == (0, 0.0)
        assert platform.compilation_cache_dir() == tmp_path / "k"
        with profiling.trace() as prof:
            assert prof is not None
        # the other package's settings never steer the port
        monkeypatch.setenv("CRIMP_TPU_GRID_BLOCKS", "4096,128")
        assert autotune.resolve_blocks("grid", 100, 100) == (2048, 256)

    def test_mcmc_delta_knob(self, monkeypatch, tmp_path):
        import json

        from crimp_tpu_torch import obs
        from crimp_tpu_torch.io.yamlcfg import Prior
        from crimp_tpu_torch.pipelines import fit_toas
        from tests.test_mcmc_delta import KEYS, _problem

        par, jax_prior, t, y, yerr = _problem(n_toas=30)
        prior = Prior(dict(jax_prior.bounds), {})
        kw = dict(steps=12, burn=2, walkers=8, seed=2, device="cpu")
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))

        def delta_steps(**extra):
            with obs.run("mcmc"):
                fit_toas.run_mcmc(t, y, yerr, par, KEYS, prior, **kw, **extra)
            return json.load(open(obs.last_manifest_path()))["counters"].get("mcmc_delta_path_steps", 0)

        assert delta_steps() == 0 and delta_steps(mcmc_delta=1) == 12
        monkeypatch.setenv("CRIMP_TPU_MCMC_DELTA", "1")
        assert delta_steps() == 0
        monkeypatch.setenv("CRIMP_TORCH_MCMC_DELTA", "1")
        assert delta_steps() == 12 and delta_steps(mcmc_delta=0) == 0
