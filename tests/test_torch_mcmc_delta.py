"""Parity of the port's delta-basis MCMC (crimp_tpu_torch.ops.mcmc.delta_logprob,
pipelines.fit_toas.make_logprob_delta and run_mcmc(mcmc_delta=1)) with
crimp_tpu, on tests/test_mcmc_delta.py's glitch-bearing synthetic fit.

- delta_logprob at 64 seeded theta (some outside the prior box): rtol 1e-10
  against crimp_tpu's, -inf in the same places; batched over problems it
  equals the per-problem calls; masked rows are inert bitwise;
- make_logprob_delta's eligibility and reason equal crimp_tpu's on the
  eligible, non-linear, unbounded and over-budget free sets;
- run_mcmc(mcmc_delta=1) fed the draws jax.random makes from crimp_tpu's key
  (tests/test_torch_mcmc.py::_jax_draws): the chain within rtol 1e-10 of
  crimp_tpu's, and the sampler's chain and log-probs too; a refused set
  takes the exact likelihood, bit for bit the mcmc_delta=0 run;
- fit_toas(mcmc_delta=1, delta_fold=1) on tests/test_fit_toas.py's fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimp_tpu.io.yamlcfg import Prior as JaxPrior
from crimp_tpu.ops import mcmc as jax_mcmc
from crimp_tpu.pipelines import fit_toas as jax_fit_toas
from crimp_tpu_torch.io.parfile import get_parameter_value, read_timing_model
from crimp_tpu_torch.io.yamlcfg import Prior
from crimp_tpu_torch.ops import mcmc
from crimp_tpu_torch.pipelines import fit_toas
from tests.test_fit_toas import F0_TRUE, F1_TRUE, synth_tim, write_par
from tests.test_mcmc_delta import KEYS, WIDTHS, _problem
from tests.test_torch_mcmc import _jax_draws

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _quiet_knobs(monkeypatch):
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE", "0")
    for var in ("CRIMP_TPU_MCMC_DELTA", "CRIMP_TPU_DELTA_FOLD_BUDGET", "CRIMP_TPU_FAULTS"):
        monkeypatch.delenv(var, raising=False)


def _both(widths=None, keys=KEYS, extra_bounds=None):
    parfile, prior, t, y, yerr = _problem(widths=widths)
    bounds = {**prior.bounds, **(extra_bounds or {})}
    port = fit_toas.make_logprob_delta(parfile, keys, Prior(dict(bounds), {}), t, y, yerr, budget=1e-9,
                                       device="cpu")
    ref = jax_fit_toas.make_logprob_delta(parfile, keys, JaxPrior(dict(bounds), {}), t, y, yerr, budget=1e-9)
    return port, ref, (parfile, bounds, t, y, yerr)


def _thetas(n, seed, widths=WIDTHS):
    w = np.array([widths[k] for k in KEYS])
    return np.random.RandomState(seed).uniform(-1.2, 1.2, (n, len(KEYS))) * w


class TestDeltaLogProb:
    def test_matches_jax_at_64_theta(self):
        ((data, info), (data_ref, info_ref), _) = _both()
        assert info["eligible"] and info_ref["eligible"]
        np.testing.assert_allclose(data["basis"].numpy(), np.asarray(data_ref["basis"]), rtol=1e-14, atol=0)
        theta = _thetas(64, seed=3)
        got = mcmc.delta_logprob(torch.as_tensor(theta), data).numpy()
        want = np.asarray(jax.vmap(lambda th: jax_mcmc.delta_logprob(th, data_ref))(jnp.asarray(theta)))
        outside = ~np.isfinite(want)
        assert got.shape == (64,) and 0 < outside.sum() < 64
        np.testing.assert_array_equal(~np.isfinite(got), outside)
        assert np.all(got[outside] == -np.inf)
        np.testing.assert_allclose(got[~outside], want[~outside], rtol=1e-10)

    def test_batched_problems_and_inert_padding(self):
        rng = np.random.default_rng(1)
        n, pad, ndim = 24, 8, 2
        basis = rng.normal(size=(n + pad, ndim))
        y, err = rng.normal(size=n + pad), np.abs(rng.normal(1.0, 0.1, n + pad))
        mask = np.concatenate([np.ones(n), np.zeros(pad)])

        def data_of(b, yy, ee):
            return {"basis": torch.as_tensor(b), "y": torch.as_tensor(yy), "err": torch.as_tensor(ee),
                    "mask": torch.as_tensor(mask), "lo": torch.tensor([-10.0, -10.0], dtype=torch.float64),
                    "hi": torch.tensor([10.0, 10.0], dtype=torch.float64)}

        theta = torch.as_tensor(rng.uniform(-1, 1, (5, ndim)))
        clean = mcmc.delta_logprob(theta, data_of(basis, y, err))
        b2, y2, e2 = basis.copy(), y.copy(), err.copy()
        b2[n:], y2[n:], e2[n:] = 1e6, -1e6, 3.0
        assert torch.equal(clean, mcmc.delta_logprob(theta, data_of(b2, y2, e2)))
        # a leading problem axis gives the per-problem results
        d1, d2 = data_of(basis, y, err), data_of(b2, y2 * 0.5, e2)
        stacked = {k: torch.stack([d1[k], d2[k]]) for k in d1}
        theta2 = torch.stack([theta, theta * 0.5])
        both = mcmc.delta_logprob(theta2, stacked)
        assert both.shape == (2, 5)
        torch.testing.assert_close(both[0], mcmc.delta_logprob(theta, d1), rtol=1e-14, atol=0)
        torch.testing.assert_close(both[1], mcmc.delta_logprob(theta * 0.5, d2), rtol=1e-14, atol=0)


class TestGuard:
    @pytest.mark.parametrize("case", ["eligible", "nonlinear", "unbounded", "over_budget"])
    def test_eligibility_and_reason_equal_jax(self, case):
        keys, widths, extra = KEYS, None, None
        if case == "nonlinear":
            keys, extra = KEYS + ["GLTD_1"], {"GLTD_1": (1.0, 100.0)}
        elif case == "unbounded":
            extra = {"F0": (-np.inf, np.inf)}
        elif case == "over_budget":
            widths = {"F0": 1e3, "F1": 1.0, "GLF0_1": 1e3}
        (data, info), (data_ref, info_ref), _ = _both(widths=widths, keys=keys, extra_bounds=extra)
        assert (data is None) == (data_ref is None) == (case != "eligible")
        assert info["eligible"] == info_ref["eligible"] and info["reason"] == info_ref["reason"]
        if "bound_cycles" in info_ref:
            assert info["bound_cycles"] == pytest.approx(info_ref["bound_cycles"], rel=1e-12)
            assert info["nonlinear_sha"] == info_ref["nonlinear_sha"]


class TestRunMcmcDelta:
    def test_fed_jax_draws_chain_matches_jax(self):
        parfile, prior, t, y, yerr = _problem()
        key = jax.random.PRNGKey(0)
        draws = _jax_draws(key, 120, 16)
        chain, _, summ = fit_toas.run_mcmc(t, y, yerr, parfile, KEYS, Prior(dict(prior.bounds), {}), steps=120,
                                           burn=20, walkers=16, seed=0, mcmc_delta=1, device="cpu", draws=draws)
        chain_ref, _, summ_ref = jax_fit_toas.run_mcmc(t, y, yerr, parfile, KEYS, prior, steps=120, burn=20,
                                                       walkers=16, seed=0, mcmc_delta=1)
        assert chain.shape == (120, 16, 3)
        np.testing.assert_allclose(chain, np.asarray(chain_ref), rtol=1e-10, atol=0)
        assert len(np.unique(chain[:, :, 0])) > 50  # proposals were accepted
        for k in KEYS:
            assert summ[k]["median"] == pytest.approx(summ_ref[k]["median"], rel=1e-10)

    def test_sampler_chain_and_logprobs_match_jax(self):
        (data, _), (data_ref, _), _ = _both()
        p0 = np.random.default_rng(0).uniform(-1, 1, (16, 3)) * np.array([WIDTHS[k] for k in KEYS])
        key = jax.random.PRNGKey(5)
        chain_ref, lps_ref = jax_mcmc.ensemble_sample(jax_mcmc.delta_logprob, jnp.asarray(p0), 80, key,
                                                      data=data_ref)
        chain, lps = mcmc.ensemble_sample_draws(mcmc.delta_logprob, torch.as_tensor(p0), _jax_draws(key, 80, 16),
                                                data=data)
        np.testing.assert_allclose(chain.numpy(), np.asarray(chain_ref), rtol=1e-10, atol=0)
        np.testing.assert_allclose(lps.numpy(), np.asarray(lps_ref), rtol=1e-10, atol=0)

    def test_refused_set_takes_the_exact_likelihood_bitwise(self):
        parfile, prior, t, y, yerr = _problem(widths={"F0": 1e3, "F1": 1.0, "GLF0_1": 1e3})
        kw = dict(steps=40, burn=5, walkers=8, seed=2, device="cpu")
        off, _, _ = fit_toas.run_mcmc(t, y, yerr, parfile, KEYS, Prior(dict(prior.bounds), {}), mcmc_delta=0, **kw)
        on, _, _ = fit_toas.run_mcmc(t, y, yerr, parfile, KEYS, Prior(dict(prior.bounds), {}), mcmc_delta=1, **kw)
        np.testing.assert_array_equal(on, off)

    def test_fit_toas_delta_paths_on_the_fixture(self, tmp_path):
        par_true = write_par(tmp_path / "true.par", F0_TRUE + 2.0e-9, F1_TRUE)
        par_base = write_par(tmp_path / "base.par", F0_TRUE, F1_TRUE, fit_f0=True)
        tim_path = synth_tim(tmp_path / "toas.tim", par_true)
        (tmp_path / "prior.yaml").write_text("F0: [-1.0e-8, 1.0e-8]\n")
        kw = dict(mcmc=True, mcmc_steps=600, mcmc_burn=150, mcmc_walkers=16, init_yaml=str(tmp_path / "prior.yaml"),
                  device="cpu")
        res = fit_toas.fit_toas(tim_path, par_base, str(tmp_path / "d.par"), mcmc_delta=1, delta_fold=1, **kw)
        f0_fit = get_parameter_value(read_timing_model(str(tmp_path / "d.par"))[2]["F0"])
        assert abs(f0_fit - (F0_TRUE + 2.0e-9)) < 5.0e-11
        exact = fit_toas.fit_toas(tim_path, par_base, str(tmp_path / "e.par"), mcmc_delta=1, **kw)
        np.testing.assert_array_equal(res["values"], exact["values"])  # the same chain, either post-fit path
        np.testing.assert_allclose(res["post_fit_residuals"], exact["post_fit_residuals"], rtol=0, atol=1e-9)
