"""Parity of the port's ensemble MCMC (crimp_tpu_torch.ops.mcmc) and exact
timing log-probability (crimp_tpu_torch.pipelines.fit_toas) with crimp_tpu.

- The exact log-probability at 64 seeded theta (some outside the prior box)
  for five free sets against crimp_tpu's make_logprob_parts, vmapped:
  rtol 1e-10 and -inf in the same places.
- The inner sampler fed the draws that jax.random makes from crimp_tpu's
  key sequence (ops/mcmc.py: split per step, per half, then partner /
  stretch / accept): 50 steps x 8 walkers on a 2-D Gaussian and on the
  {F0} timing problem; chain and log-probs within rtol 1e-10.
- The generator path: Gaussian posterior recovery, hard bounds, determinism
  for a seed, batched problems (the properties of tests/test_mcmc.py).
- summarize_chain and effective_sample_size equal crimp_tpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimp_tpu.io import yamlcfg as jax_yamlcfg
from crimp_tpu.io.parfile import read_timing_model as jax_read_timing_model
from crimp_tpu.ops import mcmc as jax_mcmc
from crimp_tpu.pipelines import fit_toas as jax_fit_toas
from crimp_tpu_torch.io import yamlcfg
from crimp_tpu_torch.io.parfile import read_timing_model
from crimp_tpu_torch.ops import mcmc
from crimp_tpu_torch.pipelines import fit_toas

torch.set_num_threads(2)

PAR_TEXT = """PSR J0000+0000
F0 0.15 1
F1 -1.0e-13 1
PEPOCH 58300.0
GLEP_1 58250.0
GLPH_1 0.0 1
GLF0_1 2.0e-9 1
GLF0D_1 1.0e-9
GLTD_1 20.0
WAVEEPOCH 58300.0
WAVE_OM 0.03 1
WAVE1 0.002 -0.001
WAVE2 0.0005 0.0003
"""

BOUNDS = {
    "F0": (-1e-9, 1e-9), "F1": (-1e-16, 1e-16), "GLPH_1": (-0.2, 0.2),
    "GLF0_1": (-1e-9, 1e-9), "WAVE1_A": (-0.005, 0.005), "WAVE1_B": (-0.005, 0.005),
}
FREE_SETS = {
    "F0": ["F0"],
    "F0_F1": ["F0", "F1"],
    "glitch": ["GLF0_1", "GLPH_1"],
    "waves": ["WAVE1_A", "WAVE1_B"],
    "waves_and_spin": ["F0", "WAVE1_A", "WAVE1_B"],
}


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    path = tmp_path_factory.mktemp("mcmc") / "model.par"
    path.write_text(PAR_TEXT)
    rng = np.random.RandomState(11)
    x = np.sort(rng.uniform(58100.0, 58500.0, 40))
    y = rng.normal(0.0, 2e-3, 40)
    yerr = np.full(40, 2e-3) * rng.uniform(0.8, 1.2, 40)
    return str(path), x, y, yerr


def _parts(problem, keys):
    path, x, y, yerr = problem
    bounds = {k: BOUNDS[k] for k in keys}
    port = fit_toas.make_logprob_parts(read_timing_model(path)[2], keys,
                                       yamlcfg.Prior(bounds, {}), x, y, yerr, device="cpu")
    ref = jax_fit_toas.make_logprob_parts(jax_read_timing_model(path)[2], keys,
                                          jax_yamlcfg.Prior(bounds, {}), x, y, yerr)
    return port, ref


def _thetas(keys, n, seed):
    """n theta rows, uniform over 1.2x the prior box (so some fall outside)."""
    rng = np.random.RandomState(seed)
    lo = np.array([BOUNDS[k][0] for k in keys])
    hi = np.array([BOUNDS[k][1] for k in keys])
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    return mid + 1.2 * half * rng.uniform(-1.0, 1.0, (n, len(keys)))


def _jax_draws(key, steps, n_walkers):
    """crimp_tpu's random numbers, drawn in its order, as port Draws."""
    half = n_walkers // 2
    partner, stretch, accept = [], [], []
    for k in jax.random.split(key, steps):
        rows = ([], [], [])
        for kk, m, n_others in zip(jax.random.split(k), (half, n_walkers - half),
                                   (n_walkers - half, half)):
            k_part, k_z, k_accept = jax.random.split(kk, 3)
            rows[0].append(np.asarray(jax.random.randint(k_part, (m,), 0, n_others)))
            rows[1].append(np.asarray(jax.random.uniform(k_z, (m,))))
            rows[2].append(np.asarray(jax.random.uniform(k_accept, (m,))))
        partner.append(np.concatenate(rows[0]))
        stretch.append(np.concatenate(rows[1]))
        accept.append(np.concatenate(rows[2]))
    return mcmc.Draws(torch.as_tensor(np.stack(partner), dtype=torch.int64),
                      torch.as_tensor(np.stack(stretch)), torch.as_tensor(np.stack(accept)))


class TestExactLogProb:
    @pytest.mark.parametrize("name", list(FREE_SETS))
    def test_matches_jax(self, problem, name):
        keys = FREE_SETS[name]
        (fn, data), (fn_ref, data_ref) = _parts(problem, keys)
        theta = _thetas(keys, 64, seed=len(name))
        got = fn(torch.as_tensor(theta), data).numpy()
        want = np.asarray(jax.vmap(lambda th: fn_ref(th, data_ref))(jnp.asarray(theta)))
        assert got.shape == (64,)
        outside = ~np.isfinite(want)
        assert 0 < outside.sum() < 64
        np.testing.assert_array_equal(~np.isfinite(got), outside)
        assert np.all(got[outside] == -np.inf)
        np.testing.assert_allclose(got[~outside], want[~outside], rtol=1e-10)

    def test_make_logprob_closure_and_single_theta(self, problem):
        path, x, y, yerr = problem
        lp = fit_toas.make_logprob(read_timing_model(path)[2], ["F0"],
                                   yamlcfg.Prior({"F0": BOUNDS["F0"]}, {}), x, y, yerr, device="cpu")
        theta = torch.as_tensor(_thetas(["F0"], 5, seed=2))
        batch = lp(theta)
        for i in range(5):
            np.testing.assert_allclose(lp(theta[i]).numpy(), batch[i].numpy(), rtol=1e-14)

    def test_unknown_key_raises(self, problem):
        with pytest.raises(KeyError, match="cannot fit"):
            fit_toas._delta_model_updates(read_timing_model(problem[0])[2], ["RAJ"])


class TestFedDraws:
    def test_gaussian_chain_matches_jax(self):
        mean, std = np.array([1.5, -2.0]), np.array([0.7, 0.2])
        p0 = np.random.RandomState(0).normal(mean, [0.5, 0.5], size=(8, 2))
        key = jax.random.PRNGKey(1)
        chain_ref, lps_ref = jax_mcmc.ensemble_sample(
            lambda th: -0.5 * jnp.sum(((th - mean) / std) ** 2), jnp.asarray(p0), 50, key)
        m, s = torch.as_tensor(mean), torch.as_tensor(std)
        chain, lps = mcmc.ensemble_sample_draws(
            lambda th: -0.5 * torch.sum(((th - m) / s) ** 2, dim=-1), torch.as_tensor(p0),
            _jax_draws(key, 50, 8))
        assert chain.shape == (50, 8, 2) and lps.shape == (50, 8)
        np.testing.assert_allclose(chain.numpy(), np.asarray(chain_ref), rtol=1e-10, atol=0)
        np.testing.assert_allclose(lps.numpy(), np.asarray(lps_ref), rtol=1e-10, atol=0)
        assert len(np.unique(chain.numpy()[:, 0, 0])) > 5  # the walkers move

    def test_f0_problem_chain_matches_jax(self, problem):
        (fn, data), (fn_ref, data_ref) = _parts(problem, ["F0"])
        p0 = np.random.default_rng(0).uniform(*BOUNDS["F0"], size=(8, 1))
        key = jax.random.PRNGKey(0)
        chain_ref, lps_ref = jax_mcmc.ensemble_sample(fn_ref, jnp.asarray(p0), 50, key, data=data_ref)
        chain, lps = mcmc.ensemble_sample_draws(fn, torch.as_tensor(p0), _jax_draws(key, 50, 8),
                                                data=data)
        np.testing.assert_allclose(chain.numpy(), np.asarray(chain_ref), rtol=1e-10, atol=0)
        np.testing.assert_allclose(lps.numpy(), np.asarray(lps_ref), rtol=1e-10, atol=0)
        assert len(np.unique(chain.numpy())) > 20  # proposals were accepted


class TestGeneratorPath:
    def test_gaussian_posterior_recovered(self):
        mean, std = torch.tensor([1.5, -2.0], dtype=torch.float64), torch.tensor([0.7, 0.2], dtype=torch.float64)
        p0 = np.random.RandomState(0).normal([1.5, -2.0], [0.1, 0.1], size=(32, 2))
        chain, _ = mcmc.ensemble_sample(lambda th: -0.5 * torch.sum(((th - mean) / std) ** 2, dim=-1),
                                        p0, steps=1500, seed=1, device="cpu")
        flat = chain[500:].reshape(-1, 2).numpy()
        np.testing.assert_allclose(flat.mean(axis=0), [1.5, -2.0], atol=0.05)
        np.testing.assert_allclose(flat.std(axis=0), [0.7, 0.2], rtol=0.15)

    def test_respects_hard_bounds(self):
        def log_prob(th):
            inside = torch.all((th > 0.0) & (th < 1.0), dim=-1)
            return torch.where(inside, 0.0, -torch.inf).to(th.dtype)

        p0 = np.random.RandomState(3).uniform(0.4, 0.6, size=(16, 1))
        chain, _ = mcmc.ensemble_sample(log_prob, p0, steps=500, seed=2, device="cpu")
        flat = chain.reshape(-1).numpy()
        assert flat.min() > 0.0 and flat.max() < 1.0
        assert flat.std() > 0.15

    def test_deterministic_for_a_seed(self):
        p0 = np.random.RandomState(7).normal(0, 1, (8, 2))
        lp = lambda th: -0.5 * torch.sum(th**2, dim=-1)
        c1, l1 = mcmc.ensemble_sample(lp, p0, steps=50, seed=9, device="cpu")
        c2, l2 = mcmc.ensemble_sample(lp, p0, steps=50, seed=9, device="cpu")
        c3, _ = mcmc.ensemble_sample(lp, p0, steps=50, seed=10, device="cpu")
        assert torch.equal(c1, c2) and torch.equal(l1, l2)
        assert not torch.equal(c1, c3)

    def test_batch_recovers_each_problem(self):
        mus = torch.tensor([[-2.0, 0.5], [3.0, -1.0], [0.0, 0.0]], dtype=torch.float64)
        sigmas = torch.tensor([0.5, 1.5, 1.0], dtype=torch.float64)

        def log_prob(theta, data):
            return -0.5 * torch.sum(((theta - data["mu"][:, None]) / data["sigma"][:, None, None]) ** 2, dim=-1)

        p0 = np.random.RandomState(0).uniform(-5, 5, (3, 16, 2))
        chains, lps = mcmc.ensemble_sample_batch(log_prob, p0, {"mu": mus, "sigma": sigmas}, 1500,
                                                 seed=3, device="cpu")
        assert chains.shape == (3, 1500, 16, 2) and lps.shape == (3, 1500, 16)
        assert torch.isfinite(lps).all()
        for b in range(3):
            flat = chains[b, 500:].reshape(-1, 2).numpy()
            np.testing.assert_allclose(flat.mean(axis=0), mus[b].numpy(), atol=0.25 * float(sigmas[b]) + 0.1)
            np.testing.assert_allclose(flat.std(axis=0), float(sigmas[b]), rtol=0.25)

    def test_graph_steps_need_cuda(self):
        draws = mcmc.ensemble_draws(10, 4, device="cpu")
        with pytest.raises(ValueError, match="CUDA"):
            mcmc.ensemble_sample_draws(lambda th: -th.sum(-1), torch.zeros(4, 1, dtype=torch.float64),
                                       draws, graph_steps=5)

    def test_draws_respect_half_ranges(self):
        d = mcmc.ensemble_draws(200, 7, seed=4, device="cpu")
        assert d.partner.shape == d.stretch_u.shape == d.accept_u.shape == (200, 7)
        assert d.partner[:, :3].max() == 3 and d.partner[:, 3:].max() == 2
        assert d.partner.min() == 0 and float(d.stretch_u.max()) < 1.0


class TestSummaries:
    def test_summarize_and_ess_equal_jax(self):
        rng = np.random.RandomState(5)
        chain = np.cumsum(rng.normal(size=(400, 8, 3)), axis=0) * 0.01 + rng.normal(size=(400, 8, 3))
        lps = rng.normal(size=(400, 8))
        flat, flat_lp, summ = mcmc.summarize_chain(torch.as_tensor(chain), lps, ["a", "b", "c"], burn=40)
        flat_r, flat_lp_r, summ_r = jax_mcmc.summarize_chain(chain, lps, ["a", "b", "c"], burn=40)
        np.testing.assert_array_equal(flat, flat_r)
        np.testing.assert_array_equal(flat_lp, flat_lp_r)
        assert summ == summ_r
        np.testing.assert_array_equal(mcmc.effective_sample_size(chain), jax_mcmc.effective_sample_size(chain))
        assert mcmc.effective_sample_size(chain[:, :, 0]) == jax_mcmc.effective_sample_size(chain[:, :, 0])
        assert mcmc.effective_sample_size(np.ones((100, 4))) == 400.0
        with pytest.raises(ValueError, match="nothing would be left"):
            mcmc.summarize_chain(chain, lps, ["a", "b", "c"], burn=400)
        with pytest.raises(ValueError, match="1-D, 2-D or 3-D"):
            mcmc.effective_sample_size(np.zeros((2, 2, 2, 2)))
