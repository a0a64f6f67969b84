"""K6's Fourier term by angle addition and its pass schedule, on the CPU
(crimp_tpu_torch/ops/general_sweep.py, the twin of csrc/toafit_general.cu).

- ``harmonic_pairs``' recurrence against torch.cos / torch.sin of
  j 2 pi x, at K 1, 6 and 16 over 10^4 uniform phases: within 8 j ulp of 1.
  The pairs start from one rounded cos and sin (half an ulp each) and each
  step of the recurrence adds a few roundings, so the error grows about
  linearly in j; the reference's own argument j (2 pi x) rounds by at most
  half an ulp of 32 pi (3.6e-15 at j 16, under 8 ulp).
- ``general_nll``'s angle-form Fourier value against the direct form
  (the angle formed and its cos taken: (amp ampShift) cos((j 2 pi x + loc)
  - j phi), the same sums),
  on the bundled template with its 13 vary parameters free: relative 1e-13.
  The two differ by the angle's rounding (about 1e-14 absolute at K 6) in
  each term, far below a log-likelihood of ~1e4 at 1e-13.
- ``general_nll`` against crimp_tpu's ``-extended_loglik`` at the same
  vectors and phases: rtol 1e-12 (the packages' event sums in another
  order, the curve's angle rounded another way).
- ``pass_plan``, the passes over the events a K6 block makes, against hand
  counts: a problem takes ceil((F + 1) / 4) passes to start, one a
  candidate value read, ceil(F / 4) a shrink; equal problems side by side
  take the passes of one; a shrinking problem lengthens only its own block;
  a ragged last group is the longest of what it holds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimp_tpu.models import profiles as jax_profiles
from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.models import profiles
from crimp_tpu_torch.ops import general_sweep, optimize, toafit
from tests.conftest import TEMPLATE

torch.set_num_threads(2)

ULP1 = 2.0 ** -52


def _template_rows(seed: int = 3, n_rows: int = 2, n: int = 600):
    """The bundled template, its 13-parameter spec, and events drawn from its
    curve (the last row ragged)."""
    tpl_dict = template_io.read_template(TEMPLATE)
    kind, tpl = profiles.from_template(tpl_dict)
    idx, lo, hi, n_free = toafit.free_param_spec(kind, tpl_dict)
    rng = np.random.RandomState(seed)
    rate = lambda p: profiles.curve(kind, tpl, torch.as_tensor(p)).numpy()  # noqa: E731
    peak = rate(np.linspace(0, 1, 2048)).max() * 1.05
    acc = np.empty(0)
    while acc.size < n_rows * n:
        cand = rng.uniform(0, 1, 4 * n)
        acc = np.concatenate([acc, cand[rng.uniform(0, peak, cand.size) < rate(cand)]])
    x = acc[:n_rows * n].reshape(n_rows, n)
    mask = np.ones_like(x, dtype=bool)
    mask[-1, 2 * n // 3:] = False
    exposure = mask.sum(1) / float(tpl.norm)
    cfg = toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=hi, n_free=n_free)
    u = general_sweep.pack(tpl, cfg, n_rows)["u0"][:, None, None, :] + 0.3 * torch.as_tensor(
        rng.standard_normal((n_rows, 3, 4, len(idx))))
    phis = torch.as_tensor(rng.uniform(-math.pi, math.pi, (n_rows, 3)))
    return kind, tpl, cfg, torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(exposure), phis, u


def _direct_fourier_nll(pk, x, mask, exposure, phis, u):
    """The direct Fourier evaluation: each term (amp ampShift) cos((j 2 pi
    x + loc) - j phi), the same sums as general_nll."""
    vec = general_sweep.vectors(pk, u)
    K = (vec.shape[-1] - 2) // 3
    norm, amp_sh = vec[..., 0], vec[..., 1:1 + K] * vec[..., -1:]
    j = torch.arange(1, K + 1, dtype=x.dtype)
    cj = torch.tensor([float(k + 1) * 2 * math.pi for k in range(K)], dtype=x.dtype)
    terms = amp_sh[..., None] * torch.cos(cj[:, None] * x[:, None, None, None, :] + vec[..., 1 + K:1 + 2 * K, None]
                                          - j[:, None] * phis[:, :, None, None, None])
    total = terms[..., 0, :]
    for k in range(1, K):
        total = total + terms[..., k, :]
    normalized = (norm[..., None] + total) / norm[..., None]
    m = mask[:, None, None, :]
    log_sum = general_sweep.block_sum(torch.where(m, torch.log(torch.clamp(normalized, min=1e-300)), 0.0))
    min_val = torch.amin(torch.where(m, normalized, math.inf), dim=-1)
    expected = norm * exposure[:, None, None]
    n_events = torch.sum(mask, dim=-1).to(x.dtype)[:, None, None]
    value = -expected + n_events * torch.log(expected) + log_sum
    return -torch.where(min_val <= 0, -math.inf, value)


class TestHarmonicPairs:
    @pytest.mark.parametrize("n_comp", [1, 6, 16])
    def test_recurrence_against_direct_trig(self, n_comp):
        x = torch.as_tensor(np.random.RandomState(n_comp).uniform(0, 1, 10000))
        c, s = general_sweep.harmonic_pairs(x, n_comp)
        assert c.shape == s.shape == (n_comp, 10000)
        ang = general_sweep.TWO_PI * x
        for j in range(1, n_comp + 1):
            tol = 8 * j * ULP1
            assert float(torch.max(torch.abs(c[j - 1] - torch.cos(j * ang)))) <= tol, j
            assert float(torch.max(torch.abs(s[j - 1] - torch.sin(j * ang)))) <= tol, j
        # the first pair is the direct cos and sin of 2 pi x, bit for bit
        assert torch.equal(c[0], torch.cos(ang)) and torch.equal(s[0], torch.sin(ang))

    def test_leading_axes_are_rows(self):
        x = torch.as_tensor(np.random.RandomState(5).uniform(0, 1, (3, 700)))
        c, s = general_sweep.harmonic_pairs(x, 4)
        assert c.shape == (3, 4, 700)
        c1, s1 = general_sweep.harmonic_pairs(x[1], 4)
        assert torch.equal(c[1], c1) and torch.equal(s[1], s1)


class TestAngleFormFourier:
    def test_against_the_direct_form(self):
        kind, tpl, cfg, x, mask, exposure, phis, u = _template_rows()
        assert len(cfg.free_idx) == 13
        pk = general_sweep.pack(tpl, cfg, x.shape[0])
        got = general_sweep.general_nll(kind, pk, x, mask, exposure, phis, u)
        want = _direct_fourier_nll(pk, x, mask, exposure, phis, u)
        assert bool(torch.all(torch.isfinite(want)))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=0)

    def test_against_jax_extended_loglik(self):
        kind, tpl, cfg, x, mask, exposure, phis, u = _template_rows(seed=4)
        pk = general_sweep.pack(tpl, cfg, x.shape[0])
        got = general_sweep.general_nll(kind, pk, x, mask, exposure, phis, u).numpy()
        vec = general_sweep.vectors(pk, u).numpy()
        K = tpl.n_comp
        S, P, M, _ = u.shape
        for r in range(S):
            for p in range(P):
                for m in range(M):
                    v = vec[r, p, m]
                    params = jax_profiles.ProfileParams(
                        norm=jnp.asarray(v[0]), amp=jnp.asarray(v[1:1 + K]), loc=jnp.asarray(v[1 + K:1 + 2 * K]),
                        wid=jnp.asarray(v[1 + 2 * K:1 + 3 * K]), ph_shift=jnp.asarray(float(phis[r, p])),
                        amp_shift=jnp.asarray(v[-1]))
                    want = -float(jax_profiles.extended_loglik(kind, params, jnp.asarray(x[r].numpy()),
                                                               float(exposure[r]), jnp.asarray(mask[r].numpy())))
                    np.testing.assert_allclose(got[r, p, m], want, rtol=1e-12)


def _trace(steps, reads):
    """A per-step trace (optimize.nelder_mead's keys) from (S, P, iters)
    step codes and candidate values read."""
    steps, reads = torch.as_tensor(steps), torch.as_tensor(reads)
    return [{"step": steps[..., i], "reads": reads[..., i]} for i in range(steps.shape[-1])]


class TestPassPlan:
    def test_one_problem_by_hand(self):
        # F 13: 4 passes to start (14 vertices, 4 a pass); reflect (1), expand
        # tried (2), inside after outside (3), a shrink after the inside
        # (2 + ceil(13 / 4) = 6)
        trace = _trace([[[1, 0, 3, 4]]], [[[1, 2, 3, 2]]])
        assert general_sweep.pass_plan(trace, 13, 1).tolist() == [[4 + 1 + 2 + 3 + 2 + 4]]
        # F 2: one pass starts its 3 vertices, a shrink one more
        assert general_sweep.pass_plan(_trace([[[4, 1]]], [[[2, 1]]]), 2, 1).tolist() == [[1 + 2 + 1 + 1]]

    @pytest.mark.parametrize("group", [2, 4, 8])
    def test_equal_problems_take_the_passes_of_one(self, group):
        steps = np.tile(np.array([1, 1, 0, 2, 3, 1]), (2, 8, 1))
        reads = np.tile(np.array([1, 1, 2, 2, 3, 1]), (2, 8, 1))
        one = general_sweep.pass_plan(_trace(steps[:1, :1], reads[:1, :1]), 13, 1)
        got = general_sweep.pass_plan(_trace(steps, reads), 13, group)
        assert got.shape == (2, 8 // group)
        assert bool(torch.all(got == int(one)))
        assert int(one) == 4 + int(reads[0, 0].sum())

    def test_a_shrinking_problem_lengthens_only_its_block(self):
        steps = np.ones((1, 8, 5), dtype=np.int64)
        reads = np.ones((1, 8, 5), dtype=np.int64)
        steps[0, 5, 2], reads[0, 5, 2] = 4, 2  # problem 5 shrinks in its third step
        got = general_sweep.pass_plan(_trace(steps, reads), 13, 4).tolist()
        assert got == [[4 + 5, 4 + 5 + 1 + 4]]

    def test_ragged_group(self):
        steps = np.ones((1, 7, 3), dtype=np.int64)
        reads = np.ones((1, 7, 3), dtype=np.int64)
        reads[0, 6] = 3
        assert general_sweep.pass_plan(_trace(steps, reads), 5, 4).tolist() == [[2 + 3, 2 + 9]]

    def test_on_the_twins_trace(self):
        """The plan of a real Nelder-Mead: each problem's starts, reads and
        shrinks as the trace records them, its block the longest."""
        c = torch.as_tensor(np.random.RandomState(0).standard_normal((2, 6, 3)))
        trace = []
        def kinked(p):  # its inside contractions fail, so it shrinks
            return torch.sqrt(torch.abs(p - c[..., None, :])).sum(-1) + 0.2 * torch.sin(30 * p[..., 0])

        optimize.nelder_mead(kinked, torch.zeros(2, 6, 3, dtype=torch.float64), init_scale=0.25, iters=40, trace=trace)
        reads = sum(t["reads"] for t in trace)
        shrinks = sum((t["step"] == 4).long() for t in trace)
        per = 1 + reads + shrinks  # F 3: one pass starts 4 vertices, one a shrink's 3
        assert int(shrinks.sum()) > 0
        got = general_sweep.pass_plan(trace, 3, 2)
        assert torch.equal(got, per.reshape(2, 3, 2).amax(-1))
