"""Parity of the port's batched ToA fit (crimp_tpu_torch.ops.toafit /
optimize) with crimp_tpu on the CPU.

Tolerances: phShift within 1e-6 rad; the error bounds phShift_LL/UL within
one scan step 2*pi/phShiftRes (observed: the same step on every case below,
equal to rounding, <= 3e-17 rad);
redChi2 and norm within rtol 1e-6. Both packages fit in float64 with the
same algorithm, so the remaining gaps are reduction order (~1e-12).
"""

import numpy as np
import pytest
import torch

from crimp_tpu.io import template as jax_template_io
from crimp_tpu.models import profiles as jax_profiles
from crimp_tpu.ops import anchored as jax_anchored
from crimp_tpu.ops import optimize as jax_optimize
from crimp_tpu.ops import toafit as jax_toafit
from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.models import profiles
from crimp_tpu_torch.ops import general_sweep, optimize, toafit
from tests.conftest import PAR, TEMPLATE

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bundled_segments(event_times):
    """The bundled observation, every 3rd event, folded in 4 count-sliced
    segments of unequal size (1500 to 7500 events, padded batch)."""
    t = np.sort(event_times)[::3]
    segs = np.split(t, [1500, 9000, 16500])
    phases, _ = jax_anchored.fold_segments(PAR, segs)
    exposures = np.array([len(p) / 17.0 for p in phases])
    return phases, exposures


def _both(kind_tpl_port, kind_tpl_jax, phase_list, exposures, **cfg_kw):
    kind, tpl = kind_tpl_port
    _, jax_tpl = kind_tpl_jax
    phases, masks = toafit.pad_segments(phase_list)
    ref = jax_toafit.fit_toas_batch(kind, jax_tpl, phases, masks, exposures,
                                    jax_toafit.ToAFitConfig(kind=kind, **cfg_kw))
    got = toafit.fit_toas_batch(kind, tpl, phases, masks, exposures,
                                toafit.ToAFitConfig(kind=kind, **cfg_kw), device="cpu")
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in ref.items()})


def _assert_parity(got, ref, res):
    step = 2 * np.pi / res
    np.testing.assert_allclose(got["phShift"], ref["phShift"], rtol=0, atol=1e-6)
    for key in ("phShift_LL", "phShift_UL"):
        assert np.max(np.abs(got[key] - ref[key])) <= step * (1 + 1e-9)
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-12)  # observed gap
    np.testing.assert_allclose(got["redChi2"], ref["redChi2"], rtol=1e-6)
    np.testing.assert_allclose(got["norm"], ref["norm"], rtol=1e-6)
    np.testing.assert_allclose(got["ampShift"], ref["ampShift"], rtol=1e-6)
    np.testing.assert_allclose(got["logLmax"], ref["logLmax"], rtol=1e-10)
    np.testing.assert_array_equal(got["errScanLoopIters"], ref["errScanLoopIters"])
    np.testing.assert_allclose(got["theta_best"], ref["theta_best"], rtol=1e-6)


def _templates(path=TEMPLATE):
    return (profiles.from_template(template_io.read_template(path)),
            jax_profiles.from_template(jax_template_io.read_template(path)))


class TestFitBundled:
    def test_fourier_template(self, bundled_segments):
        phase_list, exposures = bundled_segments
        port, ref = _templates()
        got, want = _both(port, ref, phase_list, exposures, ph_shift_res=1000)
        _assert_parity(got, want, 1000)
        assert np.all(np.abs(got["phShift"]) < 0.5)

    def test_vary_amps(self, bundled_segments):
        phase_list, exposures = bundled_segments
        port, ref = _templates()
        got, want = _both(port, ref, phase_list[:2], exposures[:2], ph_shift_res=500, vary_amps=True)
        _assert_parity(got, want, 500)
        assert not np.allclose(got["ampShift"], 1.0)

    def test_fallback_loop_per_segment(self, bundled_segments):
        """Pure chunked error scan (no dense window): segments finish after
        different numbers of passes; each matches JAX's vmapped while_loop
        and a lone run of the same segment."""
        phase_list, exposures = bundled_segments
        port, ref = _templates()
        cfg = dict(ph_shift_res=1000, err_dense_window=0, err_chunk=2, refine_mode="grid")
        got, want = _both(port, ref, phase_list, exposures, **cfg)
        _assert_parity(got, want, 1000)
        assert len(set(got["errScanLoopIters"].tolist())) > 1
        p1, m1 = toafit.pad_segments(phase_list[1:2])
        lone = {k: v.numpy() for k, v in toafit.fit_toas_batch(
            port[0], port[1], p1, m1, exposures[1:2], toafit.ToAFitConfig(kind=port[0], **cfg),
            device="cpu").items()}
        assert lone["phShift_LL"][0] == got["phShift_LL"][1]
        assert lone["phShift_UL"][0] == got["phShift_UL"][1]
        assert lone["errScanLoopIters"][0] != got["errScanLoopIters"][0]
        assert lone["errScanLoopIters"][0] == got["errScanLoopIters"][1]
        assert abs(lone["phShift"][0] - got["phShift"][1]) < 1e-9


@pytest.mark.parametrize("kind", ["vonmises", "cauchy"])
def test_radian_families(kind):
    rng = np.random.RandomState(8)
    port_tpl = profiles.ProfileParams(
        norm=torch.tensor(2.0, dtype=torch.float64),
        amp=torch.tensor([1.5, 0.6], dtype=torch.float64),
        loc=torch.tensor([1.0, 3.5], dtype=torch.float64),
        wid=torch.tensor([0.35, 0.5], dtype=torch.float64),
        ph_shift=torch.tensor(0.0, dtype=torch.float64),
        amp_shift=torch.tensor(1.0, dtype=torch.float64),
    )
    jax_tpl = jax_profiles.ProfileParams(**{
        name: np.asarray(getattr(port_tpl, name)) for name in
        ("norm", "amp", "loc", "wid", "ph_shift", "amp_shift")})
    # rejection-sample radians from the shifted template
    grid = np.linspace(0, 2 * np.pi, 2001)
    shifted = port_tpl.replace(ph_shift=torch.tensor(0.3, dtype=torch.float64))
    pdf = profiles.curve(kind, shifted, torch.as_tensor(grid)).numpy()
    segs = []
    for n in (1500, 2200, 1800):
        x = rng.uniform(0, 2 * np.pi, 4 * n)
        keep = rng.uniform(0, pdf.max(), 4 * n) < np.interp(x, grid, pdf)
        segs.append(x[keep][:n])
    exposures = np.array([len(s) / 9.0 for s in segs])
    got, want = _both((kind, port_tpl), (kind, jax_tpl), segs, exposures,
                      ph_shift_res=400, amp_lo=1e-6, amp_hi=500.0)
    _assert_parity(got, want, 400)
    np.testing.assert_allclose(got["phShift"], 0.3, atol=0.2)


class TestOptimizers:
    def test_nelder_mead_batched_matches_jax(self):
        import jax.numpy as jnp

        centers = np.array([[1.0, -2.0, 0.5], [0.3, 0.1, -0.7], [-1.5, 2.5, 1.0]])

        def f(x, c):
            d0, d1, d2 = x[..., 0] - c[..., 0], x[..., 1] - c[..., 1], x[..., 2] - c[..., 2]
            return d0**2 + 3 * d1**2 + 2 * d2**2 + 0.5 * d0 * d1

        c_t = torch.as_tensor(centers)[:, None, :]
        got_x, got_f = optimize.nelder_mead(lambda x: f(x, c_t), torch.zeros(3, 3, dtype=torch.float64),
                                            init_scale=0.25, iters=120)
        for i, c in enumerate(centers):
            ref_x, ref_f = jax_optimize.nelder_mead(
                lambda x, c=c: f(x, jnp.asarray(c)), jnp.zeros(3), init_scale=0.25, iters=120)
            np.testing.assert_allclose(got_x[i].numpy(), np.asarray(ref_x), atol=1e-8)
            np.testing.assert_allclose(got_x[i].numpy(), c, atol=1e-6)
            assert float(got_f[i]) == pytest.approx(float(ref_f), abs=1e-14)

    def test_golden_section_and_transform(self):
        lo = np.array([0.0, -1.0, 2.0])
        hi = np.array([2.0, 1.5, 5.0])
        peak = np.array([0.7, 0.2, 4.1])
        got_x, got_f = optimize.golden_section(
            lambda x: -(x - torch.as_tensor(peak)) ** 2, torch.as_tensor(lo), torch.as_tensor(hi), iters=40)
        ref_x, ref_f = jax_optimize.golden_section(lambda x: -(x - peak) ** 2, lo, hi, iters=40)
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(ref_x))
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(ref_f))
        tf, tf_ref = optimize.bounded_transform(lo, hi), jax_optimize.bounded_transform(lo, hi)
        u = torch.tensor([-3.0, 0.0, 2.5], dtype=torch.float64)
        np.testing.assert_allclose(tf.to_bounded(u).numpy(), np.asarray(tf_ref.to_bounded(u.numpy())), rtol=1e-15)
        np.testing.assert_allclose(tf.to_unbounded(tf.to_bounded(u)).numpy(), u.numpy(), rtol=1e-9)


class TestHostHelpers:
    def test_spec_buckets_slices_pads(self):
        tpl = jax_template_io.read_template(TEMPLATE)
        for vary in (False, True):
            assert toafit.free_param_spec("fourier", tpl, vary) == jax_toafit.free_param_spec("fourier", tpl, vary)
        sizes = [10, 3000, 70, 64, 65, 1, 4096, 900]
        assert toafit.bucket_by_pow2(sizes) == jax_toafit.bucket_by_pow2(sizes)
        assert toafit.bucket_by_pow2([]) == []
        rng = np.random.RandomState(2)
        t = np.sort(rng.uniform(0, 10, 500))
        starts, ends = [0.5, 3.0, 9.9], [2.5, 3.0, 12.0]
        for got, want in zip(toafit.slice_sorted_intervals(t, starts, ends),
                             jax_toafit.slice_sorted_intervals(t, starts, ends)):
            np.testing.assert_array_equal(got, want)
        segs = [rng.uniform(size=n) for n in (3, 7, 5)]
        for got, want in zip(toafit.pad_segments(segs), jax_toafit.pad_segments(segs)):
            np.testing.assert_array_equal(got, want)


class TestReadVaryParam:
    @pytest.fixture(scope="class")
    def draws(self):
        (kind, tpl), (_, jax_tpl) = _templates()
        rng = np.random.RandomState(17)
        grid = np.linspace(0, 1, 1024)
        rate_of = lambda p: profiles.curve(kind, tpl, torch.as_tensor(p)).numpy()
        peak = rate_of(grid).max() * 1.05
        acc = np.empty(0)
        while acc.size < 1000:
            cand = rng.uniform(0, 1, 4000)
            acc = np.concatenate([acc, cand[rng.uniform(0, peak, 4000) < rate_of(cand)]])
        return kind, tpl, jax_tpl, np.stack([acc[:500], acc[500:1000]])

    def test_general_profile_matches_jax(self, draws):
        """Norm and the first two amplitudes refit per (segment, phase) by the
        batched bounded Nelder-Mead, cold and warm-started, against JAX's
        per-segment vmapped Nelder-Mead."""
        import jax.numpy as jnp

        kind, tpl, jax_tpl, x = draws
        mask = np.ones_like(x, dtype=bool)
        exposure = np.array([500.0 / float(tpl.norm)] * 2)
        phis = np.array([[-0.1, 0.05, 0.2], [0.0, 0.1, -0.2]])
        kw = dict(kind=kind, free_idx=(0, 1, 2), free_lo=(5.0, 0.1, 1.0), free_hi=(50.0, 5.0, 8.0),
                  nm_iters=40)
        cfg, jcfg = toafit.ToAFitConfig(**kw), jax_toafit.ToAFitConfig(**kw)
        warm = np.asarray(jax_toafit._flatten_tpl(jax_tpl)).copy()
        warm[:3] = [16.0, 1.3, 3.8]
        for i, w in ((0, None), (1, warm)):  # segment 0 cold, segment 1 warm-started
            ll, vecs = general_sweep.general_profile_reference(
                kind, tpl, torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(exposure),
                torch.as_tensor(phis), cfg, None if w is None else torch.as_tensor(np.stack([w, w])))
            ll_ref, vecs_ref = jax_toafit._general_profile_vecs(
                kind, jax_tpl, jnp.asarray(x[i]), jnp.asarray(mask[i]), exposure[i],
                jnp.asarray(phis[i]), jcfg, None if w is None else jnp.asarray(w))
            np.testing.assert_allclose(ll[i].numpy(), np.asarray(ll_ref), rtol=1e-12)
            np.testing.assert_allclose(vecs[i].numpy(), np.asarray(vecs_ref), rtol=1e-8, atol=1e-10)

    def test_full_fit_runs(self, draws):
        """The whole fit in readvaryparam mode (norm and two amplitudes free)
        recovers the template's phase, refits the shape, and reports the
        spec's dof; the committed template's spec frees 13 parameters as in
        crimp_tpu."""
        kind, tpl, _, x = draws
        tpl_dict = jax_template_io.read_template(TEMPLATE)
        spec = toafit.free_param_spec(kind, tpl_dict)
        assert spec == jax_toafit.free_param_spec(kind, tpl_dict) and len(spec[0]) == 13
        cfg = toafit.ToAFitConfig(kind=kind, ph_shift_res=40, n_brute=16, refine_iters=12, nm_iters=40,
                                  err_chunk=4, free_idx=(0, 1, 2), free_lo=(5.0, 0.1, 1.0),
                                  free_hi=(50.0, 5.0, 8.0), n_free=3)
        out = toafit.fit_toas_batch(kind, tpl, x.reshape(1, -1), np.ones((1, 1000), bool),
                                    [1000.0 / float(tpl.norm)], cfg, device="cpu")
        assert abs(float(out["phShift"][0])) < 0.3
        assert float(out["phShift_LL"][0]) > 0 and float(out["phShift_UL"][0]) > 0
        assert np.isfinite(float(out["redChi2"][0]))
        assert not torch.allclose(out["theta_best"][0, 1:3], tpl.amp[:2])
