"""The port's factorized (matmul) uniform grids against the exact grids.

tests/test_search.py::TestGridMXU's budget: the factorized statistic stays
within 1% of the statistic's own noise scale, sqrt(4*nharm), of the exact
grid, with an identical argmax; bf16 operands keep the argmax and stay
within 2% of the peak. The port's factorized path is held against the
port's exact grid (K2's twin) and against crimp_tpu's exact grid, and its
sweep matrices against crimp_tpu's.
"""

import numpy as np
import pytest
import torch

from crimp_tpu.ops import search as jax_search
from crimp_tpu.pipelines.simulate import simulate_modulated_lc
from crimp_tpu_torch.ops import search

torch.set_num_threads(2)


def budget(nharm):
    return 0.01 * np.sqrt(4.0 * nharm)


@pytest.fixture(scope="module")
def sec():
    rng = np.random.RandomState(42)
    sim = simulate_modulated_lc(freq=0.25, srcrate=5.0, exposure=20000, pulsedfraction=0.3,
                                bgrrate=0.1, rng=rng)
    t = sim["assigned_t_wBgr"][::4]
    return t - t.mean()


class TestFactorizedBudget:
    @pytest.mark.parametrize("poly", [True, False])
    def test_1d_parity(self, sec, poly):
        freqs = np.linspace(0.2495, 0.2505, 733)
        f0, df = freqs[0], float(freqs[1] - freqs[0])
        exact = search.z2_power_grid(sec, f0, df, len(freqs), 3, device="cpu", poly=poly).numpy()
        fact = search.z2_power_grid(sec, f0, df, len(freqs), 3, device="cpu", poly=poly, mxu=True,
                                    reseed=64).numpy()
        ref = np.asarray(jax_search.z2_power_grid(sec, f0, df, len(freqs), 3, poly=poly, mxu=False))
        for other in (exact, ref):
            assert np.max(np.abs(fact - other)) < budget(3)
            assert int(np.argmax(fact)) == int(np.argmax(other))

    def test_h_parity(self, sec):
        freqs = np.linspace(0.2495, 0.2505, 128)
        f0, df = freqs[0], float(freqs[1] - freqs[0])
        exact = search.h_power_grid(sec, f0, df, len(freqs), 5, device="cpu").numpy()
        fact = search.h_power_grid(sec, f0, df, len(freqs), 5, device="cpu", mxu=True).numpy()
        assert np.max(np.abs(fact - exact)) < budget(5)
        assert int(np.argmax(fact)) == int(np.argmax(exact))

    def test_2d_weighted_ragged_tiles(self, sec):
        w = np.random.RandomState(23).uniform(0.5, 1.5, sec.shape[0])
        fdots = np.array([-1e-11, 0.0, 1e-11])
        c_e, s_e = search.harmonic_sums_2d_grid(sec, 0.2496, 1e-6, 97, fdots, 3, device="cpu",
                                                weights=w)[:2]
        c_f, s_f = search.harmonic_sums_uniform_2d_mxu(sec, 0.2496, 1e-6, 97, fdots, 3, trial_block=64,
                                                       event_block=1024, weights=w, device="cpu")
        z_e = torch.sum(search.z2_from_sums(c_e, s_e, sec.shape[0]), dim=1).numpy()
        z_f = torch.sum(search.z2_from_sums(c_f, s_f, sec.shape[0]), dim=1).numpy()
        assert np.max(np.abs(z_f - z_e)) < budget(3)
        assert int(np.argmax(z_f)) == int(np.argmax(z_e))

    def test_3d_parity_and_weights(self, sec):
        freqs = np.linspace(0.2495, 0.2505, 97)
        f0, df = freqs[0], float(freqs[1] - freqs[0])
        fdots, fddots = np.array([-2e-7, 0.0, 2e-7]), np.array([-3e-11, 0.0, 3e-11])
        w = np.random.RandomState(29).uniform(0.5, 1.5, sec.shape[0])
        for weights in (None, w):
            exact = search.z2_power_3d_grid(sec, f0, df, 97, fdots, fddots, 2, device="cpu",
                                            weights=weights).numpy()
            fact = search.z2_power_3d_grid(sec, f0, df, 97, fdots, fddots, 2, device="cpu",
                                           weights=weights, mxu=True).numpy()
            assert np.max(np.abs(fact - exact)) < budget(2)
            assert int(np.argmax(fact)) == int(np.argmax(exact))

    def test_reseed_stride_drift_bound(self, sec):
        freqs = np.linspace(0.2495, 0.2505, 512)
        f0, df = freqs[0], float(freqs[1] - freqs[0])
        exact = search.z2_power_grid(sec, f0, df, 512, 2, device="cpu").numpy()
        for reseed in (1, 64, 256):
            fact = search.z2_power_grid(sec, f0, df, 512, 2, device="cpu", mxu=True,
                                        reseed=reseed).numpy()
            assert np.max(np.abs(fact - exact)) < budget(2), reseed

    def test_bf16_composes(self, sec):
        freqs = np.linspace(0.2495, 0.2505, 256)
        f0, df = freqs[0], float(freqs[1] - freqs[0])
        f32 = search.z2_power_grid(sec, f0, df, 256, 2, device="cpu", mxu=True).numpy()
        b16 = search.z2_power_grid(sec, f0, df, 256, 2, device="cpu", mxu=True, mxu_bf16=True).numpy()
        assert int(np.argmax(b16)) == int(np.argmax(f32))
        assert np.max(np.abs(b16 - f32)) < 0.02 * np.max(f32)
        assert not np.array_equal(b16, f32)


    def test_default_reseed_at_high_signal_to_noise(self):
        """A strong pulse (Z^2 ~ 3e4): with the polynomial pair the rotation's
        amplitude error is coherent, so the default stride of 64 (the JAX
        package's) drifts well past the exact grid's own f32 error against
        the f64-trig statistic, and the optional stride of 16 stays within it."""
        rng = np.random.RandomState(1)
        t = np.sort(rng.uniform(-2e7, 2e7, 200000))
        t = t[rng.uniform(0, 1, t.size) < 0.5 * (1 + 0.9 * np.cos(2 * np.pi * 0.1432825 * t))][:70000]
        t = t - (t[0] + t[-1]) / 2
        freqs = np.linspace(0.1432820, 0.1432830, 256)
        f0, df = search.uniform_grid(freqs)
        truth = search.z2_power(t, freqs, 2, trig_dtype=torch.float64, device="cpu").numpy()
        exact = np.max(np.abs(search.z2_power_grid(t, f0, df, 256, 2, device="cpu",
                                                   poly=True).numpy() - truth))
        dev = {rs: np.max(np.abs(search.z2_power_grid(t, f0, df, 256, 2, device="cpu", poly=True,
                                                       mxu=True, reseed=rs).numpy() - truth))
               for rs in (search.GRID_MXU_RESEED, 16)}
        assert search.GRID_MXU_RESEED == 64
        assert truth.max() > 2e4
        assert dev[16] <= max(exact, budget(2))
        assert dev[search.GRID_MXU_RESEED] > 2 * dev[16]


class TestDefaultArguments:
    """The factorized grids at their default arguments (no ``reseed=``) in
    both packages, at test_1d_parity's budget and argmax check, with each
    side's default trig and with the polynomial pair on both sides; the
    port's default is its reseed=64 call bit for bit, and 64 is what
    crimp_tpu resolves with no tuner cache."""

    TRIG = pytest.mark.parametrize("poly", [None, True], ids=["default", "polynomial"])

    @staticmethod
    def check(port_fn, jax_fn, nharm):
        from crimp_tpu.ops import autotune

        got = port_fn().numpy()
        ref = np.asarray(jax_fn())
        assert np.max(np.abs(got - ref)) < budget(nharm)
        assert int(np.argmax(got)) == int(np.argmax(ref))
        np.testing.assert_array_equal(got, port_fn(reseed=64).numpy())
        assert autotune.grid_mxu_defaults()["reseed"] == search.GRID_MXU_RESEED

    @TRIG
    def test_1d(self, sec, poly):
        freqs = np.linspace(0.2495, 0.2505, 733)
        f0, df = freqs[0], float(freqs[1] - freqs[0])
        kw = {} if poly is None else {"poly": poly}
        self.check(lambda **r: search.z2_power_grid(sec, f0, df, len(freqs), 3, device="cpu", mxu=True,
                                                    **kw, **r),
                   lambda: jax_search.z2_power_grid(sec, f0, df, len(freqs), 3, mxu=True, **kw), 3)

    @TRIG
    def test_2d(self, sec, poly):
        fdots = np.array([-1e-11, 0.0, 1e-11])
        kw = {} if poly is None else {"poly": poly}
        self.check(lambda **r: search.z2_power_2d_grid(sec, 0.2496, 1e-6, 301, fdots, 3, device="cpu",
                                                       mxu=True, **kw, **r),
                   lambda: jax_search.z2_power_2d_grid(sec, 0.2496, 1e-6, 301, fdots, 3, mxu=True, **kw), 3)

    @TRIG
    def test_3d(self, sec, poly):
        fdots, fddots = np.array([-2e-7, 0.0, 2e-7]), np.array([-3e-11, 0.0, 3e-11])
        kw = {} if poly is None else {"poly": poly}
        self.check(lambda **r: search.z2_power_3d_grid(sec, 0.2495, 1e-5, 97, fdots, fddots, 2,
                                                       device="cpu", mxu=True, **kw, **r),
                   lambda: jax_search.z2_power_3d_grid(sec, 0.2495, 1e-5, 97, fdots, fddots, 2,
                                                       mxu=True, **kw), 2)


class TestFactorizedPieces:
    @pytest.mark.parametrize("poly,atol", [(True, 2e-6), (False, 1e-5)])
    def test_sweep_matrices_match_jax(self, poly, atol):
        """f32 sin/cos of XLA and of torch differ by a few ulps, which the
        rotation carries through up to `reseed` steps; the polynomial is the
        same arithmetic in both."""
        b = np.random.RandomState(4).uniform(-0.5, 0.5, 300).astype(np.float32)
        for reseed in (1, 16, 64):
            ref = [np.asarray(v) for v in jax_search._sweep_matrices(b, 64, reseed, poly)]
            got = search._sweep_matrices(torch.as_tensor(b), 64, reseed, poly)
            for g, r in zip(got, ref):
                assert g.shape == (64, 300)
                np.testing.assert_allclose(g.numpy(), r, atol=atol)

    def test_full_f32_matmul_is_pinned_and_restored(self):
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("medium")
        try:
            with search._full_f32_matmul():
                assert torch.get_float32_matmul_precision() == "highest"
            assert torch.get_float32_matmul_precision() == "medium"
        finally:
            torch.set_float32_matmul_precision(prev)

    def test_bf16_dot_keeps_an_f32_result(self):
        rng = np.random.RandomState(6)
        a = torch.as_tensor(rng.normal(size=(5, 64)).astype(np.float32))
        b = torch.as_tensor(rng.normal(size=(7, 64)).astype(np.float32))
        got = search._mxu_dot(a, b, True)
        assert got.dtype == torch.float32
        exact = a.to(torch.bfloat16).double() @ b.to(torch.bfloat16).double().T
        np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-5, atol=1e-5)
