"""Parity of the port's Z^2 search path (crimp_tpu_torch.ops.search / z2_grid)
with crimp_tpu on the CPU.

Each parity case runs twice: with each side's default trig (hardware sin/cos
on the CPU, as crimp_tpu's default there), and with the polynomial asked for
on both sides. In the polynomial case the port's K2 twin is held against the
Pallas tile kernel in interpret mode and against the XLA uniform-grid fast
path with polynomial trig, on the three TestPallasZ2 shapes at its
tolerances (rtol 2e-3 / atol 0.05, and rtol 5e-3 / atol 0.1 for the
multi-chunk shape) with identical argmax.
The CUDA kernel itself is held against the twin on the card by
tests/test_torch_gpu.py and by chip_smoke.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from crimp_tpu.ops import fasttrig as jax_fasttrig
from crimp_tpu.ops import search as jax_search
from crimp_tpu.ops.pallas_z2 import z2_power_2d_grid_pallas, z2_power_grid_pallas
from crimp_tpu.pipelines.simulate import simulate_modulated_lc
from crimp_tpu_torch.ops import fasttrig, search, z2_grid

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sim_events():
    """tests/test_search.py's pulsed light curve (seed 42, f = 0.25 Hz)."""
    rng = np.random.RandomState(42)
    sim = simulate_modulated_lc(
        freq=0.25, srcrate=5.0, exposure=20000, pulsedfraction=0.3, bgrrate=0.1, rng=rng
    )
    return sim["assigned_t_wBgr"]


TRIG = pytest.mark.parametrize("poly", [None, True], ids=["default", "polynomial"])


def _kw(poly):
    """Each side's default trig for None, the polynomial for True."""
    return {} if poly is None else {"poly": poly}


def _port_2d(sec, f0, df, n_freq, fdots, nharm, poly):
    return search.z2_power_2d_grid(sec, f0, df, n_freq, fdots, nharm, device="cpu",
                                   **_kw(poly)).numpy()


class TestTwinAgainstPallas:
    @TRIG
    def test_one_dim_tail_not_tile_multiple(self, sim_events, poly):
        sec = sim_events - sim_events.mean()
        n_freq = 300
        f0, df = search.uniform_grid(np.linspace(0.2495, 0.2505, n_freq))
        xla = np.asarray(jax_search.z2_power_grid(sec, f0, df, n_freq, 2, **_kw(poly)))
        got = search.z2_power_grid(sec, f0, df, n_freq, 2, device="cpu", **_kw(poly)).numpy()
        assert got.shape == (n_freq,)
        np.testing.assert_allclose(got, xla, rtol=2e-3, atol=0.05)
        assert int(np.argmax(got)) == int(np.argmax(xla))
        if poly:
            pallas = np.asarray(z2_power_grid_pallas(sec, f0, df, n_freq, 2, interpret=True))
            np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=0.05)
            assert int(np.argmax(got)) == int(np.argmax(pallas))

    @TRIG
    def test_two_dim_grid(self, sim_events, poly):
        sec = (sim_events - sim_events.mean())[:4096]
        n_freq = 280
        fdots = np.array([-1e-10, 0.0, 1e-10])
        f0, df = search.uniform_grid(np.linspace(0.2495, 0.2505, n_freq))
        xla = np.asarray(jax_search.z2_power_2d_grid(sec, f0, df, n_freq, fdots, 2, **_kw(poly)))
        got = _port_2d(sec, f0, df, n_freq, fdots, 2, poly)
        assert got.shape == (3, n_freq)
        np.testing.assert_allclose(got, xla, rtol=2e-3, atol=0.05)
        for row in range(3):
            assert int(np.argmax(got[row])) == int(np.argmax(xla[row]))
        if poly:
            pallas = np.asarray(z2_power_2d_grid_pallas(sec, f0, df, n_freq, fdots, 2,
                                                        interpret=True))
            np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=0.05)
            for row in range(3):
                assert int(np.argmax(got[row])) == int(np.argmax(pallas[row]))
        assert not np.allclose(got[0], got[1])

    @TRIG
    def test_multi_tile(self, sim_events, poly):
        sec = (sim_events - sim_events.mean())[:4096]
        n_freq = 1100
        f0, df = search.uniform_grid(np.linspace(0.24, 0.26, n_freq))
        xla = np.asarray(jax_search.z2_power_grid(sec, f0, df, n_freq, 3, **_kw(poly)))
        got = search.z2_power_grid(sec, f0, df, n_freq, 3, device="cpu", **_kw(poly)).numpy()
        np.testing.assert_allclose(got, xla, rtol=5e-3, atol=0.1)
        assert int(np.argmax(got)) == int(np.argmax(xla))
        if poly:
            pallas = np.asarray(z2_power_grid_pallas(
                sec, f0, df, n_freq, 3, trial_tile=256, event_chunk=512, tile_chunk=2,
                interpret=True))
            np.testing.assert_allclose(got, pallas, rtol=5e-3, atol=0.1)

    @TRIG
    @pytest.mark.parametrize("nharm", [5, 20])
    def test_high_harmonics_against_xla(self, sim_events, nharm, poly):
        sec = (sim_events - sim_events.mean())[:2048]
        n_freq = 300
        f0, df = search.uniform_grid(np.linspace(0.2495, 0.2505, n_freq))
        xla = np.asarray(jax_search.z2_power_2d_grid(sec, f0, df, n_freq, [-1e-10], nharm,
                                                     **_kw(poly)))
        got = _port_2d(sec, f0, df, n_freq, [-1e-10], nharm, poly)
        np.testing.assert_allclose(got, xla, rtol=2e-3, atol=0.05)
        assert int(np.argmax(got)) == int(np.argmax(xla))

    @TRIG
    def test_h_power_grid_against_xla(self, sim_events, poly):
        sec = (sim_events - sim_events.mean())[:4096]
        n_freq = 280
        f0, df = search.uniform_grid(np.linspace(0.2495, 0.2505, n_freq))
        xla = np.asarray(jax_search.h_power_grid(sec, f0, df, n_freq, 5, **_kw(poly)))
        got = search.h_power_grid(sec, f0, df, n_freq, 5, device="cpu", **_kw(poly)).numpy()
        np.testing.assert_allclose(got, xla, rtol=2e-3, atol=0.05)


class TestPeriodSearch:
    """Each side's default trig, and the polynomial asked for on both sides."""

    @pytest.mark.parametrize("poly_trig", [None, True], ids=["default", "polynomial"])
    def test_twod_ztest_rows_and_order(self, sim_events, poly_trig):
        t = np.sort(sim_events)[:3000]
        freqs = np.linspace(0.2495, 0.2505, 260)
        log_fdots = np.array([-11.0, -10.5, -10.0])
        ref_rows, ref_df = jax_search.PeriodSearch(t, freqs, 2, poly_trig=poly_trig).twod_ztest(log_fdots)
        rows, table = search.PeriodSearch(t, freqs, 2, poly_trig=poly_trig,
                                          device="cpu").twod_ztest(log_fdots)
        assert rows.shape == ref_rows.shape == (3 * 260, 3)
        np.testing.assert_array_equal(rows[:, :2], ref_rows[:, :2])
        np.testing.assert_allclose(rows[:, 2], ref_rows[:, 2], rtol=2e-3, atol=0.05)
        assert int(np.argmax(rows[:, 2])) == int(np.argmax(ref_rows[:, 2]))
        assert list(table) == list(ref_df.columns)
        np.testing.assert_array_equal(table["Freq"], ref_df["Freq"].to_numpy())

    @pytest.mark.parametrize("poly_trig", [None, True], ids=["default", "polynomial"])
    def test_ztest_and_htest_match(self, sim_events, poly_trig):
        t = np.sort(sim_events)[:3000]
        freqs = np.linspace(0.2495, 0.2505, 300)
        z_ref = jax_search.PeriodSearch(t, freqs, 2, poly_trig=poly_trig).ztest()
        h_ref = jax_search.PeriodSearch(t, freqs, 4, poly_trig=poly_trig).htest()
        np.testing.assert_allclose(
            search.PeriodSearch(t, freqs, 2, poly_trig=poly_trig, device="cpu").ztest(), z_ref,
            rtol=2e-3, atol=0.05)
        np.testing.assert_allclose(
            search.PeriodSearch(t, freqs, 4, poly_trig=poly_trig, device="cpu").htest(), h_ref,
            rtol=2e-3, atol=0.05)

    def test_unported_paths_raise(self):
        """Slice 1 raised NotImplementedError for these; they now run through
        the general kernel's twin and match crimp_tpu."""
        t = np.linspace(0.0, 1000.0, 64)
        jagged = np.array([0.1, 0.2, 0.35, 0.4])
        np.testing.assert_allclose(
            search.PeriodSearch(t, jagged, 2, poly_trig=False, device="cpu").ztest(),
            jax_search.PeriodSearch(t, jagged, 2, poly_trig=False).ztest(), rtol=1e-4, atol=5e-3)
        freqs = np.linspace(0.1, 0.2, 10)
        np.testing.assert_allclose(
            search.PeriodSearch(t, freqs, 21, poly_trig=False, device="cpu").htest(),
            jax_search.PeriodSearch(t, freqs, 21, poly_trig=False).htest(), rtol=1e-4, atol=5e-3)


class TestHPowerSegments:
    def test_matches_jax(self):
        rng = np.random.RandomState(17)
        sizes = [1200, 800, 1500]
        freqs = np.array([0.1432, 0.2791, 0.1433])
        n_max = max(sizes)
        sec = np.zeros((3, n_max))
        msk = np.zeros((3, n_max), dtype=bool)
        for i, (n, f) in enumerate(zip(sizes, freqs)):
            t = np.sort(rng.uniform(0, 30000, n))
            t = t + 0.3 * np.cos(2 * np.pi * f * t) / (2 * np.pi * f)  # pulsed
            sec[i, :n] = t - (t[0] + t[-1]) / 2
            msk[i, :n] = True
        ref = np.asarray(jax_search.h_power_segments(sec, msk, freqs, nharm=5))
        got = search.h_power_segments(sec, msk, freqs, nharm=5, device="cpu").numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4)


class TestTwinContract:
    def test_fasttrig_matches_jax_and_cuda_literals(self):
        assert fasttrig._SIN_COEFFS == jax_fasttrig._SIN_COEFFS
        assert fasttrig._COS_COEFFS == jax_fasttrig._COS_COEFFS
        src = pathlib.Path(z2_grid.SOURCE).read_text()
        body = src[src.index("sincos_poly(float x"):src.index("__global__ void probe_kernel")]
        lits = [float(v) for v in re.findall(r"(-?\d+\.\d+e[+-]?\d+)f", body)]
        assert sorted(lits) == sorted(fasttrig._SIN_COEFFS + fasttrig._COS_COEFFS)

    def test_centered_frac_matches_jax(self):
        rng = np.random.RandomState(3)
        x = np.concatenate([rng.uniform(-1e6, 1e6, 1000), [-0.5, 0.5, -1e-17, 2.5, 1215782.499995642]])
        ref = np.asarray(jax_fasttrig.centered_frac(x))
        got = fasttrig.centered_frac(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, ref)
        s_ref, c_ref = (np.asarray(v) for v in jax_fasttrig.sincos_cycles(ref.astype(np.float32)))
        s, c = (v.numpy() for v in fasttrig.sincos_cycles(torch.as_tensor(got, dtype=torch.float32)))
        np.testing.assert_allclose(s, s_ref, atol=2e-7)
        np.testing.assert_allclose(c, c_ref, atol=2e-7)

    def test_cpu_tensor_takes_twin_without_counting(self):
        z2_grid.reset_launches()
        t = torch.linspace(-500.0, 500.0, 3000, dtype=torch.float64)
        hf = torch.tensor([0.0, -5e-11], dtype=torch.float64)
        got = z2_grid.z2_tile_sums(t, 0.25, 1e-5, hf, 2, 3)
        ref = z2_grid.z2_tile_sums_reference(t, 0.25, 1e-5, hf, 2, 3)
        assert torch.equal(got, ref)
        assert got.shape == (2, 2, 2, 3, z2_grid.TRIAL_TILE)
        x = torch.arange(1024, dtype=torch.float32).reshape(8, 128)
        assert float(z2_grid.probe(x)) == 524800.0
        assert z2_grid.LAUNCHES == {"probe": 0, "z2_tile_sums": 0}

    def test_twin_padding_adds_nothing(self):
        """The tail chunk's weight-0 padding leaves the sums of the real
        events as they are, up to the f32 order of the chunk sums."""
        rng = np.random.RandomState(5)
        t = torch.as_tensor(np.sort(rng.uniform(-1e4, 1e4, 1500)))
        hf = torch.zeros(1, dtype=torch.float64)
        a = z2_grid.z2_tile_sums_reference(t, 0.2, 1e-6, hf, 1, 2, event_chunk=1500)
        b = z2_grid.z2_tile_sums_reference(t, 0.2, 1e-6, hf, 1, 2, event_chunk=2048)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-4)

    def test_wrapper_validates_inputs(self):
        t = torch.zeros(10, dtype=torch.float64)
        hf = torch.zeros(1, dtype=torch.float64)
        with pytest.raises(ValueError):
            z2_grid.z2_tile_sums(t.float(), 0.1, 1e-6, hf, 1, 2)
        with pytest.raises(ValueError):
            z2_grid.z2_tile_sums(t, 0.1, 1e-6, hf, 1, 21)
        with pytest.raises(ValueError):
            z2_grid.probe(torch.zeros(4, 4))
