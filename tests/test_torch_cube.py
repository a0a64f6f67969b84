"""Parity of the port's (nu, nudot, nuddot) search cube with crimp_tpu on the CPU.

The port's cube runs through K2's plain twin (crimp_tpu_torch.ops.z2_grid),
held against crimp_tpu's uniform-grid cube kernel on tests/test_search.py's
TestGrid3D fixture at TestPallasZ2's tolerances (rtol 2e-3 / atol 0.05,
identical argmax), with the polynomial and with f32 sin/cos. The bitwise
pins are the port's own, as the JAX package pins its own: a zero fddot row
is the 2-D grid, and threed_ztest at fddot 0 is twod_ztest. The CUDA kernel
is held against the twin on the card by tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from crimp_tpu.ops import search as jax_search
from crimp_tpu.pipelines.simulate import simulate_modulated_lc
from crimp_tpu_torch.ops import search, z2_grid

torch.set_num_threads(2)

RTOL, ATOL = 2e-3, 0.05


@pytest.fixture(scope="module")
def sim_events():
    rng = np.random.RandomState(42)
    sim = simulate_modulated_lc(freq=0.25, srcrate=5.0, exposure=20000, pulsedfraction=0.3,
                                bgrrate=0.1, rng=rng)
    return sim["assigned_t_wBgr"]


@pytest.fixture(scope="module")
def cube(sim_events):
    """TestGrid3D's cube: a 4x subsample over the +-1e4 s span, 97 freqs
    (ragged against a tile), fdot/fddot spacings that decohere off-center
    rows so the cube has one peak cell."""
    sec = sim_events[::4] - sim_events[::4].mean()
    freqs = np.linspace(0.2495, 0.2505, 97)
    return sec, freqs, np.array([-2e-7, 0.0, 2e-7]), np.array([-3e-11, 0.0, 3e-11])


class TestCubeAgainstJax:
    @pytest.mark.parametrize("poly", [True, False])
    def test_z2_cube_matches_jax_grid(self, cube, poly):
        sec, freqs, fdots, fddots = cube
        f0, df = freqs[0], float(freqs[1] - freqs[0])
        ref = np.asarray(jax_search.z2_power_3d_grid(sec, f0, df, len(freqs), fdots, fddots, 2,
                                                     poly=poly, mxu=False))
        got = search.z2_power_3d_grid(sec, f0, df, len(freqs), fdots, fddots, 2, poly=poly,
                                      device="cpu").numpy()
        assert got.shape == ref.shape == (3, 3, 97)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        assert int(np.argmax(got)) == int(np.argmax(ref))

    @pytest.mark.parametrize("poly", [None, True], ids=["default", "polynomial"])
    def test_h_cube_matches_jax_grid(self, cube, poly):
        """Each side's default trig, and the polynomial asked for on both sides."""
        sec, freqs, fdots, fddots = cube
        f0, df = freqs[0], float(freqs[1] - freqs[0])
        kw = {} if poly is None else {"poly": poly}
        ref = np.asarray(jax_search.h_power_3d_grid(sec, f0, df, len(freqs), fdots[1:],
                                                    fddots[1:], 5, mxu=False, **kw))
        got = search.h_power_3d_grid(sec, f0, df, len(freqs), fdots[1:], fddots[1:], 5,
                                     device="cpu", **kw).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        assert int(np.argmax(got)) == int(np.argmax(ref))


class TestCubePins:
    @pytest.mark.parametrize("poly", [True, False])
    def test_fddot_zero_bitmatches_2d_kernel(self, cube, poly):
        """A zero fddot row adds an exact 0.0f: the cube at fddots=[0.0] is
        the 2-D grid bit for bit (tests/test_search.py:800-812)."""
        sec, freqs, fdots, _ = cube
        f0, df = freqs[0], float(freqs[1] - freqs[0])
        c2, s2, _ = search.harmonic_sums_2d_grid(sec, f0, df, len(freqs), fdots, 3, device="cpu",
                                                 poly=poly)
        c3, s3 = search.harmonic_sums_3d_grid(sec, f0, df, len(freqs), fdots, [0.0], 3,
                                              device="cpu", poly=poly)
        assert torch.equal(c3[0], c2) and torch.equal(s3[0], s2)

    def test_twin_zero_row_and_unit_weights_are_the_plain_sums(self):
        rng = np.random.RandomState(8)
        t = torch.as_tensor(np.sort(rng.uniform(-3e3, 3e3, 2500)))
        hf = torch.tensor([-1e-10, 0.0], dtype=torch.float64)
        plain = z2_grid.z2_tile_sums(t, 0.25, 1e-5, hf, 2, 4)
        zero = torch.zeros(1, dtype=torch.float64)
        assert torch.equal(z2_grid.z2_tile_sums(t, 0.25, 1e-5, hf, 2, 4, sixth_fddots=zero)[:, 0], plain)
        ones = torch.ones(t.shape[0], dtype=torch.float32)
        assert torch.equal(z2_grid.z2_tile_sums(t, 0.25, 1e-5, hf, 2, 4, weights=ones), plain)

    def test_twin_split_plan_sums_ranges_in_order(self):
        rng = np.random.RandomState(9)
        t = torch.as_tensor(np.sort(rng.uniform(-3e3, 3e3, 5000)))
        hf = torch.tensor([0.0], dtype=torch.float64)
        parts = [z2_grid.z2_tile_sums(t[lo:lo + 2048], 0.25, 1e-5, hf, 1, 2) for lo in (0, 2048, 4096)]
        got = z2_grid.z2_tile_sums(t, 0.25, 1e-5, hf, 1, 2, per_split=2048)
        assert torch.equal(got, (parts[0] + parts[1]) + parts[2])
        with pytest.raises(ValueError, match="per_split"):
            z2_grid.z2_tile_sums(t, 0.25, 1e-5, hf, 1, 2, per_split=1000)


class TestThreedZtest:
    @pytest.mark.parametrize("poly_trig", [None, True], ids=["default", "polynomial"])
    def test_rows_order_and_values_match_jax(self, sim_events, poly_trig):
        """Row order (tests/test_search.py:892-911): outer fddot, then fdot,
        then freq; the fdot axis is log10 spin-down, the fddot axis signed.
        Each package's default trig on the CPU (hardware sin/cos), and the
        polynomial asked for explicitly."""
        freqs = np.linspace(0.2495, 0.2505, 65)
        log_fdots, fdd = np.array([-12.0, -11.0]), np.array([-1e-16, 1e-16])
        ref, ref_df = jax_search.PeriodSearch(sim_events[::4], freqs, 2, poly_trig=poly_trig).threed_ztest(
            log_fdots, fdd)
        rows, table = search.PeriodSearch(sim_events[::4], freqs, 2, poly_trig=poly_trig,
                                          device="cpu").threed_ztest(log_fdots, fdd)
        assert list(table) == list(ref_df.columns) == ["Freq", "Freq_dot", "Freq_ddot", "Z2pow"]
        assert rows.shape == ref.shape == (65 * 2 * 2, 4)
        np.testing.assert_array_equal(rows[:, :3], ref[:, :3])
        assert np.all(rows[: 65 * 2, 2] == fdd[0]) and np.all(rows[:65, 1] == log_fdots[0])
        np.testing.assert_allclose(rows[:, 3], ref[:, 3], rtol=RTOL, atol=ATOL)
        peak = rows[np.argmax(rows[:, 3])]
        assert peak[0] == pytest.approx(0.25, abs=5e-5)
        assert int(np.argmax(rows[:, 3])) == int(np.argmax(ref[:, 3]))

    def test_fddot_zero_matches_twod_bitwise(self, sim_events):
        """tests/test_search.py:913-930: one zero fddot row reproduces
        twod_ztest's power column exactly."""
        freqs = np.linspace(0.2495, 0.2505, 65)
        ps = search.PeriodSearch(sim_events[::4], freqs, 2, device="cpu")
        rows2, _ = ps.twod_ztest(np.array([-12.0, -11.0]))
        rows3, _ = ps.threed_ztest(np.array([-12.0, -11.0]), np.array([0.0]))
        np.testing.assert_array_equal(rows3[:, 3], rows2[:, 2])

    def test_nonuniform_cube_falls_through_to_general_kernel(self, sim_events):
        jagged = np.concatenate([np.linspace(0.2490, 0.2499, 20), np.linspace(0.2500, 0.2505, 21)])
        t = sim_events[::8]
        log_fdots, fdd = np.array([-12.0]), np.array([-1e-16, 0.0])
        ref, _ = jax_search.PeriodSearch(t, jagged, 2, poly_trig=False).threed_ztest(log_fdots, fdd)
        rows, _ = search.PeriodSearch(t, jagged, 2, poly_trig=False, device="cpu").threed_ztest(
            log_fdots, fdd)
        np.testing.assert_array_equal(rows[:, :3], ref[:, :3])
        np.testing.assert_allclose(rows[:, 3], ref[:, 3], rtol=1e-4, atol=5e-3)
