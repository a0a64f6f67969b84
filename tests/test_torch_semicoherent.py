"""Parity of the port's semi-coherent stack (crimp_tpu_torch.ops.semicoherent)
with crimp_tpu on the CPU.

Against crimp_tpu at tests/test_semicoherent.py's reduction-order figure,
rtol 1e-4 / atol 1e-3, with identical argmax. The port meets the JAX
package's own pins against itself: the incoherent stack is bitwise a
hand-written per-segment loop over the same padded rows, and one segment
collapses both stack modes onto the monolithic cube.
"""

import numpy as np
import pytest
import torch

from crimp_tpu.ops import search as jax_search
from crimp_tpu.ops import semicoherent as jax_semi
from crimp_tpu.pipelines.simulate import simulate_modulated_lc
from crimp_tpu_torch.ops import search, semicoherent as semi

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-3
CUBE = dict(f0=0.2496, df=1e-5, n_freq=97, fdots=np.array([-2e-8, 0.0, 2e-8]),
            fddots=np.array([-5e-12, 0.0, 5e-12]))


@pytest.fixture(scope="module")
def pulsed_events():
    """tests/test_semicoherent.py's steady pulsed source (16 ks, 0.25 Hz)."""
    rng = np.random.RandomState(11)
    sim = simulate_modulated_lc(freq=0.25, srcrate=1.5, exposure=16000, pulsedfraction=0.4,
                                bgrrate=0.1, rng=rng)
    t = np.asarray(sim["assigned_t_wBgr"], dtype=np.float64)
    return t - t[0]


class TestSplitSegments:
    def test_matches_jax(self, pulsed_events):
        for n_seg in (1, 4, 5):
            got, ref = semi.split_segments(pulsed_events, n_seg), jax_semi.split_segments(pulsed_events, n_seg)
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_array_equal(got[1], ref[1])

    def test_equal_duration_and_validation(self):
        t = np.concatenate([np.linspace(0.0, 10.0, 90), np.linspace(90.0, 100.0, 10)])
        assert list(semi.split_segments(t, 4)[1].sum(axis=1)) == [90, 0, 0, 10]
        with pytest.raises(ValueError, match="n_segments"):
            semi.split_segments(np.arange(5.0), 0)
        with pytest.raises(ValueError, match="non-empty"):
            semi.split_segments(np.empty(0), 2)
        with pytest.raises(ValueError, match="sorted"):
            semi.split_segments(np.array([3.0, 1.0, 2.0]), 2)


class TestStack:
    @pytest.mark.parametrize("stack", ["incoherent", "coherent"])
    def test_matches_jax(self, pulsed_events, stack):
        ref = np.asarray(jax_semi.semicoherent_z2_grid(pulsed_events, stack=stack, n_segments=4,
                                                       nharm=2, poly=False, mxu=False, **CUBE))
        got = semi.semicoherent_z2_grid(pulsed_events, stack=stack, n_segments=4, nharm=2, poly=False,
                                        device="cpu", **CUBE).numpy()
        assert got.shape == ref.shape == (3, 3, 97)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        assert int(np.argmax(got)) == int(np.argmax(ref))

    def test_incoherent_bitmatches_hand_loop(self, pulsed_events):
        seg_t, seg_w = semi.split_segments(pulsed_events, 4)
        expected = None
        for i in range(seg_t.shape[0]):
            c, s = search.harmonic_sums_3d_grid(seg_t[i], CUBE["f0"], CUBE["df"], CUBE["n_freq"],
                                                CUBE["fdots"], CUBE["fddots"], 2, device="cpu",
                                                weights=seg_w[i])
            term = torch.sum(search.z2_from_sums(c, s, max(float(seg_w[i].sum()), 1.0)), dim=2)
            expected = term if expected is None else expected + term
        got = semi.semicoherent_z2_grid(pulsed_events, n_segments=4, nharm=2, device="cpu", **CUBE)
        assert torch.equal(got, expected)

    def test_single_segment_collapses_to_coherent(self, pulsed_events):
        inco = semi.semicoherent_z2_grid(pulsed_events, stack="incoherent", n_segments=1, nharm=2,
                                         device="cpu", **CUBE)
        cohe = semi.semicoherent_z2_grid(pulsed_events, stack="coherent", n_segments=1, nharm=2,
                                         device="cpu", **CUBE)
        assert torch.equal(inco, cohe)
        mono = search.z2_power_3d_grid(pulsed_events, CUBE["f0"], CUBE["df"], CUBE["n_freq"],
                                       CUBE["fdots"], CUBE["fddots"], 2, device="cpu")
        np.testing.assert_allclose(inco.numpy(), mono.numpy(), rtol=1e-12, atol=1e-9)

    def test_factorized_stack_within_budget(self, pulsed_events):
        exact = semi.semicoherent_z2_grid(pulsed_events, n_segments=4, nharm=2, device="cpu",
                                          **CUBE).numpy()
        fact = semi.semicoherent_z2_grid(pulsed_events, n_segments=4, nharm=2, device="cpu", mxu=True,
                                         **CUBE).numpy()
        assert np.max(np.abs(fact - exact)) < 4 * 0.01 * np.sqrt(4.0 * 2)
        assert int(np.argmax(fact)) == int(np.argmax(exact))

    def test_refusals(self, pulsed_events):
        with pytest.raises(ValueError, match="stack"):
            semi.semicoherent_z2_grid(pulsed_events, stack="hough", n_segments=2, device="cpu", **CUBE)
        # a mesh is taken now (parallel.mesh); the stack twin takes only a 1-D segment mesh
        from crimp_tpu_torch.parallel import mesh as pmesh

        with pytest.raises(ValueError, match="segment mesh"):
            semi.semicoherent_z2_grid(pulsed_events, n_segments=2, mesh=pmesh.build_mesh(["cpu"] * 2),
                                      device="cpu", **CUBE)


class TestStackedPowerFromPhases:
    @pytest.mark.parametrize("statistic,stack,nharm", [("z2", "incoherent", 2), ("z2", "coherent", 3),
                                                       ("h", "incoherent", 5), ("h", "coherent", 5)])
    def test_matches_jax(self, statistic, stack, nharm):
        rng = np.random.RandomState(3)
        segs = [np.clip(rng.normal(0.5, 0.1, n), 0, 1) for n in (400, 300, 500)] + [np.empty(0)]
        got = semi.stacked_power_from_phases(segs, nharm, statistic, stack, device="cpu")
        ref = float(jax_semi.stacked_power_from_phases(segs, nharm, statistic, stack))
        assert got == pytest.approx(ref, rel=1e-5)

    def test_validation(self):
        with pytest.raises(ValueError, match="statistic"):
            semi.stacked_power_from_phases([np.ones(4)], statistic="q", device="cpu")
        with pytest.raises(ValueError, match="non-empty"):
            semi.stacked_power_from_phases([np.empty(0)], device="cpu")


FOLD_TM = {"PEPOCH": 58359.55765869704, "F0": 0.14328254547263483, "F1": -9.746993965547238e-15}


class TestSegmentHFromModel:
    def test_matches_jax_with_empty_segment(self):
        rng = np.random.RandomState(9)
        segs = [np.sort(58320.0 + 40.0 * i + rng.uniform(0.0, 30.0, 500)) for i in range(3)]
        segs.insert(1, np.empty(0))
        got = semi.segment_h_from_model(FOLD_TM, segs, nharm=5, device="cpu")
        ref = jax_semi.segment_h_from_model(FOLD_TM, segs, nharm=5, delta_fold=0)
        assert got.shape == (4,) and got[1] == 0.0
        np.testing.assert_allclose(got, ref, rtol=1e-4)
        chunked = semi.segment_h_from_model(FOLD_TM, segs, nharm=5, row_block=2, device="cpu")
        np.testing.assert_array_equal(chunked, got)


class TestPeriodSearchSemicoherent:
    def test_rows_and_peak_match_jax(self, pulsed_events):
        freqs = np.linspace(0.2496, 0.2504, 65)
        ref, ref_df = jax_search.PeriodSearch(pulsed_events, freqs, 2, poly_trig=True).semicoherent_ztest(
            np.array([-12.0]), np.array([0.0]), n_segments=4)
        rows, table = search.PeriodSearch(pulsed_events, freqs, 2, device="cpu").semicoherent_ztest(
            np.array([-12.0]), np.array([0.0]), n_segments=4)
        assert list(table) == list(ref_df.columns) and rows.shape == (65, 4)
        np.testing.assert_array_equal(rows[:, :3], ref[:, :3])
        np.testing.assert_allclose(rows[:, 3], ref[:, 3], rtol=RTOL, atol=ATOL)
        assert rows[np.argmax(rows[:, 3]), 0] == pytest.approx(0.25, abs=5e-5)

    def test_non_uniform_grid_refused(self, pulsed_events):
        freqs = np.concatenate([np.linspace(0.24, 0.25, 32), np.linspace(0.26, 0.30, 33)])
        with pytest.raises(ValueError, match="uniform"):
            search.PeriodSearch(pulsed_events, freqs, 2, device="cpu").semicoherent_ztest(
                np.array([-12.0]), np.array([0.0]), n_segments=4)
