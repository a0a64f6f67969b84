"""Parity of the port's anchored fold (crimp_tpu_torch.ops.anchored) with
crimp_tpu (within 1e-9 cycles) and with the straight-formula longdouble
oracle of tests/conftest.py at tests/test_fold.py's 1 us budget."""

import numpy as np
import pytest
import torch

from crimp_tpu.io.parfile import read_timing_model
from crimp_tpu.ops import anchored as jax_anchored
from crimp_tpu_torch.ops import anchored
from crimp_tpu_torch.models import timing
from tests.conftest import PAR, reference_fold
from tests.test_torch_io_models import glitchy_params  # noqa: F401  (fixture)

torch.set_num_threads(2)

BUDGET_CYCLES = 1.4e-7  # 1 us at F0 = 0.1433 Hz
PARITY_CYCLES = 1e-9


def _wrap(d):
    """Cycle difference wrapped into [-0.5, 0.5)."""
    return (np.asarray(d) + 0.5) % 1.0 - 0.5


@pytest.fixture(scope="module")
def segments(event_times):
    t = np.sort(event_times)[::7]
    return np.array_split(t, 5)


class TestFoldSegments:
    def test_matches_jax_and_oracle(self, segments):
        got, t_ref = anchored.fold_segments(PAR, segments, device="cpu")
        want, t_ref_jax = jax_anchored.fold_segments(PAR, segments)
        np.testing.assert_array_equal(t_ref, t_ref_jax)
        values, _, _ = read_timing_model(PAR)
        for g, w, seg in zip(got, want, segments):
            assert g.shape == seg.shape
            assert np.max(np.abs(_wrap(g - w))) < PARITY_CYCLES
            oracle = reference_fold(seg, values)
            frac = (oracle - np.floor(oracle)).astype(np.float64)
            assert np.max(np.abs(_wrap(g - frac))) < BUDGET_CYCLES
            assert np.all((g >= 0) & (g < 1))

    def test_glitches_and_waves(self, glitchy_params):  # noqa: F811
        rng = np.random.RandomState(4)
        segs = [np.sort(rng.uniform(lo, lo + 20.0, 400)) for lo in (58300.0, 58390.0, 58590.0, 58650.0)]
        got, _ = anchored.fold_segments(glitchy_params, segs, device="cpu")
        want, _ = jax_anchored.fold_segments(glitchy_params, segs)
        for g, w, seg in zip(got, want, segs):
            assert np.max(np.abs(_wrap(g - w))) < PARITY_CYCLES
            oracle = reference_fold(seg, glitchy_params)
            frac = (oracle - np.floor(oracle)).astype(np.float64)
            assert np.max(np.abs(_wrap(g - frac))) < BUDGET_CYCLES

    def test_explicit_anchor_and_empty(self, segments):
        t_ref = np.array([float(s.mean()) for s in segments])
        got, used = anchored.fold_segments(PAR, segments, t_ref_mjd=t_ref, device="cpu")
        want, _ = jax_anchored.fold_segments(PAR, segments, t_ref_mjd=t_ref)
        np.testing.assert_array_equal(used, t_ref)
        for g, w in zip(got, want):
            assert np.max(np.abs(_wrap(g - w))) < PARITY_CYCLES
        assert anchored.fold_segments(PAR, [], device="cpu")[0] == []


class TestAnchoredFold:
    def test_device_kernel_matches_jax(self, glitchy_params):  # noqa: F811
        rng = np.random.RandomState(9)
        t_ref = np.array([58380.0, 58420.0, 58610.0])
        idx = rng.randint(0, 3, 2000)
        times = t_ref[idx] + rng.uniform(-10.0, 10.0, 2000)
        delta = anchored.anchor_deltas(times, t_ref, idx)
        np.testing.assert_array_equal(delta, jax_anchored.anchor_deltas(times, t_ref, idx))
        am = anchored.prepare_anchors(glitchy_params, t_ref)
        am_jax = jax_anchored.prepare_anchors(glitchy_params, t_ref)
        for name in ("const", "taylor", "glep_off", "gltd_sec", "wep_off", "glf0d"):
            np.testing.assert_array_equal(getattr(am, name).numpy(), np.asarray(getattr(am_jax, name)))
        got = anchored.anchored_fold(am, torch.as_tensor(delta), torch.as_tensor(idx)).numpy()
        want = np.asarray(jax_anchored.anchored_fold(am_jax, delta, idx))
        assert np.max(np.abs(_wrap(got - want))) < PARITY_CYCLES

    def test_host_total_phase(self):
        t = np.linspace(58140.0, 58150.0, 11)
        tm = timing.from_par(PAR)
        np.testing.assert_array_equal(anchored.host_total_phase(tm, t),
                                      jax_anchored.host_total_phase(PAR, t))
