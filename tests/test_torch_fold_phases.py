"""Parity of the port's phase model (crimp_tpu_torch.ops.fold), its chunked
fold, the PHASE column writer and the device ephemerides with crimp_tpu.

- taylor/glitch/wave/total phases for 2 glitches (one with GLTD 0) and 3
  waves over 10^4 MJDs: rtol 1e-13 (observed on the CPU: Taylor and total
  bitwise, glitch 1.3e-15, wave 2.3e-14 relative, the two sin/cos
  implementations);
- the batched (W, N) form equals W unbatched calls bitwise;
- fold_chunked, fold_phases and the PHASE column within 1e-9 cycles;
- spin frequency and the device integer-rotation solve within rtol 1e-13
  and 1e-9 days.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from crimp_tpu.io.events import EventFile as JaxEventFile
from crimp_tpu.models import timing as jax_timing
from crimp_tpu.ops import anchored as jax_anchored
from crimp_tpu.ops import ephem as jax_ephem
from crimp_tpu.ops import fold as jax_fold
from crimp_tpu_torch.io import fitsio
from crimp_tpu_torch.io.events import EventFile
from crimp_tpu_torch.models import convert
from crimp_tpu_torch.ops import anchored, ephem, fold
from tests.conftest import FITS, PAR
from tests.test_torch_io_models import _fields

torch.set_num_threads(2)

PARITY_CYCLES = 1e-9
PHASES = ["taylor_phase", "glitch_phase", "wave_phase", "total_phase", "phase_no_waves"]


def _wrap(d):
    return (np.asarray(d) + 0.5) % 1.0 - 0.5


@pytest.fixture(scope="module")
def model():
    """Two glitches (the second with GLTD 0, so no recovery) and three waves."""
    params = {
        "PEPOCH": 58300.0, "F0": 0.15, "F1": -1.0e-13, "F2": 1.0e-22,
        "GLEP_1": 58200.0, "GLPH_1": 0.1, "GLF0_1": 1.0e-8, "GLF1_1": -1.0e-15,
        "GLF2_1": 2.0e-24, "GLF0D_1": 2.0e-8, "GLTD_1": 30.0,
        "GLEP_2": 58400.0, "GLPH_2": -0.05, "GLF0_2": 3.0e-9, "GLF0D_2": 1.0e-9, "GLTD_2": 0.0,
        "WAVEEPOCH": 58300.0, "WAVE_OM": 0.02,
        "WAVE1": {"A": 0.01, "B": -0.02},
        "WAVE2": {"A": 0.003, "B": 0.001},
        "WAVE3": {"A": -0.002, "B": 0.004},
    }
    jax_tm = jax_timing.from_dict(params)
    return params, jax_tm, convert.timing_from_arrays(_fields(jax_tm))


@pytest.fixture(scope="module")
def mjds():
    return np.sort(np.random.RandomState(0).uniform(58100.0, 58500.0, 10_000))


class TestPhaseModel:
    @pytest.mark.parametrize("name", PHASES)
    def test_matches_jax(self, model, mjds, name):
        _, jax_tm, tm = model
        want = np.asarray(getattr(jax_fold, name)(jax_tm, mjds))
        got = getattr(fold, name)(tm, torch.as_tensor(mjds)).numpy()
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)

    def test_fold_splits_total(self, model, mjds):
        _, jax_tm, tm = model
        total, folded = fold.fold(tm, torch.as_tensor(mjds))
        total_j, folded_j = jax_fold.fold(jax_tm, mjds)
        np.testing.assert_allclose(total.numpy(), np.asarray(total_j), rtol=1e-13)
        assert np.max(np.abs(_wrap(folded.numpy() - np.asarray(folded_j)))) < PARITY_CYCLES

    @pytest.mark.parametrize("name", PHASES)
    def test_batched_equals_unbatched_bitwise(self, model, mjds, name):
        _, _, tm = model
        W = 4
        rng = np.random.RandomState(1)
        rows = []
        for _ in range(W):
            f = tm.f.clone()
            f[:3] = f[:3] * (1.0 + 1e-6 * torch.as_tensor(rng.normal(size=3)))
            glf0 = tm.glf0 * (1.0 + 0.1 * torch.as_tensor(rng.normal(size=2)))
            wave_a = tm.wave_a + 1e-3 * torch.as_tensor(rng.normal(size=3))
            rows.append(dataclasses.replace(tm, f=f, glf0=glf0, wave_a=wave_a))
        batched = dataclasses.replace(
            tm, **{k: torch.stack([getattr(r, k) for r in rows]) for k in ("f", "glf0", "wave_a")})
        t = torch.as_tensor(mjds)
        got = getattr(fold, name)(batched, t)
        assert got.shape == (W, mjds.size)
        for w, row in enumerate(rows):
            assert torch.equal(got[w], getattr(fold, name)(row, t))


class TestHostFolds:
    def test_fold_chunked_and_fold_phases(self, model):
        params, jax_tm, tm = model
        t = np.sort(np.random.RandomState(2).uniform(58100.0, 58500.0, 3000))
        got = anchored.fold_chunked(t, tm, device="cpu")
        want = np.asarray(jax_anchored.fold_chunked(t, jax_tm))
        assert np.max(np.abs(_wrap(got - want))) < PARITY_CYCLES
        total, folded = fold.fold_phases(t, params, device="cpu")
        total_j, folded_j = jax_fold.fold_phases(t, params)
        np.testing.assert_array_equal(total, total_j)
        assert np.max(np.abs(_wrap(folded - folded_j))) < PARITY_CYCLES
        # scalars in, scalars out; calcphase is the reference-named alias
        one = fold.calcphase(58200.5, PAR, device="cpu")
        one_j = jax_fold.calcphase(58200.5, PAR)
        assert isinstance(one[1], float) and abs(_wrap(one[1] - one_j[1])) < PARITY_CYCLES
        assert anchored.fold_chunked(np.zeros(0), tm, device="cpu").size == 0

    def test_add_phase_column_matches_jax(self, tmp_path):
        port, ref = tmp_path / "port.fits", tmp_path / "ref.fits"
        sibling = tmp_path / "sibling.fits"
        for path in (port, ref, sibling):
            shutil.copy(FITS, path)
        kw = EventFile(str(port)).add_phase_column(PAR, str(sibling), device="cpu")
        kw_ref = JaxEventFile(str(ref)).add_phase_column(PAR)
        assert kw == kw_ref
        got = np.asarray(fitsio.read_fits(str(port))["EVENTS"].column("PHASE"))
        want = np.asarray(fitsio.read_fits(str(ref))["EVENTS"].column("PHASE"))
        assert got.shape == want.shape and got.size > 0
        assert np.max(np.abs(_wrap(got - want))) < PARITY_CYCLES
        np.testing.assert_array_equal(
            np.asarray(fitsio.read_fits(str(sibling))["EVENTS"].column("PHASE")), got)
        # every other column is carried over unchanged
        t = np.asarray(fitsio.read_fits(str(port))["EVENTS"].column("TIME"))
        np.testing.assert_array_equal(t, np.asarray(fitsio.read_fits(FITS)["EVENTS"].column("TIME")))


class TestDeviceEphemerides:
    def test_spin_frequency_matches_jax(self, model, mjds):
        _, jax_tm, tm = model
        freq, fdot = ephem.spin_frequency(tm, torch.as_tensor(mjds))
        freq_j, fdot_j = jax_ephem.spin_frequency(jax_tm, mjds)
        np.testing.assert_allclose(freq.numpy(), np.asarray(freq_j), rtol=1e-13)
        np.testing.assert_allclose(fdot.numpy(), np.asarray(fdot_j), rtol=1e-13)

    def test_integer_rotation_matches_jax_and_host(self, model):
        _, jax_tm, tm = model
        t = np.linspace(58120.0, 58480.0, 25)
        got = ephem.integer_rotation(tm, torch.as_tensor(t))
        want = jax_ephem.integer_rotation(jax_tm, t)
        host = ephem.integer_rotation_host(tm, t)
        one_day_ns = 1e-9
        np.testing.assert_allclose(got["Tmjd_intRotation"].numpy(), np.asarray(want["Tmjd_intRotation"]),
                                   rtol=0, atol=one_day_ns)
        np.testing.assert_allclose(got["Tmjd_intRotation"].numpy(), host["Tmjd_intRotation"],
                                   rtol=0, atol=one_day_ns)
        np.testing.assert_allclose(got["freq_intRotation"].numpy(), np.asarray(want["freq_intRotation"]),
                                   rtol=1e-13)
        assert np.all(np.abs(got["phase_residual_from_integer"].numpy()) < 1e-6)

    def test_ephem_wrappers(self, capsys):
        got = ephem.ephem_at(58200.0, PAR, device="cpu")
        want = jax_ephem.ephem_at(58200.0, PAR)
        assert np.ndim(got["freqAtTmjd"]) == 0
        np.testing.assert_allclose(got["freqAtTmjd"], want["freqAtTmjd"], rtol=1e-15)
        np.testing.assert_allclose(got["freqdotAtTmjd"], want["freqdotAtTmjd"], rtol=1e-13)
        rot = ephem.ephem_integer_rotation([58144.2, 58144.6], PAR, printOutput=True)
        rot_j = jax_ephem.ephem_integer_rotation([58144.2, 58144.6], PAR)
        for key, val in rot.items():
            np.testing.assert_array_equal(val, rot_j[key])
        assert "integer number of rotations" in capsys.readouterr().out
