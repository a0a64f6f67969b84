"""Parity of the port's host layer and models (crimp_tpu_torch.io / models)
with crimp_tpu: parsed par, template, FITS columns and .tim files match
exactly; the models and the parameter bridge (models/convert.py) carry the
same numbers; profile curves and likelihoods agree to f64 rounding."""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from crimp_tpu.io import events as jax_events
from crimp_tpu.io import parfile as jax_parfile
from crimp_tpu.io import template as jax_template
from crimp_tpu.io import tim as jax_tim
from crimp_tpu.models import profiles as jax_profiles
from crimp_tpu.models import timing as jax_timing
from crimp_tpu.ops import ephem as jax_ephem
from crimp_tpu_torch.io import events, parfile, template, tim
from crimp_tpu_torch.io.table import read_columns
from crimp_tpu_torch.models import convert, profiles, timing
from crimp_tpu_torch.ops import ephem
from tests.conftest import FITS, PAR, TEMPLATE, TOA_INTERVALS, TOAS_TIM, TOAS_TXT

torch.set_num_threads(2)


def _fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


class TestHostLayer:
    def test_par_and_template_parse_identically(self):
        assert parfile.read_timing_model(PAR) == jax_parfile.read_timing_model(PAR)
        assert template.read_template(TEMPLATE) == jax_template.read_template(TEMPLATE)

    def test_fits_columns_and_gtis_match(self):
        ef = events.EventFile(FITS)
        ref = jax_events.EventFile(FITS)
        kw, gti = ef.read_gti()
        kw_ref, gti_ref = ref.read_gti()
        assert kw == kw_ref
        np.testing.assert_array_equal(gti, gti_ref)
        got = ef.build_time_energy_df().filtenergy(1.0, 5.0).time_energy_df
        want = ref.build_time_energy_df().filtenergy(1.0, 5.0).time_energy_df
        assert list(got) == list(want.columns)
        for col in got:
            np.testing.assert_array_equal(got[col], want[col].to_numpy())
        got_t = events.EventFile(FITS).build_time_energy_df().filttime(58144.3, 58144.5).time_energy_df
        want_t = jax_events.EventFile(FITS).build_time_energy_df().filttime(58144.3, 58144.5).time_energy_df
        np.testing.assert_array_equal(got_t["TIME"], want_t["TIME"].to_numpy())

    def test_interval_table_matches_pandas(self):
        """Same columns and types as pd.read_csv; float cells to 1e-13
        (pandas' default parser is not correctly rounded, numpy's is)."""
        for path in (TOA_INTERVALS, TOAS_TXT):
            got = read_columns(path)
            want = pd.read_csv(path, sep=r"\s+", comment="#")
            assert list(got) == list(want.columns)
            for col in got:
                ref = want[col].to_numpy()
                assert got[col].dtype.kind == ref.dtype.kind
                if ref.dtype.kind == "f":
                    np.testing.assert_allclose(got[col], ref, rtol=1e-13)
                    assert np.array_equal(got[col], [float(str(v)) for v in got[col]])
                else:
                    np.testing.assert_array_equal(got[col], ref)

    def test_tim_read_and_write_round_trip(self, tmp_path):
        got = tim.read_tim(TOAS_TIM)
        want = jax_tim.read_tim(TOAS_TIM)
        assert list(got) == list(want.columns)
        for col in ("frequency", "pulse_ToA", "pulse_ToA_err"):
            assert got[col].dtype.kind == want[col].to_numpy().dtype.kind
            np.testing.assert_allclose(got[col], want[col].to_numpy(float), rtol=1e-13)
        np.testing.assert_array_equal(got["template"], want["template"].to_numpy())
        # correctly rounded parse + shortest repr reproduces the file itself
        tim.write_tim(str(tmp_path / "port"), got)
        written = (tmp_path / "port.tim").read_text().splitlines()
        assert [ln.strip() for ln in written] == open(TOAS_TIM).read().splitlines()
        with pytest.raises(FileExistsError):
            tim.write_tim(str(tmp_path / "port"), got)


class TestModels:
    def test_timing_params_from_par(self):
        got = timing.from_par(PAR)
        want = jax_timing.from_par(PAR)
        for name, ref in _fields(want).items():
            np.testing.assert_array_equal(getattr(got, name).numpy(), ref)
            assert getattr(got, name).dtype == torch.float64

    def test_convert_round_trips(self, glitchy_params):
        jax_tm = jax_timing.from_dict(glitchy_params)
        tm = convert.timing_from_arrays(_fields(jax_tm))
        ref = timing.from_dict(glitchy_params)
        for name, arr in convert.to_arrays(tm).items():
            np.testing.assert_array_equal(arr, _fields(jax_tm)[name])
            np.testing.assert_array_equal(arr, getattr(ref, name).numpy())
        assert tm.n_glitch == 2 and tm.n_wave == 3

        kind, jax_tpl = jax_profiles.from_template(jax_template.read_template(TEMPLATE))
        tpl = convert.profile_from_arrays(kind, _fields(jax_tpl))
        kind2, tpl2 = profiles.from_template(template.read_template(TEMPLATE))
        assert kind2 == kind
        for name, arr in convert.to_arrays(tpl).items():
            np.testing.assert_array_equal(arr, _fields(jax_tpl)[name])
            np.testing.assert_array_equal(arr, getattr(tpl2, name).numpy())
        with pytest.raises(ValueError):
            convert.profile_from_arrays("gauss", _fields(jax_tpl))
        with pytest.raises(KeyError):
            convert.timing_from_arrays({"pepoch": 1.0})

    @pytest.mark.parametrize("kind", ["fourier", "cauchy", "vonmises"])
    def test_curves_and_likelihoods(self, kind):
        rng = np.random.RandomState(11)
        K = 3
        jax_tpl = jax_profiles.ProfileParams(
            norm=np.float64(12.0), amp=rng.uniform(0.5, 2.0, K), loc=rng.uniform(-1, 1, K),
            wid=(np.zeros(K) if kind == "fourier" else rng.uniform(0.2, 0.6, K)),
            ph_shift=np.float64(0.07), amp_shift=np.float64(1.1),
        )
        tpl = convert.profile_from_arrays(kind, _fields(jax_tpl))
        upper = 1.0 if kind == "fourier" else 2 * np.pi
        x = rng.uniform(0, upper, 400)
        mask = rng.uniform(size=400) > 0.2
        xt, mt = torch.as_tensor(x), torch.as_tensor(mask)
        np.testing.assert_allclose(
            profiles.curve(kind, tpl, xt).numpy(),
            np.asarray(jax_profiles.curve(kind, jax_tpl, x)), rtol=1e-12)
        for m_np, m_t in ((None, None), (mask, mt)):
            want = float(jax_profiles.extended_loglik(kind, jax_tpl, x, 300.0, m_np))
            got = float(profiles.extended_loglik(kind, tpl, xt, 300.0, m_t))
            assert got == pytest.approx(want, rel=1e-12)
        y = rng.uniform(10, 14, 30)
        xb = np.linspace(0, upper, 30)
        want = float(jax_profiles.binned_loglik(kind, jax_tpl, xb, y, np.full(30, 0.5)))
        got = float(profiles.binned_loglik(kind, tpl, torch.as_tensor(xb), torch.as_tensor(y),
                                           torch.full((30,), 0.5, dtype=torch.float64)))
        assert got == pytest.approx(want, rel=1e-12)

    def test_ephemeris_host_twins(self, glitchy_params):
        mjds = np.linspace(58300.0, 58700.0, 17)
        for params in (PAR, glitchy_params):
            tm = timing.resolve(params)
            jtm = jax_timing.resolve(params)
            for got, want in zip(ephem.spin_frequency_host(tm, mjds),
                                 jax_ephem.spin_frequency_host(jtm, mjds)):
                np.testing.assert_array_equal(got, want)
            got = ephem.integer_rotation_host(tm, mjds)
            want = jax_ephem.integer_rotation_host(jtm, mjds)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])


@pytest.fixture
def glitchy_params():
    """tests/test_fold.py's glitch + wave model."""
    return {
        "PEPOCH": 58359.55765869704,
        "F0": 0.14328254547263483,
        "F1": -9.746993965547238e-15,
        "F2": 1.3624129994547033e-23,
        "GLEP_1": 58400.0, "GLPH_1": 0.1, "GLF0_1": 1e-7, "GLF1_1": -1e-14,
        "GLF2_1": 0.0, "GLF0D_1": 2e-7, "GLTD_1": 40.0,
        "GLEP_2": 58600.0, "GLPH_2": -0.05, "GLF0_2": 5e-8, "GLF1_2": 0.0,
        "GLF2_2": 0.0, "GLF0D_2": 0.0, "GLTD_2": 1.0,
        "WAVEEPOCH": 58359.5, "WAVE_OM": 0.01,
        "WAVE1": {"A": 0.02, "B": -0.01},
        "WAVE2": {"A": 0.005, "B": 0.003},
        "WAVE3": {"A": -0.002, "B": 0.001},
    }
