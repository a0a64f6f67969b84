"""Parity of the port's template pipeline (crimp_tpu_torch.pipelines.pulseprofile
and ops.templatefit) with crimp_tpu on the bundled observation, 1-5 keV,
70 bins (the worked example of tests/test_pipelines.py::TestTemplateGolden).

Cold (Fourier, 6 components) and warm (from the committed template) fits:
chi2 within 1e-6 relative, every parameter within 1e-6 absolute, dof
equal; the pulsed-fraction helpers equal to 1e-12; the written template
reads back in both packages.
"""

import numpy as np
import pytest
import torch

from crimp_tpu.io import template as jax_template_io
from crimp_tpu.pipelines import pulseprofile as jax_pp
from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.pipelines import pulseprofile as pp
from tests.conftest import FITS, PAR, TEMPLATE

torch.set_num_threads(2)

ORACLE_CHI2 = 57.2486  # tests/test_pipelines.py::TestTemplateGolden


def _run(module, tmp, tag, **kw):
    extra = {"device": "cpu"} if module is pp else {}
    prof = module.PulseProfileFromEventFile(FITS, PAR, eneLow=1.0, eneHigh=5.0, nbrBins=70, **extra)
    return prof.fitpulseprofile(templateFile=str(tmp / tag), **kw)


@pytest.fixture(scope="module", params=["cold", "warm"])
def fits(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    kw = ({"ppmodel": "fourier", "nbrComp": 6} if request.param == "cold"
          else {"initTemplateMod": TEMPLATE})
    return request.param, _run(pp, tmp, "port", **kw), _run(jax_pp, tmp, "ref", **kw), tmp


class TestTemplateFit:
    def test_matches_jax(self, fits):
        start, (got, model, _), (want, model_ref, _), _ = fits
        assert got["dof"] == want["dof"] == 57
        assert got["model"] == want["model"] == "fourier"
        np.testing.assert_allclose(got["chi2"], want["chi2"], rtol=1e-6)
        np.testing.assert_allclose(got["redchi2"], want["redchi2"], rtol=1e-6)
        params = [k for k in want if k.startswith(("norm", "amp_", "ph_"))]
        assert len(params) == 13
        for key in params:
            assert abs(got[key] - want[key]) < 1e-6, key
        np.testing.assert_allclose(model, model_ref, rtol=1e-6)
        limit = 1.0 if start == "cold" else 0.5
        assert abs(got["chi2"] - ORACLE_CHI2) < limit
        assert got["n_eval"] > 0

    def test_template_reads_back_in_both_packages(self, fits):
        _, (got, _, _), _, tmp = fits
        for reader in (template_io.read_template, jax_template_io.read_template):
            tpl = reader(str(tmp / "port.txt"))
            assert tpl["model"] == "fourier" and tpl["nbrComp"] == 6
            assert tpl["norm"]["value"] == got["norm"] and tpl["chi2"] == got["chi2"]
            assert tpl["ph_3"]["value"] == got["ph_3"]


class TestPulsedProperties:
    def test_helpers_equal_jax(self):
        prof = pp.PulseProfileFromEventFile(FITS, PAR, eneLow=1.0, eneHigh=5.0, nbrBins=70,
                                            device="cpu").createpulseprofile()
        ref = jax_pp.PulseProfileFromEventFile(FITS, PAR, eneLow=1.0, eneHigh=5.0,
                                               nbrBins=70).createpulseprofile()
        np.testing.assert_array_equal(prof["ppBins"], ref["ppBins"])
        np.testing.assert_array_equal(prof["countRate"], ref["countRate"])
        got = pp.calc_pulse_properties(prof, 6)
        want = jax_pp.calc_pulse_properties(ref, 6)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
        got_u = pp.calc_pulse_properties_uncertainty(prof, 6, n_simulations=200,
                                                     rng=np.random.RandomState(5))
        want_u = jax_pp.calc_pulse_properties_uncertainty(ref, 6, n_simulations=200,
                                                          rng=np.random.RandomState(5))
        for key in want_u:
            np.testing.assert_allclose(got_u[key], want_u[key], rtol=1e-12)
        assert 0.0 < got["pulsedFraction"] < 1.0

    @pytest.mark.parametrize("kind", ["vonmises", "cauchy"])
    def test_radian_families_match_jax(self, kind, tmp_path):
        got, _, pulsed = _run(pp, tmp_path, "port", ppmodel=kind, nbrComp=1,
                              calcPulsedFraction=True, figure=str(tmp_path / "fig"))
        want, _, _ = _run(jax_pp, tmp_path, "ref", ppmodel=kind, nbrComp=1)
        assert pulsed is None  # the pulsed fraction is defined for Fourier only
        assert (tmp_path / "fig.pdf").exists()
        np.testing.assert_allclose(got["chi2"], want["chi2"], rtol=1e-6)
        for key in ("norm", "amp_1", "cen_1", "wid_1"):
            assert abs(got[key] - want[key]) < 1e-6 * max(1.0, abs(want[key])), key
