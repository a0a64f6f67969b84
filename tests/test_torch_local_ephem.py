"""Parity of the port's local ephemerides (crimp_tpu_torch.pipelines.local_ephem)
with crimp_tpu, on the CPU.

- tests/test_workflows.py::TestLocalEphem's synthetic case (60 integer-
  rotation ToAs, 120-day windows, 60-day jumps, 400 steps x 16 walkers), the
  port fed the draws jax.random makes from crimp_tpu's per-window keys and
  both packages fed the same .tim parse: the same windows, epochs and DOF
  exactly; F0 and F1 within 5% of their posterior errors, the errors within
  10% and CHI2R within 1e-3 relative. The chains start equal to 1e-12 but
  the stretch move amplifies a 1-ulp difference in a proposal about 1000x
  per 100 steps (3e-7 to 2e-5 of the box apart by step 300), so the
  summaries of a 400-step run agree to about 1% of the posterior width
  (measured: F0 0.7%, F1 1.5%, errors 2.2%, CHI2R 1.6e-4);
- step 5 of test_campaign_chain through the port's CLI (localephemerides
  with --device cpu at the CLI defaults, 1000 steps x 24 walkers) on the
  committed campaign .tim, under the same physical bound;
- the port's table read back by crimp_tpu's read_local_ephemerides, and
  written in the layout of pandas' to_csv.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from crimp_tpu.io.parfile import read_timing_model as jax_read_timing_model
from crimp_tpu.pipelines import local_ephem as jax_local_ephem
from crimp_tpu.pipelines.plot_local_ephem import read_local_ephemerides as jax_read_local_ephemerides
from crimp_tpu_torch import cli
from crimp_tpu_torch.io import tim
from crimp_tpu_torch.models import timing
from crimp_tpu_torch.ops import mcmc
from crimp_tpu_torch.ops.ephem import integer_rotation_host
from crimp_tpu_torch.pipelines import local_ephem
from crimp_tpu_torch.pipelines.plot_local_ephem import read_local_ephemerides
from tests.conftest import PAR, TOAS_TIM
from tests.test_torch_mcmc import _jax_draws
from tests.test_workflows import write_tim

torch.set_num_threads(2)

STEPS, BURN, WALKERS = 400, 100, 16


@pytest.fixture(autouse=True)
def _quiet_knobs(monkeypatch):
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE", "0")
    monkeypatch.delenv("CRIMP_TPU_MCMC_DELTA", raising=False)


@pytest.fixture
def synthetic_tim(tmp_path):
    tm = timing.resolve(PAR)
    rng = np.random.RandomState(2)
    anchors = integer_rotation_host(tm, np.linspace(58150.0, 58450.0, 60))
    toas = np.asarray(anchors["Tmjd_intRotation"]) + rng.normal(0, 5e-4 / 86400, 60)
    pns = np.round(np.asarray(anchors["ph_intRotation"])).astype(int)
    return write_tim(tmp_path / "le.tim", toas, pns, err_us=500.0)


def _window_draws(n_windows):
    """crimp_tpu's per-window random numbers: ensemble_sample_batch splits
    PRNGKey(0) into one key per window."""
    per = [_jax_draws(k, STEPS, WALKERS) for k in jax.random.split(jax.random.PRNGKey(0), n_windows)]
    return mcmc.Draws(*(torch.stack([d[i] for d in per], dim=1) for i in range(3)))


class TestSyntheticWindows:
    def test_table_matches_jax_fed_draws(self, synthetic_tim, tmp_path, monkeypatch):
        # both packages parse the .tim the port's (correctly rounded) way
        monkeypatch.setattr(jax_local_ephem.tim_io, "read_tim",
                            lambda path, comment="C", skiprows=1: pd.DataFrame(tim.read_tim(path, comment)))
        monkeypatch.chdir(tmp_path)
        kw = dict(interval_days=120.0, jump_days=60.0, min_interval=45.0, mcmc_steps=STEPS, mcmc_burn=BURN,
                  mcmc_walkers=WALKERS)
        want = jax_local_ephem.generate_local_ephemerides(synthetic_tim, PAR, outputfile=str(tmp_path / "ref"),
                                                          **kw)
        got = local_ephem.generate_local_ephemerides(synthetic_tim, PAR, outputfile=str(tmp_path / "port"),
                                                     device="cpu", draws=_window_draws(len(want)), **kw)
        assert len(want) >= 2 and list(got) == list(want.columns)
        for col in ("TOA_MJD_ref", "TOA_MJD_ref_err", "DOF"):
            np.testing.assert_array_equal(got[col], want[col].to_numpy(), err_msg=col)
        for col in ("F0", "F1"):
            assert np.all(np.abs(got[col] - want[col].to_numpy()) < 0.05 * got[f"{col}_err"]), col
        for col, rtol in (("F0_err", 0.1), ("F1_err", 0.1), ("CHI2R", 1e-3)):
            np.testing.assert_allclose(got[col], want[col].to_numpy(), rtol=rtol, atol=0, err_msg=col)
        # the written tables, read by crimp_tpu's reader
        back, ref = jax_read_local_ephemerides(str(tmp_path / "port.txt")), \
            jax_read_local_ephemerides(str(tmp_path / "ref.txt"))
        assert list(back.columns) == list(ref.columns) and len(back) == len(ref)
        np.testing.assert_array_equal(back["TOA_MJD_ref"].to_numpy(), ref["TOA_MJD_ref"].to_numpy())
        # the detrend leaves the model's quadratic term (TestLocalEphem's bound)
        vals = jax_read_timing_model(PAR)[0]
        dt = (got["TOA_MJD_ref"] - vals["PEPOCH"]) * 86400.0
        assert np.all(np.abs(got["F0"] - vals["F2"] * dt**2 / 2.0) < 6 * got["F0_err"] + 2e-10)

    def test_generator_path_and_no_window(self, synthetic_tim, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        table = local_ephem.generate_local_ephemerides(
            synthetic_tim, PAR, interval_days=120.0, jump_days=60.0, mcmc_steps=STEPS, mcmc_burn=BURN,
            mcmc_walkers=WALKERS, outputfile=None, device="cpu")
        assert len(table["F0"]) >= 2 and np.all(np.isfinite(table["F0_err"]))
        assert local_ephem.generate_local_ephemerides(synthetic_tim, PAR, min_interval=1e4, outputfile=None,
                                                      device="cpu") == {}


class TestCampaignStep5:
    def test_cli_on_the_campaign_tim(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        table = cli.localephemerides([TOAS_TIM, PAR, "-id", "120", "-jd", "60", "-mi", "45",
                                      "-of", str(tmp_path / "locephem"), "--device", "cpu"])
        assert len(table["F0"]) >= 2
        vals = jax_read_timing_model(PAR)[0]
        dt = (table["TOA_MJD_ref"] - vals["PEPOCH"]) * 86400.0
        resid = table["F0"] - vals["F2"] * dt**2 / 2.0
        assert np.all(np.abs(resid) < 6 * table["F0_err"] + 5e-8)
        back = jax_read_local_ephemerides(str(tmp_path / "locephem.txt"))
        np.testing.assert_array_equal(back["F0"].to_numpy(), table["F0"])
        with pytest.raises(FileExistsError):  # no --clobber: the table is not overwritten
            cli.localephemerides([TOAS_TIM, PAR, "-id", "120", "-jd", "60", "-of", str(tmp_path / "locephem"),
                                  "--device", "cpu"])


class TestTableLayout:
    def test_written_as_pandas_writes_it(self, tmp_path):
        table = {"TOA_MJD_ref": np.array([58200.123456789, 58300.5]), "TOA_MJD_ref_err": np.array([45.0, 44.5]),
                 "F0": np.array([1.2345678901234e-8, -3e-10]), "F0_err": np.array([5e-9, 5.5e-9]),
                 "F1": np.array([-1e-14, -1.1e-14]), "F1_err": np.array([1e-15, 2e-15]),
                 "CHI2R": np.array([1.0, 1.1]), "DOF": np.array([10, 12])}
        local_ephem.write_table(table, str(tmp_path / "port.txt"))
        pd.DataFrame(table).to_csv(tmp_path / "pandas.txt", sep="\t", index=True, header=True)
        assert (tmp_path / "port.txt").read_text() == (tmp_path / "pandas.txt").read_text()
        back = read_local_ephemerides(str(tmp_path / "port.txt"), t_start=58250.0)
        assert list(back) == list(table) and back["DOF"].tolist() == [12]
        np.testing.assert_array_equal(back["F0"], [-3e-10])
