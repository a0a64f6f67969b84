"""The port's timing-model fit (crimp_tpu_torch.pipelines.fit_toas) against
crimp_tpu on tests/test_fit_toas.py's synthetic fixture (40 ToAs at integer
rotations of a true model, F0 free, TRACK -2), and the worked example as a
whole through the port's CLI on the CPU.

- MLE (Nelder-Mead; BFGS when waves are free): post-fit .par values within
  1e-12 relative of crimp_tpu's, CHI2R and NTOA equal;
- load_toas_for_fit and add_phasewrap equal;
- MCMC at 600 steps x 16 walkers covers the truth within 5e-11 Hz;
  mcmc_delta=1 samples through the delta-basis likelihood;
- steps 1-4 of tests/test_workflows.py::TestFullJourney::test_campaign_chain
  (intervals -> template -> ToAs + .tim -> MLE) with its physical checks.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from crimp_tpu.io import tim as jax_tim
from crimp_tpu.io import yamlcfg as jax_yamlcfg
from crimp_tpu.io.parfile import get_parameter_value, read_timing_model as jax_read_timing_model
from crimp_tpu.pipelines import fit_toas as jax_fit_toas
from crimp_tpu_torch import cli
from crimp_tpu_torch.io import tim
from crimp_tpu_torch.io.parfile import read_statistics, read_timing_model
from crimp_tpu_torch.io.table import read_columns
from crimp_tpu_torch.io.yamlcfg import Prior
from crimp_tpu_torch.pipelines import fit_toas
from tests.conftest import FITS, PAR, TEMPLATE
from tests.test_fit_toas import F0_TRUE, F1_TRUE, PEPOCH, synth_tim, write_par

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit")
    par_true = write_par(tmp / "true.par", F0_TRUE + 2.0e-9, F1_TRUE)
    par_base = write_par(tmp / "base.par", F0_TRUE, F1_TRUE, fit_f0=True)
    return par_true, par_base, synth_tim(tmp / "toas.tim", par_true), tmp


def _par_values(path):
    return {**read_timing_model(path)[0], **read_statistics(path)}


@pytest.fixture
def same_parse(monkeypatch):
    """Hand crimp_tpu the port's correctly rounded .tim parse: pandas'
    to_numeric puts the synthetic ToAs up to 1 ulp (0.63 us) off, which
    moves chi2 by ~1e-3 relative and hides the comparison."""
    monkeypatch.setattr(jax_fit_toas.tim_io, "read_tim",
                        lambda path, comment="C": pd.DataFrame(tim.read_tim(path, comment=comment)))


class TestMLE:
    def test_matches_jax(self, fixture, tmp_path, same_parse):
        _, par_base, tim_path, _ = fixture
        got = fit_toas.fit_toas(tim_path, par_base, str(tmp_path / "port.par"),
                                residual_plot=str(tmp_path / "res"), device="cpu")
        want = jax_fit_toas.fit_toas(tim_path, par_base, str(tmp_path / "ref.par"))
        assert got["keys"] == want["keys"] == ["F0"]
        np.testing.assert_allclose(got["values"], want["values"], rtol=1e-12)
        port, ref = _par_values(tmp_path / "port.par"), _par_values(tmp_path / "ref.par")
        assert set(port) == set(ref)
        for key, val in ref.items():
            np.testing.assert_allclose(port[key], val, rtol=1e-12, err_msg=key)
        assert port["CHI2R"] == ref["CHI2R"] and port["NTOA"] == ref["NTOA"] == 40
        assert abs(get_parameter_value(port["F0"]) - (F0_TRUE + 2.0e-9)) < 2.0e-11
        assert got["stats"] == want["stats"] and got["rms_cycle"] == want["rms_cycle"]
        assert (tmp_path / "res.pdf").exists()

    def test_wave_fit_matches_jax(self, tmp_path, same_parse):
        """WAVE_OM flag 1 frees WAVEk_A/B: the BFGS branch."""
        om = 2 * np.pi / 300.0
        lines = ["PSR J0000+0000", f"F0 {F0_TRUE!r}", f"F1 {F1_TRUE!r}", f"PEPOCH {PEPOCH}",
                 "WAVEEPOCH 58300.0", f"WAVE_OM {om!r} 1", "WAVE1 0.0 0.0", "TRACK -2"]
        (tmp_path / "base.par").write_text("\n".join(lines) + "\n")
        rng = np.random.RandomState(8)
        toas = np.sort(rng.uniform(58100.0, 58500.0, 30))
        wave_days = (0.02 * np.sin(om * (toas - 58300.0)) - 0.015 * np.cos(om * (toas - 58300.0))) / 86400.0
        with open(tmp_path / "w.tim", "w") as fh:
            fh.write("FORMAT 1\n")
            for t, pn in zip(toas + wave_days, np.round((toas - PEPOCH) * 86400.0 * F0_TRUE)):
                fh.write(f" fake 300.0 {t:.13f} 2000.000 @ -pn {int(pn)}\n")
        got = fit_toas.fit_toas(str(tmp_path / "w.tim"), str(tmp_path / "base.par"),
                                str(tmp_path / "port.par"), device="cpu")
        want = jax_fit_toas.fit_toas(str(tmp_path / "w.tim"), str(tmp_path / "base.par"),
                                     str(tmp_path / "ref.par"))
        assert got["keys"] == want["keys"] == ["WAVE1_A", "WAVE1_B"]
        np.testing.assert_allclose(got["values"], want["values"], rtol=1e-12)
        assert got["stats"]["chi2"] == pytest.approx(want["stats"]["chi2"], rel=1e-12)


class TestToALoading:
    def test_load_toas_for_fit_equals_jax(self, fixture):
        _, par_base, tim_path, _ = fixture
        for kw in ({}, {"t_start": 58200.0, "t_stop": 58450.0}, {"t_mjd_phasewrap": [58300.0]}):
            got = fit_toas.load_toas_for_fit(tim.read_tim(tim_path), read_timing_model(par_base)[2],
                                             device="cpu", **kw)
            # the same (correctly rounded) parse in both: see same_parse
            want = jax_fit_toas.load_toas_for_fit(pd.DataFrame(tim.read_tim(tim_path)),
                                                  jax_read_timing_model(par_base)[2], **kw)
            assert list(got) == list(want.columns)
            for col in got:
                np.testing.assert_array_equal(got[col], want[col].to_numpy())
        # pandas' own parse is 1 ulp (0.63 us, 9.4e-8 cycles at 0.15 Hz) off
        pandas_parse = jax_fit_toas.load_toas_for_fit(jax_tim.read_tim(tim_path),
                                                      jax_read_timing_model(par_base)[2])
        got = fit_toas.load_toas_for_fit(tim.read_tim(tim_path), read_timing_model(par_base)[2],
                                         device="cpu")
        np.testing.assert_allclose(got["phase"], pandas_parse["phase"].to_numpy(), rtol=0, atol=2e-7)

    def test_add_phasewrap_equals_jax(self):
        base = {"ToA": np.array([58100.0, 58200.0, 58300.0]), "phase": np.zeros(3)}
        for cuts, mode in (([58150.0], "add"), ([58150.0, 58250.0], "subtract"), ([], "add")):
            got = fit_toas.add_phasewrap({k: v.copy() for k, v in base.items()}, cuts, mode=mode)
            want = jax_fit_toas.add_phasewrap(pd.DataFrame(base), cuts, mode=mode)
            np.testing.assert_array_equal(got["phase"], want["phase"].to_numpy())
        with pytest.raises(ValueError):
            fit_toas.add_phasewrap(dict(base), [58150.0], mode="sideways")


class TestMCMC:
    def test_posterior_covers_truth(self, fixture, tmp_path):
        _, par_base, tim_path, _ = fixture
        yaml_path = tmp_path / "prior.yaml"
        yaml_path.write_text("F0: [-1.0e-8, 1.0e-8]\n")
        out = tmp_path / "fit_mcmc.par"
        result = fit_toas.fit_toas(
            tim_path, par_base, str(out), mcmc=True, mcmc_steps=600, mcmc_burn=150,
            mcmc_walkers=16, init_yaml=str(yaml_path), corner_plot_path=str(tmp_path / "corner"),
            chain_npy=str(tmp_path / "chain.npy"), device="cpu",
        )
        f0_fit = get_parameter_value(read_timing_model(str(out))[2]["F0"])
        assert abs(f0_fit - (F0_TRUE + 2.0e-9)) < 5.0e-11
        assert (tmp_path / "corner.pdf").exists()
        assert np.load(tmp_path / "chain.npy").shape == (600, 16, 1)
        assert result["keys"] == ["F0"] and result["stats"]["dof"] == 39

    def test_delta_likelihood_is_not_ported(self, fixture):
        """The delta-basis likelihood is ported now: mcmc_delta=1 samples the
        {F0} set through it (tests/test_torch_mcmc_delta.py holds it against
        crimp_tpu)."""
        _, par_base, tim_path, _ = fixture
        toas = fit_toas.load_toas_for_fit(tim.read_tim(tim_path), read_timing_model(par_base)[2],
                                          device="cpu")
        args = (toas["ToA"], toas["phase"], toas["phase_err_cycle"], read_timing_model(par_base)[2], ["F0"],
                Prior({"F0": (-1e-8, 1e-8)}, {}))
        data, info = fit_toas.make_logprob_delta(*args[3:], *args[:3], device="cpu")
        assert info["eligible"] and data["basis"].shape == (40, 1)
        chain, _, _ = fit_toas.run_mcmc(*args, steps=10, walkers=8, burn=2, mcmc_delta=1, device="cpu")
        assert chain.shape == (10, 8, 1) and np.all(np.abs(chain) < 1e-8)


class TestWorkedExample:
    def test_campaign_chain_through_cli(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        cpu = ["--device", "cpu"]
        # 1) ToA intervals from the bundled observation
        cli.timeintervalsfortoas([FITS, "-tc", "12000", "-el", "1", "-eh", "5",
                                  "-of", str(tmp_path / "ints")] + cpu)
        ints = read_columns(str(tmp_path / "ints.txt"))
        assert len(ints["ToA"]) >= 4
        # 2) template from the same observation, warm-started from the committed one
        fit, _, _ = cli.templatepulseprofile([FITS, PAR, "-el", "1", "-eh", "5", "-nb", "70",
                                              "-it", TEMPLATE, "-tf", str(tmp_path / "tpl")] + cpu)
        assert "chi2" in (tmp_path / "tpl.txt").read_text() and fit["dof"] == 57
        # 3) ToAs + .tim against the fresh template
        toas = cli.measuretoas([FITS, PAR, str(tmp_path / "tpl.txt"), str(tmp_path / "ints.txt"),
                                "-el", "1", "-eh", "5", "-pr", "300", "-tf", str(tmp_path / "ToAs"),
                                "-mf", str(tmp_path / "ToAs"), "--no-plotResiduals"] + cpu)
        assert len(toas["ToA"]) == len(ints["ToA"])
        assert np.isfinite(toas["phShift"]).all()
        assert (toas["Hpower"] > 30).all()
        assert (np.abs(toas["phShift"]) < 0.5).all()
        # 4) MLE on the fresh .tim with F0 free
        fit_par = tmp_path / "fit.par"
        fit_par.write_text("".join(
            line.rstrip("\n") + " 1\n" if line.startswith("F0") else line
            for line in pathlib.Path(PAR).read_text().splitlines(keepends=True)
        ))
        res = cli.fittoas([str(tmp_path / "ToAs.tim"), str(fit_par), str(tmp_path / "post.par")] + cpu)
        assert np.isfinite(res["stats"]["redchi2"])
        assert res["rms_cycle"] < 0.05
        post = (tmp_path / "post.par").read_text()
        assert "CHI2R" in post and "NTOA" in post

    def test_host_tools_and_dispatch(self, tmp_path):
        import shutil

        from crimp_tpu_torch.io import fitsio

        shutil.copy(FITS, tmp_path / "evt.fits")
        kw = cli.addphasecolumn([str(tmp_path / "evt.fits"), PAR, "--device", "cpu"])
        phase = np.asarray(fitsio.read_fits(str(tmp_path / "evt.fits"))["EVENTS"].column("PHASE"))
        assert kw["TELESCOPE"] == "NICER" and np.all((phase >= 0) & (phase < 1))
        rot = cli.ephemintegerrotation(["58144.3", PAR, "--device", "cpu"])
        assert abs(rot["phase_residual_from_integer"]) < 1e-6
        proc = subprocess.run(
            [sys.executable, "-m", "crimp_tpu_torch.cli", "phshifttotimfile",
             str(REPO / "tests" / "data" / "ToAs_2259.txt"), PAR, "-tf", str(tmp_path / "res"),
             "-ap", "--device", "cpu"],
            cwd=REPO, capture_output=True, text=True, timeout=120,
            env={**os.environ, "OMP_NUM_THREADS": "2"},
        )
        assert proc.returncode == 0, proc.stderr
        table = tim.read_tim(str(tmp_path / "res.tim"))
        assert len(table["pulse_ToA"]) == len(read_columns(str(REPO / "tests" / "data" / "ToAs_2259.txt"))["ToA"])
        assert "pn" in table

    def test_every_tool_defaults_to_cuda(self, tmp_path, monkeypatch):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device runs on it")
        monkeypatch.chdir(tmp_path)  # measuretoas opens its log before it resolves the device
        args = {
            "timeintervalsfortoas": [FITS, "-of", str(tmp_path / "i")],
            "templatepulseprofile": [FITS, PAR],
            "measuretoas": [FITS, PAR, TEMPLATE, "ints.txt"],
            "addphasecolumn": [str(tmp_path / "absent.fits"), PAR],
            "ephemintegerrotation": ["58144.3", PAR],
            "phshifttotimfile": ["ToAs.txt", PAR],
            "fittoas": ["toas.tim", PAR, "out.par"],
            "localephemerides": ["toas.tim", PAR],
            "pulseprofile_plots": [FITS, PAR, "plots.yaml"],
        }
        assert set(args) == set(cli._COMMANDS) - set(cli.HOST_TOOLS)
        for name, argv in args.items():
            with pytest.raises(RuntimeError, match="CUDA"):
                cli._COMMANDS[name](argv)


class TestFitUtilsAndPriors:
    PAR = """PSR J0000+0000
F0 0.15 1
F1 -1.0e-13 1
PEPOCH 58300.0
GLEP_1 58250.0
GLPH_1 0.0 1
GLF0_1 2.0e-9 1
GLF0D_1 0.0
GLTD_1 20.0 1
WAVEEPOCH 58300.0
WAVE_OM 0.03 1
WAVE1 0.002 -0.001
"""

    def test_bookkeeping_and_residuals_equal_jax(self, tmp_path):
        from crimp_tpu.pipelines import fit_utils as jax_fit_utils
        from crimp_tpu_torch.pipelines import fit_utils

        path = tmp_path / "m.par"
        path.write_text(self.PAR)
        port, ref = read_timing_model(str(path))[2], jax_read_timing_model(str(path))[2]
        keys = fit_utils.list_fit_keys(port)
        assert keys == jax_fit_utils.list_fit_keys(ref)
        assert keys == ["F0", "F1", "GLPH_1", "GLF0_1", "GLTD_1", "WAVE1_A", "WAVE1_B"]
        pvec = np.array([1e-10, 1e-17, 0.01, 1e-10, 2.0, 1e-4, -2e-4])
        assert fit_utils.inject_free_params(port, pvec, keys) == jax_fit_utils.inject_free_params(ref, pvec, keys)
        assert port["GLTD_1"]["value"] == 0  # zeroed: GLF0D_1 is 0
        t = np.linspace(58100.0, 58500.0, 30)
        for subset in (keys, keys[:4], keys[-2:]):
            sub = pvec[[keys.index(k) for k in subset]]
            np.testing.assert_array_equal(fit_utils.model_phase_residuals(t, port, sub, subset),
                                          jax_fit_utils.model_phase_residuals(t, ref, sub, subset))
        fit_utils.validate_parfile(port)
        with pytest.raises(ValueError, match="fit flag"):
            fit_utils.validate_parfile({"F0": {"value": 0.1, "flag": 2}})
        with pytest.raises(ValueError, match="no free parameters"):
            fit_utils.validate_parfile({"F0": {"value": 0.1, "flag": 0}})
        y = np.random.RandomState(1).normal(size=30)
        assert fit_utils.gaussian_nll(y, 0.0, 0.5) == jax_fit_utils.gaussian_nll(y, 0.0, 0.5)
        assert fit_utils.chi2_fit(y, 0.1, 0.5, 2) == jax_fit_utils.chi2_fit(y, 0.1, 0.5, 2)
        assert fit_utils.rms_residual(y, 0.1) == jax_fit_utils.rms_residual(y, 0.1)

    @pytest.mark.parametrize("text", [
        "F0: [-1.0e-8, 1.0e-8]\nF1: [-1.0e-15, 1.0e-15]\n",
        "F0:\n  low: -1.0e-8\n  high: 1.0e-8\n  guess: 2.0e-9\n",
        "F0: 2.0e-9\nF1: 0.0\n",
    ])
    def test_prior_files_parse_as_jax(self, tmp_path, text):
        from crimp_tpu_torch.io import yamlcfg

        path = tmp_path / "p.yaml"
        path.write_text(text)
        got, want = yamlcfg.load_prior(str(path)), jax_yamlcfg.load_prior(str(path))
        assert (got.bounds, got.initial_guess) == (want.bounds, want.initial_guess)
        theta = [5e-9, 0.0]
        assert got.log_prior(theta, ["F0", "F1"]) == want.log_prior(theta, ["F0", "F1"])

    @pytest.mark.parametrize("text", ["F0: [1.0, 0.0]\n", "F0: [0.0, 1.0]\nF1: 2.0\n", "F0: abc\n"])
    def test_bad_prior_files_raise(self, tmp_path, text):
        from crimp_tpu_torch.io import yamlcfg

        path = tmp_path / "p.yaml"
        path.write_text(text)
        with pytest.raises(ValueError):
            yamlcfg.load_prior(str(path))
        with pytest.raises(ValueError):
            jax_yamlcfg.load_prior(str(path))

    def test_pulse_toas_filter_reset_write(self, tmp_path):
        from tests.conftest import TOAS_TIM

        table = tim.read_tim(TOAS_TIM)
        pt = tim.PulseToAs(table)
        ref = jax_tim.PulseToAs(jax_tim.read_tim(TOAS_TIM))
        part = pt.time_filter(58300.0, 58500.0, inplace=False)
        np.testing.assert_allclose(part["pulse_ToA"],  # pandas' parse: 1e-13
                                   ref.time_filter(58300.0, 58500.0, inplace=False)["pulse_ToA"].to_numpy(float),
                                   rtol=1e-13)
        assert len(pt.df["pulse_ToA"]) == len(table["pulse_ToA"])
        pt.time_filter(58300.0, None)
        assert pt.df["pulse_ToA"].min() >= 58300.0
        pt.writetimfile(str(tmp_path / "part"))
        assert len(tim.read_tim(str(tmp_path / "part.tim"))["pulse_ToA"]) == len(pt.df["pulse_ToA"])
        assert len(pt.reset().df["pulse_ToA"]) == len(table["pulse_ToA"])
