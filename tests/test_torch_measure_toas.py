"""The port's slice as a whole: crimp_tpu_torch's measure_toas and north-star
path against crimp_tpu on the CPU, its import hygiene, and its refusal to
run on a missing card.

measure_toas runs on the TestMeasureToAsEndToEnd inputs (1-5 keV,
phShiftRes 500, count-sliced intervals of 20000 events). Columns: the
interval bookkeeping equals crimp_tpu's up to pandas' float parsing
(1e-13); phShift within 1e-6 rad; LL/UL within one step 2*pi/500; Hpower
within rtol 1e-4 (f32 trig); redChi2 within rtol 1e-6; .tim ToAs within
2 us (the 1e-6 rad shift at F0 = 0.1433 Hz). Observed on the CPU:
phShift 2.3e-7 rad, LL/UL identical, Hpower 1.7e-7 and redChi2 3e-7
relative, .tim 1.26 us -- crimp_tpu re-reads ToA_mid with pandas, whose
parse is ~2 ulp of an MJD (0.6 us each) off.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from crimp_tpu.models import profiles as jax_profiles
from crimp_tpu.io import template as jax_template_io
from crimp_tpu.ops import anchored as jax_anchored
from crimp_tpu.ops import search as jax_search
from crimp_tpu.ops import toafit as jax_toafit
from crimp_tpu.ops.ephem import spin_frequency_host as jax_spin_frequency_host
from crimp_tpu_torch.io.table import read_columns
from crimp_tpu_torch.io.tim import read_tim
from crimp_tpu_torch.pipelines.measure_toas import measure_toas
from crimp_tpu_torch.utils import surrogate
from tests.conftest import FITS, PAR, TEMPLATE, TOA_INTERVALS

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
STEP_500 = 2 * np.pi / 500


@pytest.fixture(scope="module")
def obs_intervals(tmp_path_factory):
    """tests/test_pipelines.py's interval table (20000 events per ToA)."""
    from crimp_tpu.pipelines.intervals import build_time_intervals

    out = tmp_path_factory.mktemp("intervals") / "gtis"
    build_time_intervals(FITS, totCtsEachToA=20000, waitTimeCutoff=1.0,
                         eneLow=1.0, eneHigh=5.0, outputFile=str(out))
    return str(out) + ".txt"


@pytest.fixture(scope="module")
def both_runs(obs_intervals, tmp_path_factory):
    from crimp_tpu.io.tim import read_tim as jax_read_tim
    from crimp_tpu.pipelines.measure_toas import measure_toas as jax_measure_toas

    tmp = tmp_path_factory.mktemp("toas")
    cwd = os.getcwd()
    os.chdir(tmp)  # the JAX pipeline writes its residual plot next to ToAs
    try:
        ref = jax_measure_toas(FITS, PAR, TEMPLATE, obs_intervals, eneLow=1.0, eneHigh=5.0,
                               phShiftRes=500, toaFile=str(tmp / "ref"), timFile=str(tmp / "ref"))
    finally:
        os.chdir(cwd)
    got = measure_toas(FITS, PAR, TEMPLATE, obs_intervals, eneLow=1.0, eneHigh=5.0,
                       phShiftRes=500, toaFile=str(tmp / "port"), timFile=str(tmp / "port"),
                       plotResiduals=False, device="cpu")
    return got, ref, read_tim(str(tmp / "port.tim")), jax_read_tim(str(tmp / "ref.tim")), tmp


class TestMeasureToAs:
    def test_columns_match_jax(self, both_runs):
        got, ref, _, _, _ = both_runs
        assert list(got) == list(ref.columns)
        assert len(got["ToA"]) == len(ref) >= 2
        for col in ("ToA", "nbr_events"):
            np.testing.assert_array_equal(got[col], ref[col].to_numpy())
        for col in ("ToA_mid", "ToA_start", "ToA_end", "ToA_lenInt", "ToA_exp", "count_rate"):
            np.testing.assert_allclose(got[col], ref[col].to_numpy(), rtol=1e-13)
        np.testing.assert_allclose(got["phShift"], ref["phShift"].to_numpy(), rtol=0, atol=1e-6)
        for col in ("phShift_LL", "phShift_UL"):
            assert np.max(np.abs(got[col] - ref[col].to_numpy())) <= STEP_500 * (1 + 1e-9)
        np.testing.assert_allclose(got["Hpower"], ref["Hpower"].to_numpy(), rtol=1e-4)
        np.testing.assert_allclose(got["redChi2"], ref["redChi2"].to_numpy(), rtol=1e-6)
        # TestMeasureToAsEndToEnd's properties hold for the port too
        assert np.all(np.abs(got["phShift"]) < 0.3)
        assert np.all(got["phShift_LL"] > 0) and np.all(got["phShift_UL"] > 0)
        assert np.all(got["Hpower"] > 20)

    def test_tim_matches_jax(self, both_runs):
        _, _, tim, tim_ref, tmp = both_runs
        assert list(tim) == list(tim_ref.columns)
        two_us_days = 2e-6 / 86400.0
        np.testing.assert_allclose(tim["pulse_ToA"], tim_ref["pulse_ToA"].to_numpy(float),
                                   rtol=0, atol=two_us_days)
        np.testing.assert_allclose(tim["pulse_ToA_err"], tim_ref["pulse_ToA_err"].to_numpy(float),
                                   rtol=1e-4)
        assert not (tmp / "port_phaseResiduals.pdf").exists()

    def test_cli_runs_one_interval(self, obs_intervals, tmp_path):
        stem = str(tmp_path / "cli")
        proc = subprocess.run(
            [sys.executable, "-m", "crimp_tpu_torch.cli", "measuretoas", FITS, PAR, TEMPLATE,
             obs_intervals, "-el", "1", "-eh", "5", "-te", "0", "-pr", "200", "-tf", stem,
             "-mf", stem, "--no-plotResiduals", "--device", "cpu"],
            cwd=REPO, capture_output=True, text=True, timeout=300,
            env={**os.environ, "OMP_NUM_THREADS": "2"},
        )
        assert proc.returncode == 0, proc.stderr
        table = read_columns(stem + ".txt")
        assert table["ToA"].tolist() == [0]
        assert len(read_tim(stem + ".tim")["pulse_ToA"]) == 1


class TestDiagnosticPlots:
    def test_plots_use_best_fit_theta(self, tmp_path, monkeypatch):
        """The per-ToA profile and likelihood plots render from theta_best."""
        from crimp_tpu_torch.models import profiles
        from crimp_tpu_torch.ops import toafit
        from crimp_tpu_torch.pipelines.measure_toas import _diagnostic_plots

        rng = np.random.RandomState(33)
        f64 = lambda v: torch.tensor(v, dtype=torch.float64)
        tpl = profiles.ProfileParams(norm=f64(10.0), amp=f64([3.0]), loc=f64([0.2]), wid=f64([0.0]),
                                     ph_shift=f64(0.0), amp_shift=f64(1.0))
        acc = np.empty(0)
        while acc.size < 1200:
            cand = rng.uniform(0, 1, 5000)
            rate = 10.0 + 3.0 * np.cos(2 * np.pi * cand + 0.2)
            acc = np.concatenate([acc, cand[rng.uniform(0, 13.5, 5000) < rate]])
        phases = acc[:1200][None, :]
        masks = np.ones_like(phases, dtype=bool)
        exposures = np.asarray([1200 / 10.0])
        cfg = toafit.ToAFitConfig(kind="fourier", ph_shift_res=100, n_brute=32, refine_iters=15)
        results = toafit.fit_toas_batch_auto("fourier", tpl, phases, masks, exposures, cfg, device="cpu")
        assert results["theta_best"].shape == (1, 5)  # norm, amp, loc, wid, ampShift
        assert np.isclose(results["theta_best"][0, 0], results["norm"][0])
        monkeypatch.chdir(tmp_path)
        _diagnostic_plots("fourier", tpl, phases, masks, exposures, results, cfg, [0],
                          plotPPs=True, plotLLs=True)
        assert (tmp_path / "pp_ToA0.pdf").exists()
        assert (tmp_path / "LogL_ToA0.pdf").exists()


class TestNorthStarSmall:
    def test_surrogate_matches_bench(self):
        import bench

        times, intervals = surrogate.build_surrogate(PAR, TOA_INTERVALS, TEMPLATE, events_per_toa=50, seed=7)
        ref_times, ref_int = bench.build_surrogate(PAR, TOA_INTERVALS, TEMPLATE, events_per_toa=50, seed=7)
        np.testing.assert_array_equal(times, ref_times)
        assert len(intervals["ToA_tstart"]) == len(ref_int) == 84

    @pytest.mark.parametrize("poly_trig", [None, True], ids=["default", "polynomial"])
    def test_path_matches_jax(self, poly_trig, monkeypatch):
        """The north-star path against JAX's: each package's default trig on
        the CPU (hardware sin/cos), and the polynomial asked for through the
        knob (the port's north star takes no trig argument)."""
        if poly_trig:
            monkeypatch.setenv("CRIMP_TORCH_POLY_TRIG", "1")
        times, intervals = surrogate.build_surrogate(PAR, TOA_INTERVALS, TEMPLATE, events_per_toa=10000, seed=7)
        intervals = {k: v[:2] for k, v in intervals.items()}
        times = times[times <= intervals["ToA_tend"][-1]]
        out = surrogate.north_star(PAR, TEMPLATE, times, intervals, n_freq=300, n_fdot=3, device="cpu")
        assert set(out["stages"]) == {"z2_scan", "fold", "fit", "htest", "tim", "total"}

        sec = (times - times.mean()) * 86400.0
        freqs = np.linspace(0.1430, 0.1436, 300)
        rows_ref, _ = jax_search.PeriodSearch(sec, freqs, 2, poly_trig=poly_trig).twod_ztest(
            np.linspace(-14.5, -13.5, 3))
        np.testing.assert_array_equal(out["rows"][:, :2], rows_ref[:, :2])
        np.testing.assert_allclose(out["rows"][:, 2], rows_ref[:, 2], rtol=2e-3, atol=0.05)
        assert int(np.argmax(out["rows"][:, 2])) == int(np.argmax(rows_ref[:, 2]))

        segs = jax_toafit.slice_sorted_intervals(times, intervals["ToA_tstart"], intervals["ToA_tend"])
        seg_phases, mids = jax_anchored.fold_segments(PAR, segs)
        phases, masks = jax_toafit.pad_segments(seg_phases)
        kind, tpl = jax_profiles.from_template(jax_template_io.read_template(TEMPLATE))
        fit = jax_toafit.fit_toas_batch(kind, tpl, phases, masks, intervals["ToA_exposure"],
                                        jax_toafit.ToAFitConfig(kind=kind, ph_shift_res=1000, nbins=15))
        np.testing.assert_allclose(out["fit"]["phShift"], np.asarray(fit["phShift"]), atol=1e-6, rtol=0)
        sec_seg = np.zeros_like(phases)
        for i, t_seg in enumerate(segs):
            sec_seg[i, : t_seg.size] = (t_seg - (t_seg[0] + t_seg[-1]) / 2) * 86400.0
        freqs_mid, _ = jax_spin_frequency_host(jax_anchored.timing.resolve(PAR), mids)
        h_ref = np.asarray(jax_search.h_power_segments(sec_seg, masks, freqs_mid, nharm=5))
        np.testing.assert_allclose(out["fit"]["Hpower"], h_ref, rtol=1e-4)
        assert len(out["tim"]["TOA"]) == 2


_IMPORT_CHECK = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import crimp_tpu_torch
for mod in pkgutil.walk_packages(crimp_tpu_torch.__path__, "crimp_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = [m for m in sys.modules
       if m in ("jax", "pandas", "matplotlib", "crimp_tpu")
       or m.startswith(("jax.", "pandas.", "matplotlib.", "crimp_tpu."))]
print("BAD", bad)
"""


class TestHygiene:
    def test_port_imports_no_jax_pandas_matplotlib(self):
        proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK.format(repo=str(REPO))],
                              cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "BAD []" in proc.stdout, proc.stdout

    def test_device_none_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: device=None runs on it")
        from crimp_tpu_torch.ops import anchored, search
        from crimp_tpu_torch.utils.device import resolve_device

        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            search.PeriodSearch(np.arange(10.0), np.linspace(0.1, 0.2, 5), 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            anchored.fold_segments(PAR, [np.array([58144.2, 58144.3])])
        with pytest.raises(RuntimeError, match="CUDA"):
            measure_toas(FITS, PAR, TEMPLATE, TOA_INTERVALS)

    def test_chip_smoke_refuses_without_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: chip_smoke.py runs for real there")
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
        assert "torch.cuda.is_available() is false" in proc.stderr
