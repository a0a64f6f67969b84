"""The port's last five CLI tools and their pipelines against crimp_tpu, on the
CPU: merge_tim, diagnose, simulate, plots, plot_local_ephem, and the full
12-tool surface of crimp_tpu_torch.cli.

- tests/test_workflows.py::TestMergeTim's three cases: the same merged rows
  and pulse numbers as crimp_tpu, the conflict raising, the written .tim
  byte for byte crimp_tpu's;
- TestDiagnose: 84 rows, the HTML dashboard byte for byte crimp_tpu's;
- simulate_modulated_lc bitwise equal to crimp_tpu's for a seed;
- TestPlots' YAML registry and the other three plot types (PDFs written),
  the fold within 1e-10 cycles of crimp_tpu's (one f64 ulp of the ~4e5-cycle
  local Taylor sum is 2.9e-11);
- test_plot_local_ephem (a PDF written from a pandas-written table);
- all 12 tools parse --help, and every tool with --device refuses to start
  without a card unless asked for the CPU.
"""

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from crimp_tpu import cli as jax_cli
from crimp_tpu.pipelines import diagnose as jax_diagnose
from crimp_tpu.pipelines import merge_tim as jax_merge_tim
from crimp_tpu.pipelines import simulate as jax_simulate
from crimp_tpu_torch import cli
from crimp_tpu_torch.io import tim
from crimp_tpu_torch.pipelines import diagnose, merge_tim, plot_local_ephem, plots, simulate
from tests.conftest import FITS, PAR, TOAS_TXT
from tests.test_workflows import write_tim

torch.set_num_threads(2)

TOOLS = ["timeintervalsfortoas", "templatepulseprofile", "measuretoas", "diagnosetoas", "addphasecolumn",
         "ephemintegerrotation", "phshifttotimfile", "fittoas", "localephemerides", "pulseprofile_plots",
         "localephemerides_plot", "mergeoverlappingtims"]


class TestMergeTim:
    def test_merges_with_pn_shift(self, tmp_path):
        t1 = write_tim(tmp_path / "a.tim", [58100.0, 58110.0, 58120.0], [0, 100, 200])
        t2 = write_tim(tmp_path / "b.tim", [58120.0, 58130.0, 58140.0], [1200, 1300, 1400])
        merged = merge_tim.merge_tim_files([t1, t2])
        want = jax_merge_tim.merge_tim_files([t1, t2])
        assert len(merged["pulse_ToA"]) == 5 and list(merged) == list(want.columns)
        np.testing.assert_array_equal(merged["pn"], [0, 100, 200, 300, 400])
        for col in want.columns:
            assert list(merged[col]) == list(want[col]), col

    def test_conflicting_overlap_raises(self, tmp_path):
        t1 = write_tim(tmp_path / "a.tim", [58100.0, 58120.0, 58121.0], [0, 200, 210])
        t2 = write_tim(tmp_path / "b.tim", [58120.0, 58121.0, 58140.0], [1200, 1215, 1400])
        with pytest.raises(ValueError, match="inconsistent pulse"):
            merge_tim.merge_tim_files([t1, t2])
        with pytest.raises(ValueError):
            jax_merge_tim.merge_tim_files([t1, t2])
        t3 = write_tim(tmp_path / "c.tim", [59000.0], [5])
        with pytest.raises(ValueError, match="share no ToAs"):
            merge_tim.merge_tim_files([t1, t3])
        with pytest.raises(ValueError, match="at least two"):
            merge_tim.merge_tim_files([t1])

    def test_roundtrip_write(self, tmp_path):
        t1 = write_tim(tmp_path / "a.tim", [58100.0, 58110.0], [0, 100])
        t2 = write_tim(tmp_path / "b.tim", [58110.0, 58125.0], [600, 750])
        (tmp_path / "list.txt").write_text(f"# the files\n{t1}\n{t2}\n")
        merged = cli.mergeoverlappingtims([str(tmp_path / "list.txt"), "-ot", str(tmp_path / "merged")])
        assert len(tim.read_tim(str(tmp_path / "merged.tim"))["pulse_ToA"]) == 3
        assert list(merged["pn"]) == [0, 100, 250]
        jax_merge_tim.write_merged_tim(jax_merge_tim.merge_tim_files([t1, t2]), str(tmp_path / "ref"))
        assert (tmp_path / "merged.tim").read_text() == (tmp_path / "ref.tim").read_text()
        with pytest.raises(FileExistsError):
            cli.mergeoverlappingtims([t1, t2, "-ot", str(tmp_path / "merged")])
        cli.mergeoverlappingtims([t1, t2, "-ot", str(tmp_path / "merged"), "-cl"])


class TestDiagnose:
    def test_dashboard_from_committed_toas(self, tmp_path):
        table = cli.diagnosetoas([TOAS_TXT, "-of", str(tmp_path / "dash")])
        assert len(table["ToA"]) == 84
        jax_table = jax_diagnose.diagnose_toas(TOAS_TXT, outputFile=str(tmp_path / "ref"))
        np.testing.assert_allclose(table["phShift"], jax_table["phShift"].to_numpy(), rtol=1e-13)  # pandas: 1-50 ulp
        assert (tmp_path / "dash.html").read_text() == (tmp_path / "ref.html").read_text()
        assert diagnose.diagnoseToAs is diagnose.diagnose_toas


class TestSimulate:
    def test_bitwise_jax_for_a_seed(self):
        got = simulate.simulate_modulated_lc(0.25, exposure=4000.0, rng=np.random.RandomState(11))
        want = jax_simulate.simulate_modulated_lc(0.25, exposure=4000.0, rng=np.random.RandomState(11))
        for key in ("assigned_t_wBgr", "assigned_t_nobgr"):
            assert np.array_equal(got[key], want[key]) and got[key].size > 500
        with pytest.raises(ValueError, match="pulsed fraction"):
            simulate.simulate_modulated_lc(0.25, pulsedfraction=0.9)


class TestPlots:
    @pytest.fixture(scope="class")
    def folded(self):
        from crimp_tpu.pipelines.plots import prep_for_plotting as jax_prep

        df, gti = plots.prep_for_plotting(FITS, PAR, enelow=1.0, enehigh=5.0, device="cpu")
        ref_df, ref_gti = jax_prep(FITS, PAR, enelow=1.0, enehigh=5.0)
        d = np.abs(df["foldedphases"] - ref_df["foldedphases"].to_numpy())
        assert np.max(np.minimum(d, 1.0 - d)) < 1e-10
        np.testing.assert_array_equal(gti, ref_gti)
        return df

    def test_yaml_plot_registry(self, folded, tmp_path):
        cfg = {"plots": [
            {"type": "pp", "params": {"nbrbins": 32, "plotname": str(tmp_path / "pp")}},
            {"type": "phase_energy", "params": {"nphasebins": 16, "nenergybins": 8,
                                                "plotname": str(tmp_path / "pe")}},
            {"type": "no_such_plot"},
        ]}
        (tmp_path / "plots.yaml").write_text(yaml.safe_dump(cfg))
        assert plots.run_plots_from_yaml(str(tmp_path / "plots.yaml"), folded) == ["pp", "phase_energy"]
        assert (tmp_path / "pp.pdf").exists() and (tmp_path / "pe.pdf").exists()

    def test_phase_time_grid_and_before_after(self, folded, tmp_path):
        mid = float(np.median(folded["TIME"]))
        plots.plotting_phase_time(folded, nphasebins=16, ntimebins=6, plotname=str(tmp_path / "pt"))
        plots.plotting_pp_grid(folded, n_timebins=2, n_energybins=2, nbrbins=(10, 10),
                               plotname=str(tmp_path / "grid"))
        plots.plotting_pp_before_after(folded, t_mjd=mid, days_window=1.0, nbrbins=16,
                                       plotname=str(tmp_path / "ba"))
        for stem in ("pt", "grid", "ba"):
            assert (tmp_path / f"{stem}.pdf").exists()

    def test_update_gti_equals_jax(self):
        from crimp_tpu.pipelines.plots import update_gti as jax_update_gti

        gti = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
        for lo, hi in ((None, None), (1.5, 5.5), (2.5, None), (None, 3.5)):
            np.testing.assert_array_equal(plots.update_gti(gti, lo, hi), jax_update_gti(gti, lo, hi))

    def test_cli(self, tmp_path):
        (tmp_path / "p.yaml").write_text(yaml.safe_dump(
            {"plots": [{"type": "pp", "params": {"nbrbins": 20, "plotname": str(tmp_path / "cli_pp")}}]}))
        ran = cli.pulseprofile_plots([FITS, PAR, str(tmp_path / "p.yaml"), "-el", "1", "-eh", "5",
                                      "--device", "cpu"])
        assert ran == ["pp"] and (tmp_path / "cli_pp.pdf").exists()


class TestPlotLocalEphem:
    def test_plot_local_ephem(self, tmp_path):
        df = pd.DataFrame({"TOA_MJD_ref": [58200.0, 58300.0], "TOA_MJD_ref_err": [45.0, 45.0],
                           "F0": [1e-8, -1e-8], "F0_err": [5e-9, 5e-9], "F1": [-1e-14, -1e-14],
                           "F1_err": [1e-15, 1e-15], "CHI2R": [1.0, 1.1], "DOF": [10, 12]})
        path = tmp_path / "le.txt"
        df.to_csv(path, sep="\t", index=True)
        back = plot_local_ephem.read_local_ephemerides(str(path))
        assert len(back["F0"]) == 2 and list(back) == list(df.columns)
        out = plot_local_ephem.plot_local_ephemerides(back, glitches=[58250.0], plotname=str(tmp_path / "lep"))
        assert out == str(tmp_path / "lep") + ".pdf" and (tmp_path / "lep.pdf").exists()
        assert cli.localephemerides_plot([str(path), "-ts", "58250", "-gl", "58250", "-ep",
                                          str(tmp_path / "cli")]) == str(tmp_path / "cli") + ".pdf"


class TestSurface:
    @pytest.mark.parametrize("tool", TOOLS)
    def test_help(self, tool, capsys):
        with pytest.raises(SystemExit) as exc:
            cli._COMMANDS[tool](["-h"])
        assert exc.value.code == 0
        out = capsys.readouterr().out
        assert out.strip() and ("--device" in out) == (tool not in cli.HOST_TOOLS)

    def test_every_jax_tool_has_a_counterpart(self):
        assert sorted(cli._COMMANDS) == sorted(TOOLS)
        assert all(callable(getattr(jax_cli, tool)) for tool in TOOLS)

    def test_device_tools_default_to_cuda(self, tmp_path, monkeypatch):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device runs on it")
        monkeypatch.chdir(tmp_path)
        for argv, tool in (([str(tmp_path / "a.tim"), PAR], "localephemerides"),
                           ([FITS, PAR, "p.yaml"], "pulseprofile_plots")):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli._COMMANDS[tool](argv)
