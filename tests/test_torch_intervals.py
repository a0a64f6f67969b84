"""Parity of the port's interval builder (crimp_tpu_torch.pipelines.intervals)
with crimp_tpu on the bundled observation (-tc 12000, 1-5 keV), with and
without the NICER FPM exposure correction (fed the same synthetic FPM_SEL
table in both packages): equal row counts, every column
of <stem>.txt within 1e-13 (pandas' float parser), the _bunches file
identical; and each package's measure_toas reads the other's file.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from crimp_tpu.pipelines import intervals as jax_intervals
from crimp_tpu.pipelines.measure_toas import measure_toas as jax_measure_toas
from crimp_tpu_torch.io.table import read_columns
from crimp_tpu_torch.pipelines import intervals
from crimp_tpu_torch.pipelines.measure_toas import measure_toas
from tests.conftest import FITS, PAR, TEMPLATE

torch.set_num_threads(2)


def _fpm_table():
    """A condensed FPM_SEL table (the bundled file has no FPM_SEL extension):
    one row per 10 s over the observation, 44-52 selected detectors."""
    t = np.arange(58144.0, 58145.0, 10.0 / 86400.0)
    sel = 44 + np.random.RandomState(3).randint(0, 9, t.size)
    return {"TIME": t, "TOTFPMSEL": sel, "TOTFPMON": np.full(t.size, 52)}


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "correxposure"])
def both(request, tmp_path_factory):
    from crimp_tpu.io.events import EventFile as JaxEventFile
    from crimp_tpu_torch.io.events import EventFile

    tmp = tmp_path_factory.mktemp("ints")
    kw = dict(totCtsEachToA=12000, eneLow=1.0, eneHigh=5.0, correxposure=request.param)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(EventFile, "read_fpmsel", lambda self: (None, _fpm_table()))
        mp.setattr(JaxEventFile, "read_fpmsel", lambda self: (None, pd.DataFrame(_fpm_table())))
        got = intervals.build_time_intervals(FITS, outputFile=str(tmp / "port"), **kw)
        want = jax_intervals.build_time_intervals(FITS, outputFile=str(tmp / "ref"), **kw)
    return got, want, tmp, request.param


class TestBuildTimeIntervals:
    def test_table_matches_jax(self, both):
        got, want, _, corrected = both
        assert list(got) == list(want.columns) == intervals.COLUMNS
        assert len(got["ToA_tstart"]) == len(want) >= 4
        for col in intervals.COLUMNS:
            np.testing.assert_array_equal(got[col], want[col].to_numpy())
        plain_rate = got["Events"] / got["ToA_exposure"]
        assert np.all(got["ct_rate"] != plain_rate) == corrected

    def test_files_match_jax(self, both):
        _, _, tmp, _ = both
        got = pd.read_csv(tmp / "port.txt", sep=r"\s+", comment="#")
        want = pd.read_csv(tmp / "ref.txt", sep=r"\s+", comment="#")
        assert list(got.columns) == list(want.columns) == ["ToA"] + intervals.COLUMNS
        assert len(got) == len(want)
        for col in got.columns:
            np.testing.assert_allclose(got[col].to_numpy(float), want[col].to_numpy(float), rtol=1e-13)
        ported = read_columns(str(tmp / "port.txt"))
        for col in intervals.COLUMNS:
            np.testing.assert_allclose(ported[col], want[col].to_numpy(float), rtol=1e-13)
        assert (tmp / "port_bunches.txt").read_text() == (tmp / "ref_bunches.txt").read_text()

    def test_merge_folds_short_tail(self):
        rows = [
            {"ToA_tstart": 0.0, "ToA_tend": 1.0, "ToA_lenInt": 1.0, "ToA_exposure": 10.0,
             "Events": 100, "ct_rate": 10.0},
            {"ToA_tstart": 1.5, "ToA_tend": 2.0, "ToA_lenInt": 0.5, "ToA_exposure": 5.0,
             "Events": 20, "ct_rate": 4.0},
        ]
        merged = intervals.merge_adjacent_intervals(rows, events_max=50, dtstart_max_days=1.0)
        ref = jax_intervals.merge_adjacent_intervals(pd.DataFrame(rows), 50, 1.0)
        for col in intervals.COLUMNS:
            np.testing.assert_array_equal(merged[col], ref[col].to_numpy(float))
        assert merged["Events"].tolist() == [120.0]
        empty = intervals.merge_adjacent_intervals([], 50, 1.0)
        assert all(v.size == 0 for v in empty.values())


class TestCrossReading:
    def test_each_measure_toas_reads_the_others_intervals(self, both, tmp_path, monkeypatch):
        _, _, tmp, _ = both
        monkeypatch.chdir(tmp_path)
        got = measure_toas(FITS, PAR, TEMPLATE, str(tmp / "ref.txt"), eneLow=1.0, eneHigh=5.0,
                           toaEnd=1, phShiftRes=100, toaFile=str(tmp_path / "port"),
                           plotResiduals=False, device="cpu")
        want = jax_measure_toas(FITS, PAR, TEMPLATE, str(tmp / "port.txt"), eneLow=1.0, eneHigh=5.0,
                                toaEnd=1, phShiftRes=100, toaFile=str(tmp_path / "ref"))
        assert len(got["phShift"]) == len(want) == 2
        np.testing.assert_allclose(got["ToA_start"], want["ToA_start"].to_numpy(), rtol=1e-13)
        np.testing.assert_allclose(got["phShift"], want["phShift"].to_numpy(), rtol=0, atol=1e-5)
