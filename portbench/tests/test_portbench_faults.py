"""A whole run on the CPU at a small size (the harness's look for a card
skipped), sound and with the timed path broken underneath: each fault the
cells can have must turn ``correct`` false: an answer altered, half the
events left out, a unit returning the previous result, and Z^2 lowered in
one block of frequencies of one nudot row. One card, so no exchange
between cards can be left out."""

import numpy as np
import pytest

# the block the "tile" fault lowers: frequencies 16-31 of nudot row 2 on
# the small cells' 64 x 4 grid, which the check covers in set 1
TILE_ROW, TILE = 2, slice(16, 32)
# the -rv cell on the CPU: two intervals, and a fit cut to a few steps
# (the card runs ToAFitConfig's defaults); events enough for a pulse, and
# an error scan of 10 steps a side (12 Nelder-Mead steps leave the profile
# too rough to cross its threshold, so at 1000 it walks all 500)
RV_SIZE = dict(n_intervals=2, events=4000)
RV_CUT = dict(n_brute=8, refine_iters=2, nm_iters=12, err_dense_window=4)
RV_PH_SHIFT_RES = 20

from portbench import harness


def run(cell, small, **kw):
    if cell == "ns_1e2259.rv":
        config, mix = small(cell, **RV_SIZE)
        config["ph_shift_res"] = RV_PH_SHIFT_RES
    else:
        config, mix = small(cell)
    return harness.run(cell, 424242424242, 0.05, False, device="cpu", config=config, mix=mix,
                       log=lambda *a, **k: None, **kw)


@pytest.fixture
def program():
    from crimp_tpu_torch.ops import search
    from crimp_tpu_torch.utils import surrogate

    return surrogate, search


@pytest.mark.parametrize("cell", ["ns_1e2259.campaign", "blind_1e7.z2"])
def test_sound_run_is_correct(cell, small):
    result = run(cell, small)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"


def _lower_tile(rows, n_freq):
    block = rows[TILE_ROW * n_freq + TILE.start: TILE_ROW * n_freq + TILE.stop]
    block[:, 2] *= 0.95


def _campaign_fault(kind, surrogate, monkeypatch):
    real = surrogate.north_star
    first = {}

    def broken(par, tpl, times, intervals, **kw):
        if kind == "half":
            keep = np.sort(np.concatenate([times[i::4] for i in (0, 1)]))
            return real(par, tpl, keep, intervals, **kw)
        out = real(par, tpl, times, intervals, **kw)
        if kind == "altered":
            out["fit"]["phShift"] = out["fit"]["phShift"].copy()
            out["fit"]["phShift"][0] += 1e-4
        if kind == "tile":
            _lower_tile(out["rows"], kw["n_freq"])
        if kind == "unchanged":
            return first.setdefault("out", out)
        return out

    monkeypatch.setattr(surrogate, "north_star", broken)


def _search_fault(kind, search, monkeypatch):
    real = search.PeriodSearch
    first = {}

    class Broken(real):
        def __init__(self, time, freq, *a, **kw):
            super().__init__(time[::2] if kind == "half" else time, freq, *a, **kw)

        def twod_ztest(self, freq_dot):
            rows, table = super().twod_ztest(freq_dot)
            if kind == "altered":
                rows[np.argmax(rows[:, 2]), 2] *= 1.001
            if kind == "tile":
                _lower_tile(rows, rows.shape[0] // len(freq_dot))
            if kind == "unchanged":
                return first.setdefault("out", (rows, table))
            return rows, table

    monkeypatch.setattr(search, "PeriodSearch", Broken)


@pytest.mark.parametrize("kind", ["altered", "half", "unchanged", "tile"])
def test_campaign_fault_is_caught(kind, small, program, monkeypatch):
    _campaign_fault(kind, program[0], monkeypatch)
    result = run("ns_1e2259.campaign", small)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["altered", "half", "unchanged", "tile"])
def test_search_fault_is_caught(kind, small, program, monkeypatch):
    _search_fault(kind, program[1], monkeypatch)
    result = run("blind_1e7.z2", small)
    assert not result["correct"], result["checks"]


@pytest.fixture
def short_rv_fit(monkeypatch):
    import functools

    from crimp_tpu_torch.ops import toafit

    monkeypatch.setattr(toafit, "ToAFitConfig", functools.partial(toafit.ToAFitConfig, **RV_CUT))
    return toafit


def _rv_fault(kind, toafit, monkeypatch):
    real = toafit.fit_toas_batch_auto
    first = {}

    def broken(kind_, tpl, phases, masks, exposures, cfg, **kw):
        if kind == "half":
            masks = masks.copy()
            masks[:, 1::2] = False
        out = real(kind_, tpl, phases, masks, exposures, cfg, **kw)
        if kind == "altered":
            out["phShift"] = np.asarray(out["phShift"]).copy()
            out["phShift"][0] += 0.01
        if kind == "unchanged":
            return first.setdefault("out", out)
        return out

    monkeypatch.setattr(toafit, "fit_toas_batch_auto", broken)


def test_rv_sound_run_is_correct(small, short_rv_fit):
    result = run("ns_1e2259.rv", small)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["altered", "half", "unchanged"])
def test_rv_fault_is_caught(kind, small, short_rv_fit, monkeypatch):
    _rv_fault(kind, short_rv_fit, monkeypatch)
    result = run("ns_1e2259.rv", small)
    assert not result["correct"], result["checks"]
