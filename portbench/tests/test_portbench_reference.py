"""The plain reference against the program's CPU versions at a tiny size.

Only these tests bring the two together; the reference itself imports
nothing of the program."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import campaign as ref
from portbench.reference import timing, toafit, z2
from portbench.gen import events
from portbench import harness

CONFIG_DIR = harness.HERE / "configs"
PAR = str(CONFIG_DIR / "data" / "1e2259.par")
TEMPLATE = str(CONFIG_DIR / "data" / "1e2259_template.txt")
INTERVALS = str(CONFIG_DIR / "data" / "timIntToAs_1e2259.txt")


def small_events(n_int=3, per=3000, seed=11):
    par, tpl = timing.read_par(PAR), timing.read_template(TEMPLATE)
    iv = timing.read_table(INTERVALS)
    iv = {k: v[:n_int] for k, v in iv.items()}
    plan = events.interval_plan(par, iv["ToA_tstart"], iv["ToA_tend"])
    t = events.draw_times(plan, events.profile_cdf(tpl), np.full(n_int, per), seed, 0, "cpu").numpy()
    return par, tpl, iv, t


def test_every_event_inside_its_interval():
    _, _, iv, t = small_events()
    segs = ref.segments(t, iv["ToA_tstart"], iv["ToA_tend"])
    assert [s.size for s in segs] == [3000] * 3
    assert np.all(np.diff(t) >= 0)


def test_fold_against_the_program():
    from crimp_tpu_torch.ops import anchored

    par, _, iv, t = small_events()
    segs = ref.segments(t, iv["ToA_tstart"], iv["ToA_tend"])
    prog, _ = anchored.fold_segments(PAR, segs, device="cpu", delta_fold=0)
    for s, p in zip(segs, prog):
        d = np.abs(timing.folded(par, s) - p)
        assert np.max(np.minimum(d, 1 - d)) < 1e-9


def test_z2_against_the_program():
    from crimp_tpu_torch.ops import search

    _, _, _, t = small_events()
    sec = events.seconds_since_mean(t)
    freqs = np.linspace(0.1430, 0.1436, 16)
    log_fdots = np.array([-14.5, -14.0])
    rows, _ = search.PeriodSearch(sec, freqs, 2, device="cpu").twod_ztest(log_fdots)
    fd = -(10.0 ** rows[:, 1])
    mine = z2.z2_trials(torch.as_tensor(sec), torch.as_tensor(rows[:, 0]), torch.as_tensor(fd), 2).numpy()
    assert np.max(np.abs(mine - rows[:, 2]) / (rows[:, 2] + 4)) < 1e-4


def test_fit_htest_tim_against_the_program():
    from crimp_tpu_torch.models import profiles
    from crimp_tpu_torch.models import timing as prog_timing
    from crimp_tpu_torch.io import template as template_io
    from crimp_tpu_torch.ops import anchored, search, toafit as prog_fit
    from crimp_tpu_torch.ops.ephem import spin_frequency_host
    from crimp_tpu_torch.pipelines.tim_tools import toas_to_tim_table

    par, tpl, iv, t = small_events()
    segs = ref.segments(t, iv["ToA_tstart"], iv["ToA_tend"])
    mine = ref.fit_intervals(par, tpl, segs, iv["ToA_exposure"], 1000, "cpu")
    kind, ptpl = profiles.from_template(template_io.read_template(TEMPLATE))
    phases, mids = anchored.fold_segments(PAR, segs, device="cpu", delta_fold=0)
    x, m = prog_fit.pad_segments(phases)
    cfg = prog_fit.ToAFitConfig(kind=kind, ph_shift_res=1000, nbins=15)
    fit = {k: v.numpy() for k, v in prog_fit.fit_toas_batch(kind, ptpl, x, m, iv["ToA_exposure"], cfg,
                                                          device="cpu").items()}
    assert np.max(np.abs(mine["phShift"] - fit["phShift"])) < 1e-6
    assert np.array_equal(mine["phShift_LL"], fit["phShift_LL"]) and np.array_equal(mine["phShift_UL"], fit["phShift_UL"])
    np.testing.assert_allclose(mine["anchor"], mids, rtol=0, atol=1e-9)

    sec = np.zeros_like(x)
    for i, s in enumerate(segs):
        sec[i, : s.size] = (s - (s[0] + s[-1]) / 2) * 86400.0
    f_mid = spin_frequency_host(prog_timing.resolve(PAR), mids)[0]
    h_prog = search.h_power_segments(sec, m, f_mid, nharm=5, device="cpu").numpy()
    h_mine = ref.htest(par, segs, mine["anchor"], 5, "cpu")
    assert np.max(np.abs(h_mine - h_prog) / (h_mine + 10)) < 1e-5

    table = toas_to_tim_table(mids, fit["phShift"], fit["phShift_LL"], fit["phShift_UL"], PAR)
    toa = ref.tim_toas(par, mine["anchor"], fit["phShift"])
    assert np.max(np.abs(toa - table["TOA"])) * 86400e6 < 2.0


def test_lower_precision_moves_the_fit():
    par, tpl, iv, t = small_events(per=10000)
    segs = ref.segments(t, iv["ToA_tstart"], iv["ToA_tend"])
    hi = ref.fit_intervals(par, tpl, segs, iv["ToA_exposure"], 1000, "cpu")
    lo = ref.fit_intervals(par, tpl, segs, iv["ToA_exposure"], 1000, "cpu", dtype=torch.float32)
    assert np.max(np.abs(hi["phShift"] - lo["phShift"])) > 1e-4
    assert math.isfinite(float(np.max(lo["phShift"])))


def test_interval_counts_keep_the_column_or_scale_it_exactly():
    column = np.array([10000.0, 5136.0, 14897.0])
    assert events.interval_counts(column).tolist() == [10000, 5136, 14897]
    scaled = events.interval_counts(column, 300000)
    assert scaled.sum() == 300000
    assert np.all(np.abs(scaled - column * 300000 / column.sum()) < 1)


def test_refit_loglik_is_the_ports_extended_loglik():
    from crimp_tpu_torch.io import template as template_io
    from crimp_tpu_torch.models import profiles
    from crimp_tpu_torch.ops import toafit as port_toafit

    from portbench.reference import general

    par, tpl, iv, t = small_events(n_int=2, per=4000)
    segs = ref.segments(t, iv["ToA_tstart"], iv["ToA_tend"])
    x = torch.as_tensor(np.stack([timing.folded(par, s) for s in segs]))
    mask = torch.ones(x.shape, dtype=torch.bool)
    mask[1, -100:] = False
    T = torch.as_tensor(iv["ToA_exposure"])
    rng = np.random.default_rng(3)
    theta = general.template_vector(tpl, np.array([15.0, 19.0]))
    theta[:, 1:13] += rng.normal(0, 0.05, (2, 12))
    theta[:, -1] = [1.0, 1.1]
    phi = torch.tensor([0.3, -1.2], dtype=torch.float64)
    got = general.loglik(x, mask, T, phi, torch.as_tensor(theta))
    _, port_tpl = profiles.from_template(template_io.read_template(TEMPLATE))
    for r in range(2):
        params = port_toafit._unflatten_tpl(torch.as_tensor(theta[r]), port_tpl).replace(ph_shift=phi[r])
        want = profiles.extended_loglik("fourier", params, x[r], T[r], mask[r])
        assert float(got[r]) == pytest.approx(float(want), rel=1e-13, abs=1e-8)


def test_fixed_fit_reported_as_a_refit_is_its_own_likelihood():
    from portbench.reference import general

    par, tpl, iv, t = small_events(n_int=2, per=4000)
    segs = ref.segments(t, iv["ToA_tstart"], iv["ToA_tend"])
    x = torch.as_tensor(np.stack([timing.folded(par, s) for s in segs]))
    mask = torch.ones(x.shape, dtype=torch.bool)
    T = torch.as_tensor(iv["ToA_exposure"])
    out = general.control_fit(tpl, x, mask, T, 1000, dtype=torch.float64)
    ll = general.loglik(x, mask, T, torch.as_tensor(out["phShift"]), torch.as_tensor(out["theta"]))
    assert np.max(np.abs(ll.numpy() - out["logLmax"])) < 1e-8
