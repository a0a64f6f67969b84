"""The readvaryparam fit's row groups (``ops/general_sweep.py::plan_row_groups``,
``ops/toafit.py::_general_chains``), on the CPU:

- the plan: rows longest first, ties in row order; consecutive groups of
  near-equal size; one group for fewer than two rows or one group allowed;
  G a function of the row counts and the SM count alone; the 1E 2259+586
  campaign's 84 rows at an H100's 132 SMs take two groups or more; the
  model's one-group time on those rows is the launches' 230 + 235 + 127
  ms it was calibrated to;
- every returned column of a fit in explicit row groups (sorted, permuted,
  one row alone) is the one-group fit's bit for bit, on the twin, rows of
  different lengths, some taking the error scan's fallback loop and one
  not, the columns back in the batch's row order;
- each group's chain is one ``crimp.fit.group`` range inside ``crimp.fit``;
  an obs run counts the groups (``toa_general_groups``);
- the fixed-template fit never plans row groups, and a fit off a CUDA
  device runs in one group;
- the smoke counts a chain of K6 launches and a refine a planned group;
- K6's operand pack takes its box from one copy a (box, device), with the
  values the host's ``bounded_transform`` gives, and threads that ask for
  a new box at once all get the one kept; past ``BOX_CAP`` boxes a box is
  made a call and none is kept.
"""

import pathlib
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crimp_tpu_torch import obs
from crimp_tpu_torch.models import profiles
from crimp_tpu_torch.obs import names as spans
from crimp_tpu_torch.ops import general_sweep, optimize, toafit
from tests.test_torch_general_sweep import _draws, _leaves, _port_tpl, _spec

torch.set_num_threads(2)

TABLE = pathlib.Path(__file__).parent / "data" / "timIntToAs_1e2259.txt"
LENGTHS = (300, 120, 260, 40, 300, 180)  # masked events a row: rows of different lengths, one tie


def _campaign_counts() -> np.ndarray:
    lines = TABLE.read_text().splitlines()
    col = lines[0].split().index("Events")
    return np.array([int(float(line.split()[col])) for line in lines[1:]])


class TestPlan:
    def test_rows_come_longest_first_ties_in_row_order(self):
        counts = _campaign_counts()
        groups = general_sweep.plan_row_groups(counts, 132)
        order = np.concatenate(groups)
        assert order.tolist() == np.argsort(-counts, kind="stable").tolist()
        # the ties (most rows hold 10 000 events) keep their row order
        tied = order[counts[order] == 10000]
        assert tied.tolist() == sorted(tied.tolist())

    @pytest.mark.parametrize("sms", [66, 132, 264])
    def test_groups_are_consecutive_and_near_equal(self, sms):
        counts = _campaign_counts()
        groups = general_sweep.plan_row_groups(counts, sms)
        sizes = [len(g) for g in groups]
        assert max(sizes) - min(sizes) <= 1 and sum(sizes) == counts.size
        if len(groups) > 1:
            ranked = counts[np.concatenate(groups)]
            assert all(ranked[i] >= ranked[i + 1] for i in range(len(ranked) - 1))

    @pytest.mark.parametrize("counts", [[], [14897]], ids=["no row", "one row"])
    def test_one_group_below_two_rows(self, counts):
        groups = general_sweep.plan_row_groups(counts, 132)
        assert len(groups) == 1 and groups[0].tolist() == list(range(len(counts)))

    def test_one_group_allowed_keeps_the_batch_order(self):
        counts = _campaign_counts()
        groups = general_sweep.plan_row_groups(counts, 132, max_groups=1)
        assert len(groups) == 1 and groups[0].tolist() == list(range(counts.size))

    def test_g_depends_on_the_counts_and_sms_alone(self):
        counts = _campaign_counts()
        perm = np.random.RandomState(3).permutation(counts.size)
        for sms in (66, 132):
            first = general_sweep.plan_row_groups(counts, sms)
            again = general_sweep.plan_row_groups(counts.copy(), sms)
            shuffled = general_sweep.plan_row_groups(counts[perm], sms)
            assert [g.tolist() for g in first] == [g.tolist() for g in again]
            assert len(shuffled) == len(first)
            assert [sorted(counts[perm][g].tolist()) for g in shuffled] == [sorted(counts[g].tolist()) for g in first]

    def test_the_campaign_rows_take_two_groups_or_more(self):
        groups = general_sweep.plan_row_groups(_campaign_counts(), 132)
        assert 2 <= len(groups) <= general_sweep.MAX_ROW_GROUPS

    def test_the_model_is_the_calibration_on_the_campaign_rows(self):
        counts = _campaign_counts().tolist()
        assert general_sweep.schedule_ms([counts], 132) == pytest.approx(230 + 235 + 127, abs=0.05)
        order = np.argsort(-np.asarray(counts), kind="stable")
        halves = [[counts[r] for r in part] for part in np.array_split(order, 2)]
        by_index = [counts[:42], counts[42:]]
        # the gain needs the longest rows' refine beside the other rows' sweeps
        assert general_sweep.schedule_ms(halves, 132) < 0.9 * general_sweep.schedule_ms(by_index, 132)


def _fit_args(kind=profiles.FOURIER):
    """Six rows of the family's two-component template, LENGTHS events
    each, every parameter free; a coarse error scan whose dense window
    leaves some rows to the fallback loop."""
    x, mask, _ = _draws(kind, n_rows=len(LENGTHS), n=max(LENGTHS), seed=3)
    for r, n in enumerate(LENGTHS):
        mask[r, n:] = False
        x[r, n:] = 0.0
    exposure = mask.sum(1) / 10.0
    idx, lo, hi = _spec(kind)
    cfg = toafit.ToAFitConfig(kind=kind, ph_shift_res=100, n_brute=8, nm_iters=10, refine_iters=3,
                              err_dense_window=8, err_chunk=4, free_idx=idx, free_lo=lo, free_hi=hi,
                              n_free=len(idx))
    return (kind, _port_tpl(_leaves(kind)), torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(exposure),
            cfg)


def _planned(monkeypatch, plan):
    monkeypatch.setattr(toafit, "_row_groups", lambda x, mask, cfg, row_events=None: [np.asarray(g) for g in plan])


PLANS = {
    "sorted": [[0, 4, 2], [5, 1, 3]],
    "permuted": [[3], [1, 5], [4, 0, 2]],
    "four": [[2, 5], [0], [3, 1], [4]],
}


class TestSameBits:
    @pytest.fixture(scope="class")
    def one_group(self):
        with torch.no_grad():
            return toafit.fit_segment(*_fit_args())

    def test_the_fit_takes_the_loop_on_some_rows(self, one_group):
        iters = one_group["errScanLoopIters"]
        assert bool((iters > 0).any()) and bool((iters == 0).any())

    @pytest.mark.parametrize("plan", list(PLANS.values()), ids=list(PLANS))
    def test_every_column_is_the_one_group_fit(self, monkeypatch, one_group, plan):
        _planned(monkeypatch, plan)
        with torch.no_grad():
            got = toafit.fit_segment(*_fit_args())
        assert set(got) == set(one_group)
        for key, want in one_group.items():
            assert got[key].dtype == want.dtype and got[key].shape == want.shape, key
            assert torch.equal(torch.isnan(got[key]), torch.isnan(want)), key
            assert torch.equal(torch.nan_to_num(got[key]), torch.nan_to_num(want)), key

    def test_rows_return_in_the_batch_order(self, monkeypatch, one_group):
        """A group's columns are its rows' own: row r of the grouped fit is
        the one-group fit's row r, not the r-th row of the group order."""
        _planned(monkeypatch, PLANS["permuted"])
        with torch.no_grad():
            got = toafit.fit_segment(*_fit_args())
        order = np.concatenate(PLANS["permuted"])
        assert not torch.equal(got["logLmax"][order], one_group["logLmax"])
        assert torch.equal(got["logLmax"], one_group["logLmax"])


class TestRanges:
    def test_one_range_a_group_inside_the_fit(self, monkeypatch):
        _planned(monkeypatch, PLANS["sorted"])
        kind, tpl, x, mask, exposure, cfg = _fit_args()
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
            toafit.fit_toas_batch(kind, tpl, x.numpy(), mask.numpy(), exposure.numpy(), cfg, device="cpu")
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()]
        groups = [ev for ev in events if ev[0] == spans.FIT_GROUP]
        fits = [ev for ev in events if ev[0] == spans.FIT]
        assert len(groups) == 2
        assert all(any(a <= g[1] and g[2] <= b for _, a, b in fits) for g in groups)
        # the error scan's fallback loop runs after every group's chain
        scans = [ev for ev in events if ev[0] == spans.FIT_ERROR_SCAN]
        assert len(scans) == 1 and scans[0][1] >= max(g[2] for g in groups)

    @pytest.mark.parametrize("plan", [None, PLANS["sorted"], PLANS["four"]], ids=["one", "two", "four"])
    def test_an_obs_run_counts_the_groups(self, monkeypatch, tmp_path, plan):
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        monkeypatch.setenv("CRIMP_TORCH_OBS_EVENTS", "0")
        if plan is not None:
            _planned(monkeypatch, plan)
        kind, tpl, x, mask, exposure, cfg = _fit_args()
        with obs.run("row_groups") as rec, torch.no_grad():
            toafit.fit_segment(kind, tpl, x, mask, exposure, cfg)
            assert rec.counters["toa_general_groups"] == (1 if plan is None else len(plan))


class TestRouting:
    def test_the_fixed_template_fit_plans_no_groups(self, monkeypatch):
        def refuse(*args, **kwargs):
            raise AssertionError("a fixed-template fit planned row groups")

        monkeypatch.setattr(toafit, "_row_groups", refuse)
        monkeypatch.setattr(toafit, "_general_chains", refuse)
        kind, tpl, x, mask, exposure, _ = _fit_args()
        with torch.no_grad():
            out = toafit.fit_segment(kind, tpl, x, mask, exposure, toafit.ToAFitConfig(kind=kind, n_brute=8))
        assert out["phShift"].shape == (len(LENGTHS),)

    def test_off_a_cuda_device_one_group(self):
        kind, tpl, x, mask, exposure, cfg = _fit_args()
        assert toafit._row_groups(x, mask, cfg) is None
        assert toafit._row_groups(x, mask, cfg, row_events=np.asarray(LENGTHS)) is None


class TestPackBox:
    def test_one_copy_a_box_and_device_with_the_host_values(self):
        kind = profiles.FOURIER
        idx, lo, hi = _spec(kind)
        cfg = toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=hi)
        tpl = _port_tpl(_leaves(kind))
        first, again = general_sweep.pack(tpl, cfg, 2), general_sweep.pack(tpl, cfg, 3)
        for key in ("free_idx", "idx", "lo", "span"):
            assert first[key] is again[key], key
        tf = optimize.bounded_transform(lo, hi)
        assert torch.equal(first["lo"], tf.lo) and torch.equal(first["span"], tf.hi - tf.lo)
        start = general_sweep.flatten_template(tpl).expand(3, -1)
        assert torch.equal(again["u0"], tf.to_unbounded(start[:, list(idx)]))
        other = general_sweep.pack(tpl, cfg._replace(free_hi=tuple(h + 1.0 for h in hi)), 2)
        assert other["span"] is not first["span"] and torch.equal(other["span"], first["span"] + 1.0)

    def test_past_the_cap_a_box_is_made_a_call_and_not_kept(self, monkeypatch):
        kind = profiles.FOURIER
        idx, lo, hi = _spec(kind)
        monkeypatch.setattr(general_sweep, "BOX_CAP", len(general_sweep._BOXES))
        kept = dict(general_sweep._BOXES)
        cfg = toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=tuple(h + 7.25 for h in hi))
        first, again = general_sweep._box(cfg, "cpu"), general_sweep._box(cfg, "cpu")
        assert first is not again
        assert first["free_idx"].dtype == torch.int32 and first["free_idx"].tolist() == list(idx)
        for key in ("free_idx", "idx", "span"):
            assert torch.equal(first[key], again[key]), key
        assert general_sweep._BOXES.keys() == kept.keys()
        assert all(general_sweep._BOXES[k] is box for k, box in kept.items())

    def test_threads_asking_at_once_share_the_one_box_kept(self):
        kind = profiles.FOURIER
        idx, lo, hi = _spec(kind)
        # boxes no other test made: each thread races to make them
        cfgs = [toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=tuple(h + 0.5 + k for h in hi))
                for k in range(4)]
        seen = [[] for _ in range(16)]
        start = threading.Barrier(len(seen))

        def ask(slot):
            start.wait(timeout=30)
            order = np.random.RandomState(slot).permutation(len(cfgs))
            for _ in range(20):
                for k in order:
                    seen[slot].append((k, general_sweep._box(cfgs[k], "cpu")))

        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=ask, args=(slot,)) for slot in range(len(seen))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(switch)
        assert not any(t.is_alive() for t in threads)
        kept = [general_sweep._box(cfg, "cpu") for cfg in cfgs]
        assert all(box is kept[k] for got in seen for k, box in got)
        assert sum(len(got) for got in seen) == len(seen) * 20 * len(cfgs)


class TestSmokeCounts:
    def test_the_smoke_counts_a_chain_of_launches_a_planned_group(self, monkeypatch):
        import chip_smoke

        _planned(monkeypatch, PLANS["four"])
        kind, tpl, x, mask, exposure, cfg = _fit_args()
        planner = toafit._row_groups
        with chip_smoke.k6_row_plans(toafit) as plans, torch.no_grad():
            fit = {k: v.numpy() for k, v in toafit.fit_segment(kind, tpl, x, mask, exposure, cfg).items()}
        assert plans == [4]
        window, passes = chip_smoke.scan_launches(fit, cfg)
        assert window > 0 and passes > 0
        assert chip_smoke.rv_fit_launches(fit, cfg, 4) == 4 * 3 + passes
        assert chip_smoke.rv_fit_launches(fit, cfg) == 3 + passes
        assert toafit._row_groups is planner
