"""The port's spans as ranges of the torch.profiler timeline.

- one small north-star pass under the profiler emits every layer and step
  span of ``obs/names.py`` (the K5 sites and ``sweep_events`` by routing
  the fit's two K5 entries to their twins, as on the card);
- each step lies inside its layer span, each layer inside the pass, and
  the torch operations a step runs lie inside the step's range: the
  ranges share the profiler's clock;
- with neither a profiler nor an obs run, a span is the shared NULL_SPAN
  and no range is entered; while the profiler records, a span never
  synchronizes the card, with or without a run; an obs run records the
  layer spans and kernel sites, not the steps;
- every name is listed in the observability guide.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crimp_tpu_torch import obs
from crimp_tpu_torch.obs import core, costmodel
from crimp_tpu_torch.obs import names as spans
from crimp_tpu_torch.ops import toafit
from crimp_tpu_torch.utils import profiling, surrogate

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data"
PAR, TEMPLATE = str(DATA / "1e2259.par"), str(DATA / "1e2259_template.txt")
INTERVALS = str(DATA / "timIntToAs_1e2259.txt")
DOC = pathlib.Path(__file__).resolve().parents[1] / "crimp_tpu_torch" / "docs" / "observability.md"


@pytest.fixture(autouse=True)
def _no_run(monkeypatch):
    monkeypatch.delenv("CRIMP_TORCH_OBS", raising=False)


@pytest.fixture(scope="module")
def campaign():
    """Six intervals of ~200 events each from the bundled campaign."""
    times, intervals = surrogate.build_surrogate(PAR, INTERVALS, TEMPLATE, events_per_toa=200, seed=7)
    intervals = {k: v[:6] for k, v in intervals.items()}
    return times[times <= intervals["ToA_tend"][5]], intervals


@pytest.fixture
def k5_entries_on_twins(monkeypatch):
    """The fit's route on the card (sweep_events, one launch a sweep, one
    golden refine) with each K5 launch computed by its twin."""
    monkeypatch.setattr(toafit, "_on_card", lambda x: True)
    monkeypatch.setattr(toafit, "_launch_profile", lambda kind, tpl, x, mask, exposure, phis, cfg, events=None:
                        toafit.profile_sweep_reference(kind, tpl, x, mask, exposure, phis, cfg))
    monkeypatch.setattr(toafit, "_launch_golden", lambda kind, tpl, x, mask, exposure, lo, hi, cfg, events=None:
                        toafit.golden_refine_reference(kind, tpl, x, mask, exposure, lo, hi, cfg))


def north_star(campaign):
    times, intervals = campaign
    return surrogate.north_star(PAR, TEMPLATE, times, intervals, n_freq=64, n_fdot=3, device="cpu")


def profiled_pass(campaign):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = north_star(campaign)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return out, events


def _names(events):
    return {name for name, _, _ in events}


def _names_list(events):
    return [name for name, _, _ in events]


def _within(child, parents):
    return any(a <= child[1] and child[2] <= b for _, a, b in parents)


NAMES = [v for k, v in vars(spans).items() if k.isupper() and isinstance(v, str)]

# where each span and kernel site of a pass sits: its parent's name
PARENT = {spans.PASS_PREP: spans.PASS, spans.SCAN: spans.PASS, spans.FOLD_SLICE: spans.PASS,
          spans.FOLD: spans.PASS, spans.FOLD_PAD: spans.PASS, spans.FIT: spans.PASS,
          spans.FIT_TO_HOST: spans.PASS, spans.HTEST: spans.PASS, spans.TIM: spans.PASS,
          spans.SCAN_PLAN: spans.SCAN, spans.SCAN_TO_CARD: spans.SCAN, "grid_sums_2d": spans.SCAN,
          spans.SCAN_ROWS: spans.SCAN, spans.FOLD_ANCHORS: spans.FOLD, spans.FOLD_TO_CARD: spans.FOLD,
          "anchored_fold": spans.FOLD, spans.FOLD_TO_HOST: spans.FOLD, spans.FIT_TO_CARD: spans.FIT,
          spans.FIT_EVENTS: spans.FIT, "toa_sweep_brute": spans.FIT, "toa_sweep_refine": spans.FIT,
          spans.FIT_ERROR_SCAN: spans.FIT, "toa_sweep_err_dense": spans.FIT_ERROR_SCAN, spans.FIT_CHI2: spans.FIT,
          spans.HTEST_ROWS: spans.HTEST, spans.HTEST_SUMS: spans.HTEST, spans.TIM_ROTATION: spans.TIM,
          spans.TIM_TABLE: spans.TIM, spans.TIM_WRITE: spans.TIM}


class TestPassRanges:
    def test_every_layer_and_step_is_a_range(self, campaign, k5_entries_on_twins):
        north_star(campaign)  # warm-up
        _, events = profiled_pass(campaign)
        names = _names(events)
        # every name but fit_toas_batch_auto's plan, which north_star does not call
        assert set(NAMES) - {spans.FIT_PLAN} <= names
        assert set(PARENT) <= names
        assert _names_list(events).count(spans.PASS) == 1

    def test_children_lie_inside_their_parents(self, campaign, k5_entries_on_twins):
        _, events = profiled_pass(campaign)
        by_name = {}
        for ev in events:
            by_name.setdefault(ev[0], []).append(ev)
        for child, parent in PARENT.items():
            for ev in by_name[child]:
                assert _within(ev, by_name[parent]), (child, parent)

    def test_the_torch_work_of_a_step_lies_inside_its_range(self, campaign, k5_entries_on_twins):
        _, events = profiled_pass(campaign)
        ops = [ev for ev in events if ev[0].startswith("aten::")]
        for step in ("grid_sums_2d", "anchored_fold", spans.FIT_TO_CARD, spans.FIT_EVENTS, "toa_sweep_brute",
                     spans.HTEST_SUMS, spans.SCAN_TO_CARD):
            ranges = [ev for ev in events if ev[0] == step]
            assert any(_within(op, ranges) for op in ops), step
        # and every torch operation of the pass inside the pass's range
        pass_range = [ev for ev in events if ev[0] == spans.PASS]
        assert all(_within(op, pass_range) for op in ops)

    def test_outputs_are_the_same_traced_or_not(self, campaign):
        plain = north_star(campaign)
        traced, _ = profiled_pass(campaign)
        np.testing.assert_array_equal(plain["rows"], traced["rows"])
        for key in plain["fit"]:
            np.testing.assert_array_equal(plain["fit"][key], traced["fit"][key])


class TestCost:
    def test_no_profiler_no_run_enters_no_range(self, campaign, monkeypatch):
        entered = []
        real = core._record_function

        def counting(name):
            entered.append(name)
            return real(name)

        monkeypatch.setattr(core, "_record_function", counting)
        assert obs.span("crimp.x") is obs.NULL_SPAN
        assert obs.profiler_range("crimp.x") is obs.NULL_SPAN
        with obs.span("crimp.x"), costmodel.kernel_span("toa_sweep_x"), profiling.timed("toa_sweep_y"):
            pass
        north_star(campaign)
        assert entered == []
        # the same hook is what a profiled pass enters
        with profile(activities=[ProfilerActivity.CPU]):
            north_star(campaign)
        assert spans.PASS in entered and "grid_sums_2d" in entered and spans.FIT_ERROR_SCAN in entered

    def test_profiler_on_never_synchronizes(self, campaign, monkeypatch, tmp_path):
        def refuse():
            raise AssertionError("a span synchronized while the profiler recorded")

        monkeypatch.setattr(core, "_sync", refuse)
        with profile(activities=[ProfilerActivity.CPU]):
            north_star(campaign)
            with obs.span("crimp.x") as s:
                assert s is not obs.NULL_SPAN and s.set(a=1) is s
        # inside an obs run too: the run's spans record, without synchronizing
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.run("ranges"):
                north_star(campaign)
        with open(obs.last_manifest_path()) as fh:
            names = {s["name"] for s in json.load(fh)["spans"]}
        # layer spans and kernel sites are the run's spans, steps are ranges alone
        assert {spans.PASS, spans.SCAN, spans.FOLD, spans.FIT, spans.HTEST, spans.TIM, "grid_sums_2d"} <= names
        assert not names & {spans.FOLD_ANCHORS, spans.SCAN_PLAN, spans.FIT_ERROR_SCAN}
        assert spans.PASS in {e.name() for e in prof.profiler.kineto_results.events()}
        # and without the profiler the run's spans synchronize as before
        calls = []
        monkeypatch.setattr(core, "_sync", lambda: calls.append(1))
        with obs.run("synced"):
            with obs.span("crimp.x"):
                pass
        assert len(calls) == 2


def test_every_name_is_in_the_guide():
    text = DOC.read_text()
    for name in NAMES + list(PARENT):
        assert f"`{name}`" in text, name
