"""The port's survey pipeline (crimp_tpu_torch.pipelines.survey) against its
own per-source loop and against crimp_tpu.pipelines.survey.

- under exact padding (equal per-interval event counts) the batched survey
  is the per-source ``measure_source_toas`` loop, glitching source
  included, within survey.py's parity contract: every column bit for bit
  but the fit's and the H-test's, those to the rounding of their event
  sums (phShift 1e-6 rad, LL/UL one profile step, Hpower rtol 1e-5,
  redChi2 rtol 1e-6); a batch of one likewise;
- against crimp_tpu's ``survey_measure_toas`` on the same pulsed sources
  (10^4 events an interval, phShiftRes 200): the tolerances of
  tests/test_torch_measure_toas.py (phShift 1e-6 rad, LL/UL within one
  profile step, Hpower rtol 1e-4, redChi2 rtol 1e-6), the rest exact;
- a bad source (an empty interval) is isolated with a classified error;
  an empty source yields an empty table; the CRIMP_TORCH_MULTISOURCE=0
  knob routes every source to the loop; CRIMP_TORCH_MULTISOURCE_MAX_PAD
  tightens the buckets, as crimp_tpu's knobs do there;
- ``utils/reduce_probe.tree_sum``, the fixed-order sum the port measured
  and did not adopt, is row-independent and torch.sum's to rounding.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from crimp_tpu.pipelines import survey as jax_survey
from crimp_tpu_torch.pipelines import survey

torch.set_num_threads(2)

TPL = {"model": "fourier", "nbrComp": 2, "norm": 1.0, "amp_1": 0.3, "amp_2": 0.1, "ph_1": 0.2, "ph_2": 0.05}
RES = 200


@pytest.fixture(autouse=True)
def _quiet_knobs(monkeypatch):
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE", "0")
    for name in ("CRIMP_TORCH_MULTISOURCE", "CRIMP_TORCH_MULTISOURCE_MAX_PAD", "CRIMP_TORCH_MULTISOURCE_BATCH",
                 "CRIMP_TORCH_FAULTS", "CRIMP_TORCH_DELTA_FOLD"):
        monkeypatch.delenv(name, raising=False)


def timing_dict(i: int, glitch: bool = False) -> dict:
    tm = {"PEPOCH": 58000.0, "F0": 0.14 + 0.003 * (i % 53), "F1": -1e-13}
    if glitch:
        tm.update({"GLEP_1": 58003.0, "GLF0_1": 1e-7, "GLPH_1": 0.1, "GLF0D_1": 5e-8, "GLTD_1": 2.0})
    return tm


def make_spec(i, rng, n_per=None, n_ev=240, n_int=2, glitch=False, name=None, pulsed=False):
    """tests/test_multisource.py's synthetic source: ``n_per`` pins the
    per-interval event count (exact padding), ``n_ev`` scatters events
    freely; ``pulsed`` draws them from a 60% pulse at the model's F0."""
    edges = np.linspace(58000.0, 58008.0, n_int + 1)
    tm = timing_dict(i, glitch=glitch)
    if n_per is not None:
        chunks = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            t = rng.uniform(lo + 1e-6, hi - 1e-6, (8 if pulsed else 1) * n_per)
            if pulsed:
                ph = tm["F0"] * (t - 58000.0) * 86400.0
                t = t[rng.uniform(0, 1.6, t.size) < 1 + 0.6 * np.cos(2 * np.pi * ph + 0.3)]
            chunks.append(t[:n_per])
        times = np.sort(np.concatenate(chunks))
    else:
        times = np.sort(rng.uniform(58000.0, 58008.0, n_ev))
    iv = {"ToA_tstart": edges[:-1], "ToA_tend": edges[1:],
          "ToA_exposure": np.full(n_int, (edges[1] - edges[0]) * 86400.0)}
    return survey.SourceSpec(name=name or f"src{i}", times=times, timing_model=tm, template=dict(TPL),
                             intervals=iv)


def as_jax(spec: survey.SourceSpec) -> jax_survey.SourceSpec:
    return jax_survey.SourceSpec(name=spec.name, times=spec.times, timing_model=spec.timing_model,
                                 template=dict(spec.template), intervals=pd.DataFrame(spec.intervals))


FIT_COLUMNS = ("phShift", "phShift_LL", "phShift_UL", "Hpower", "redChi2")


def assert_matches_loop(frame, solo, ctx="", res=RES):
    """survey.py's parity contract against the per-source loop: every column
    but the fit's and the H-test's bit for bit, those to the rounding of
    their event sums."""
    assert list(frame) == survey.SURVEY_TOA_COLUMNS
    for col in survey.SURVEY_TOA_COLUMNS:
        if col not in FIT_COLUMNS:
            assert np.array_equal(frame[col], solo[col]), (ctx, col, frame[col], solo[col])
    np.testing.assert_allclose(frame["phShift"], solo["phShift"], rtol=0, atol=1e-6, err_msg=ctx)
    for col in ("phShift_LL", "phShift_UL"):
        assert np.max(np.abs(frame[col] - solo[col]), initial=0.0) <= 2 * np.pi / res * (1 + 1e-9), (ctx, col)
    np.testing.assert_allclose(frame["Hpower"], solo["Hpower"], rtol=1e-5, err_msg=ctx)
    np.testing.assert_allclose(frame["redChi2"], solo["redChi2"], rtol=1e-6, err_msg=ctx)


def loop(specs):
    return [survey.measure_source_toas(s, phShiftRes=RES, device="cpu") for s in specs]


class TestAgainstTheLoop:
    def test_exact_padding_matches_the_loop(self):
        rng = np.random.RandomState(21)
        specs = [make_spec(i, rng, n_per=70, glitch=(i == 1)) for i in range(6)]
        frames = survey.survey_measure_toas(specs, phShiftRes=RES, device="cpu")
        info = survey.last_survey_info()
        assert info["n_batched"] == 6 and info["bucket_count"] == 1 and info["occupancy_pct"] == 100.0
        for spec, frame, solo in zip(specs, frames, loop(specs)):
            assert_matches_loop(frame, solo, spec.name)

    def test_batch_of_one(self):
        rng = np.random.RandomState(23)
        spec = make_spec(0, rng, n_ev=150, n_int=3)
        frames = survey.survey_measure_toas([spec], phShiftRes=RES, device="cpu")
        assert survey.last_survey_info()["n_batched"] == 1
        assert_matches_loop(frames[0], loop([spec])[0], spec.name)

    def test_bad_source_isolated(self):
        rng = np.random.RandomState(22)
        specs = [make_spec(i, rng, n_per=50) for i in range(5)]
        bad = make_spec(999, rng, n_ev=40, name="badsrc")
        bad.times = bad.times[bad.times < 58004.0]  # last interval empty
        specs.insert(3, bad)
        frames = survey.survey_measure_toas(specs, phShiftRes=RES, device="cpu")
        info = survey.last_survey_info()
        assert frames[3] is None
        assert info["errors"]["badsrc"]["kind"] == "data_error"
        assert info["errors"]["badsrc"]["type"] == "ValueError"
        assert info["demoted"]["badsrc"].startswith("prep: data_error: ValueError")
        assert info["n_batched"] == 5 and info["n_failed"] == 1 and info["n_fallback"] == 1
        good = [s for s in specs if s is not bad]
        for spec, frame, solo in zip(good, [f for f in frames if f is not None], loop(good)):
            assert_matches_loop(frame, solo, spec.name)
        jax_frames = jax_survey.survey_measure_toas([as_jax(s) for s in specs], phShiftRes=RES)
        jax_info = jax_survey.last_survey_info()
        assert jax_frames[3] is None
        assert jax_info["errors"]["badsrc"] == info["errors"]["badsrc"]
        for key in ("n_batched", "n_failed", "n_fallback", "bucket_count", "bucket_splits", "occupancy_pct"):
            assert info[key] == jax_info[key], key

    def test_empty_source_yields_empty_table(self):
        rng = np.random.RandomState(24)
        empty = survey.SourceSpec(name="empty", times=np.array([58001.0, 58002.0]), timing_model=timing_dict(0),
                                  template=dict(TPL),
                                  intervals={"ToA_tstart": np.zeros(0), "ToA_tend": np.zeros(0),
                                             "ToA_exposure": np.zeros(0)})
        frames = survey.survey_measure_toas([empty, make_spec(1, rng)], phShiftRes=RES, device="cpu")
        assert list(frames[0]) == survey.SURVEY_TOA_COLUMNS
        assert all(len(v) == 0 for v in frames[0].values())
        assert len(frames[1]["ToA"]) > 0
        assert survey.last_survey_info()["n_failed"] == 0

    def test_knob_off_routes_everything_to_the_loop(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_MULTISOURCE", "0")
        monkeypatch.setenv("CRIMP_TPU_MULTISOURCE", "1")  # the other package's knob steers nothing here
        rng = np.random.RandomState(25)
        specs = [make_spec(i, rng, n_ev=100) for i in range(3)]
        frames = survey.survey_measure_toas(specs, phShiftRes=RES, device="cpu")
        info = survey.last_survey_info()
        assert info["n_batched"] == 0 and info["n_fallback"] == 3 and info["bucket_count"] == 0
        assert all(info["demoted"][s.name] == "knob: multisource off" for s in specs)
        monkeypatch.delenv("CRIMP_TORCH_MULTISOURCE")
        for spec, frame, solo in zip(specs, frames, loop(specs)):
            assert_matches_loop(frame, solo, spec.name)

    def test_max_pad_env_tightens_buckets(self, monkeypatch):
        rng = np.random.RandomState(26)
        # caps 64 and 128 merge under the default 4.0 ratio and split under 1.0
        specs = [make_spec(i, rng, n_per=n) for i, n in enumerate([40, 40, 100, 100])]
        survey.survey_measure_toas(specs, phShiftRes=RES, device="cpu")
        merged = survey.last_survey_info()["bucket_count"]
        monkeypatch.setenv("CRIMP_TORCH_MULTISOURCE_MAX_PAD", "1.0")
        frames = survey.survey_measure_toas(specs, phShiftRes=RES, device="cpu")
        info = survey.last_survey_info()
        assert info["bucket_count"] > merged and info["n_batched"] == 4
        assert info["occupancy_pct"] == 100.0
        # one width per bucket: exact padding again
        for spec, frame, solo in zip(specs, frames, loop(specs)):
            assert_matches_loop(frame, solo, spec.name)
        monkeypatch.setenv("CRIMP_TORCH_MULTISOURCE_BATCH", "1")
        survey.survey_measure_toas(specs, phShiftRes=RES, device="cpu")
        assert survey.last_survey_info()["bucket_count"] == 4


class TestEventSum:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_the_fixed_order_candidate_is_row_independent(self, dtype):
        """utils/reduce_probe.tree_sum, the fixed-order event sum chip_smoke.py
        swaps in for ops/reduce.event_sum to time it: each row's bits are
        those of the row reduced alone, and the sum is torch.sum's to the
        rounding of the dtype."""
        from crimp_tpu_torch.ops import reduce
        from crimp_tpu_torch.utils.reduce_probe import tree_sum

        gen = torch.Generator().manual_seed(4)
        x = torch.rand(16, 8, 20000, generator=gen, dtype=torch.float64).to(dtype)
        whole = tree_sum(x)
        for rows in (1, 3, 16):
            assert torch.equal(tree_sum(x[:rows].contiguous()), whole[:rows])
        eps = torch.finfo(dtype).eps
        torch.testing.assert_close(whole, reduce.event_sum(x), rtol=64 * eps, atol=0.0)
        assert tree_sum(x[..., :0]).shape == (16, 8)


class TestAgainstJax:
    def test_pulsed_sources_within_measure_toas_tolerances(self):
        rng = np.random.RandomState(27)
        specs = [make_spec(i, rng, n_per=10000, pulsed=True, glitch=(i == 2)) for i in range(3)]
        got = survey.survey_measure_toas(specs, phShiftRes=RES, device="cpu")
        info = survey.last_survey_info()
        want = jax_survey.survey_measure_toas([as_jax(s) for s in specs], phShiftRes=RES)
        jax_info = jax_survey.last_survey_info()
        for key in ("n_batched", "bucket_count", "occupancy_pct", "demoted", "errors"):
            assert info[key] == jax_info[key], key
        step = 2 * np.pi / RES
        for spec, g, w in zip(specs, got, want):
            assert list(g) == list(w.columns)
            for col in ("ToA", "ToA_start", "ToA_end", "ToA_lenInt", "ToA_exp", "nbr_events", "count_rate"):
                np.testing.assert_array_equal(g[col], w[col].to_numpy(), err_msg=col)
            np.testing.assert_allclose(g["ToA_mid"], w["ToA_mid"].to_numpy(), rtol=1e-13)
            np.testing.assert_allclose(g["phShift"], w["phShift"].to_numpy(), rtol=0, atol=1e-6)
            for col in ("phShift_LL", "phShift_UL"):
                assert np.max(np.abs(g[col] - w[col].to_numpy())) <= step * (1 + 1e-9), col
            np.testing.assert_allclose(g["Hpower"], w["Hpower"].to_numpy(), rtol=1e-4)
            np.testing.assert_allclose(g["redChi2"], w["redChi2"].to_numpy(), rtol=1e-6)
            assert np.all(g["Hpower"] > 100)
