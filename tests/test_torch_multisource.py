"""The port's survey batch engine (crimp_tpu_torch.ops.multisource) against
itself and against crimp_tpu.ops.multisource on the same seeded inputs.

- ``stacked_fold`` through ``fold_sources``: bit for bit the port's
  single-source ``fold_segments`` for every source, with ragged glitch and
  wave rows padded inert, and within tests/test_torch_fold.py's
  PARITY_CYCLES of crimp_tpu's ``stacked_fold`` on the same stacked model;
- ``pad_anchored`` and ``inert_rows`` equal crimp_tpu's;
- ``bucket_sources`` equals crimp_tpu's on tests/test_multisource.py's
  cases, and the dispatch chunking equals crimp_tpu's;
- ``fit_sources`` with per-row templates (``fit_toas_batch_multi``) is
  each source's own fit to the rounding of its event sums (phShift 1e-6
  rad, LL/UL one profile step, norm 1e-9, redChi2 1e-6 and logLmax 1e-12
  relative), and within test_torch_measure_toas's tolerances of
  crimp_tpu's;
- ``h_power_sources`` within rtol 1e-4 of crimp_tpu's (f32 trig);
- ``sample_posterior_sources``: chunked runs bitwise the whole batch, and
  fed crimp_tpu's per-source draws, the posterior summaries within
  tests/test_torch_local_ephem.py's tolerances of crimp_tpu's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from crimp_tpu.ops import anchored as jax_anchored
from crimp_tpu.ops import multisource as jax_ms
from crimp_tpu.models import profiles as jax_profiles
from crimp_tpu.ops import toafit as jax_toafit
from crimp_tpu_torch.models import convert, profiles
from crimp_tpu_torch.ops import anchored, mcmc, multisource, toafit
from tests.test_torch_fold import PARITY_CYCLES
from tests.test_torch_mcmc import _jax_draws

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _quiet_knobs(monkeypatch):
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE", "0")


def timing_dict(i: int, glitch: bool = False, wave: bool = False) -> dict:
    tm = {"PEPOCH": 58000.0, "F0": 0.14 + 0.003 * (i % 53), "F1": -1e-13}
    if glitch:
        tm.update({"GLEP_1": 58003.0, "GLF0_1": 1e-7, "GLPH_1": 0.1, "GLF0D_1": 5e-8, "GLTD_1": 2.0})
    if wave:
        tm.update({"WAVEEPOCH": 58000.0, "WAVE_OM": 0.7, "WAVE1": {"A": 1e-4, "B": -2e-4},
                   "WAVE2": {"A": 5e-5, "B": 3e-5}})
    return tm


# tests/test_multisource.py's deliberately ragged model structure: 0/1/2
# glitches, 0/2 waves
RAGGED_TMS = [
    timing_dict(0),
    timing_dict(1, glitch=True),
    timing_dict(2, glitch=True, wave=True),
    {"PEPOCH": 58000.0, "F0": 0.2, "F1": -2e-13, "GLEP_1": 58002.0, "GLF0_1": 2e-7,
     "GLEP_2": 58005.0, "GLF0_2": -1e-7, "GLF1_2": 1e-15},
]


@pytest.fixture(scope="module")
def ragged_segments():
    rng = np.random.RandomState(11)
    return [[np.sort(rng.uniform(58000.0 + 2.0 * s, 58002.0 + 2.0 * s, n)) for s, n in enumerate(sizes)]
            for sizes in ([120, 40], [77], [300, 5, 64], [33, 200])]


def _wrap(d):
    return d - np.round(d)


class TestStackedFold:
    def test_bitwise_the_single_source_fold(self, ragged_segments):
        phase_lists, t_refs = multisource.fold_sources(RAGGED_TMS, ragged_segments, device="cpu")
        for i, (tm, segs) in enumerate(zip(RAGGED_TMS, ragged_segments)):
            ref_ph, ref_t = anchored.fold_segments(tm, segs, delta_fold=0, device="cpu")
            np.testing.assert_array_equal(t_refs[i], ref_t)
            for s, (got, want) in enumerate(zip(phase_lists[i], ref_ph)):
                assert np.array_equal(got, want), (i, s)

    def test_chunked_batches_are_bitwise(self, ragged_segments, monkeypatch):
        whole, _ = multisource.fold_sources(RAGGED_TMS, ragged_segments, device="cpu")
        monkeypatch.setattr(multisource, "_resolve_chunk", lambda n, w: 1)
        chunked, _ = multisource.fold_sources(RAGGED_TMS, ragged_segments, device="cpu")
        for a, b in zip(whole, chunked):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)

    def test_matches_jax_stacked_fold_on_the_same_model(self, ragged_segments):
        """crimp_tpu's stacked model, carried across field by field, folds
        in the port within PARITY_CYCLES of crimp_tpu's stacked_fold."""
        from crimp_tpu.models import timing as jax_timing

        ams, deltas, idxs = [], [], []
        for tm, segs in zip(RAGGED_TMS, ragged_segments):
            t_ref = np.asarray([(t[-1] - t[0]) / 2 + t[0] for t in segs])
            ams.append(jax_anchored.prepare_anchors(jax_timing.resolve(tm), t_ref))
            idx = np.repeat(np.arange(len(segs)), [t.size for t in segs])
            deltas.append(jax_anchored.anchor_deltas(np.concatenate(segs), t_ref, idx))
            idxs.append(idx)
        sm = jax_ms.stack_models(ams)
        width = max(d.size for d in deltas)
        delta = np.zeros((len(ams), width))
        idx = np.zeros((len(ams), width), dtype=np.int64)
        for r, (d, i) in enumerate(zip(deltas, idxs)):
            delta[r, :d.size], idx[r, :i.size] = d, i
        want = np.asarray(jax_ms.stacked_fold(sm, delta, idx))
        port_sm = convert.stacked_from_arrays({f.name: np.asarray(getattr(sm, f.name))
                                               for f in dataclasses.fields(sm)})
        got = multisource.stacked_fold(port_sm, torch.as_tensor(delta), torch.as_tensor(idx)).numpy()
        for r, d in enumerate(deltas):
            assert np.max(np.abs(_wrap(got[r, :d.size] - want[r, :d.size]))) < PARITY_CYCLES

    def test_pad_anchored_and_inert_rows_match_jax(self):
        from crimp_tpu.models import timing as jax_timing
        from crimp_tpu_torch.models import timing

        tm = RAGGED_TMS[2]
        t_ref = np.array([58001.0, 58004.5])
        want = jax_anchored.pad_anchored(jax_anchored.prepare_anchors(jax_timing.resolve(tm), t_ref), 4, 3, 5)
        got = anchored.pad_anchored(anchored.prepare_anchors(timing.resolve(tm), t_ref), 4, 3, 5)
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)),
                                          err_msg=f.name)
        with pytest.raises(ValueError, match="shrink"):
            anchored.pad_anchored(got, 1, 3, 5)
        jax_inert = jax_ms.inert_rows(jax_ms.stack_models([want]), 2)
        inert = multisource.inert_rows(multisource.stack_models([got]), 2)
        for f in dataclasses.fields(inert):
            np.testing.assert_array_equal(getattr(inert, f.name).numpy(), np.asarray(getattr(jax_inert, f.name)))
        delta = torch.as_tensor(np.random.RandomState(3).uniform(-1e4, 1e4, (2, 50)))
        folded = multisource.stacked_fold(inert, delta, torch.zeros((2, 50), dtype=torch.int64))
        assert torch.equal(folded, torch.zeros_like(folded))
        both = multisource.concat_stacked(multisource.stack_models([got]), inert)
        assert both.n_source == 3


class TestBucketing:
    @pytest.mark.parametrize("sizes,kw", [
        ([37], {}),
        ([], {}),
        ([100] * 6, {}),
        ([8, 8, 4096], {"max_pad_ratio": 4.0}),
        ([8, 8, 4096], {"max_pad_ratio": 1e6}),
        ([64] * 8, {"batch_cap": 3}),
        ([40, 40, 100, 100], {"max_pad_ratio": 1.0}),
        ([300, 5, 64, 17, 900, 1200], {}),
    ])
    def test_bucket_sources_match_jax(self, sizes, kw):
        assert multisource.bucket_sources(sizes, **kw) == jax_ms.bucket_sources(sizes, **kw)

    @pytest.mark.parametrize("n,width", [(1, 1), (16, 300), (128, 1200), (500, 1 << 16), (4, 1 << 22)])
    def test_chunking_matches_jax(self, n, width):
        assert multisource._resolve_chunk(n, width) == jax_ms._resolve_chunk(n, width)


def pulsed_segments(rng, f0, n_seg, n_per, pf=0.6):
    """n_seg segments of n_per events of a pulse at f0 over 2-day windows."""
    out = []
    for s in range(n_seg):
        t = rng.uniform(58000.0 + 2.0 * s, 58002.0 + 2.0 * s, 8 * n_per)
        ph = f0 * (t - 58000.0) * 86400.0
        keep = rng.uniform(0, 1 + pf, t.size) < 1 + pf * np.cos(2 * np.pi * ph + 0.3)
        out.append(np.sort(t[keep][:n_per]))
    return out


TEMPLATES = [{"model": "fourier", "nbrComp": 2, "norm": 1.0, "amp_1": a1, "amp_2": 0.1, "ph_1": p1, "ph_2": 0.05}
             for a1, p1 in ((0.3, 0.2), (0.5, -0.1), (0.4, 0.35))]


class TestFitAndHTest:
    @pytest.fixture(scope="class")
    def problem(self):
        rng = np.random.RandomState(5)
        tms = [timing_dict(i) for i in range(3)]
        # >= 10^4 events a segment: the golden-section refine resolves phShift
        # to 1e-6 rad only there (test_torch_measure_toas)
        segs = [pulsed_segments(rng, tm["F0"], 2, 10000) for tm in tms]
        phase_lists, t_refs = multisource.fold_sources(tms, segs, device="cpu")
        exps = [np.full(2, 5000.0) for _ in tms]
        return tms, segs, phase_lists, t_refs, exps

    def test_per_row_templates_are_each_sources_own_fit(self, problem):
        _, _, phase_lists, _, exps = problem
        tpls = [profiles.from_template(t)[1] for t in TEMPLATES]
        cfg = toafit.ToAFitConfig(kind="fourier", ph_shift_res=200)
        out, slices = multisource.fit_sources("fourier", tpls, phase_lists, exps, cfg, device="cpu")
        for tpl, pl, ex, sl in zip(tpls, phase_lists, exps, slices):
            phases, masks = toafit.pad_segments(pl)
            solo = toafit.fit_toas_batch_auto("fourier", tpl, phases, masks, ex, cfg, device="cpu")
            # the event sums round with the rows beside them (ops/reduce.py)
            np.testing.assert_allclose(out["phShift"][sl], solo["phShift"], rtol=0, atol=1e-6)
            for key in ("phShift_LL", "phShift_UL"):
                assert np.max(np.abs(out[key][sl] - solo[key])) <= 2 * np.pi / 200 * (1 + 1e-9), key
            for key, rtol in (("norm", 1e-9), ("redChi2", 1e-6), ("logLmax", 1e-12)):
                np.testing.assert_allclose(out[key][sl], solo[key], rtol=rtol, err_msg=key)

    def test_fit_sources_match_jax(self, problem):
        _, _, phase_lists, _, exps = problem
        tpls = [profiles.from_template(t)[1] for t in TEMPLATES]
        jtpls = [jax_profiles.from_template(t)[1] for t in TEMPLATES]
        cfg = toafit.ToAFitConfig(kind="fourier", ph_shift_res=200)
        jcfg = jax_toafit.ToAFitConfig(kind="fourier", ph_shift_res=200)
        got, slices = multisource.fit_sources("fourier", tpls, phase_lists, exps, cfg, device="cpu")
        want, jslices = jax_ms.fit_sources("fourier", jtpls, phase_lists, exps, jcfg)
        assert slices == jslices
        np.testing.assert_allclose(got["phShift"], want["phShift"], rtol=0, atol=1e-6)
        step = 2 * np.pi / 200
        for key in ("phShift_LL", "phShift_UL"):
            assert np.max(np.abs(got[key] - want[key])) <= step * (1 + 1e-9)
        np.testing.assert_allclose(got["redChi2"], want["redChi2"], rtol=1e-6)

    def test_h_power_sources_match_jax(self, problem):
        tms, segs, _, t_refs, _ = problem
        from crimp_tpu_torch.models import timing
        from crimp_tpu_torch.ops.ephem import spin_frequency_host

        freqs = [spin_frequency_host(timing.resolve(tm), t)[0] for tm, t in zip(tms, t_refs)]
        got = multisource.h_power_sources(segs, freqs, device="cpu")
        want = jax_ms.h_power_sources(segs, freqs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4)
            assert np.all(g > 5)


STEPS, BURN, WALKERS = 300, 100, 16


def posterior_problems(n_sources=5, seed=9):
    """Linear two-parameter problems with ragged ToA counts."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_sources):
        n = int(rng.randint(12, 30))
        t = np.linspace(-1.0, 1.0, n)
        basis = np.column_stack([t, t**2])  # the likelihood centres the model: no constant column
        truth = np.array([0.02 * (i + 1), -0.01 * i])
        err = np.full(n, 0.01)
        y = basis @ truth + rng.normal(0, 0.01, n)
        y = y - y.mean()
        out.append({"basis": basis, "y": y, "err": err, "lo": truth - 0.2, "hi": truth + 0.2})
    return out


class TestSamplePosteriorSources:
    def test_chunking_is_bitwise(self):
        probs = posterior_problems()
        whole = multisource.sample_posterior_sources(probs, 60, WALKERS, seed=3, chunk=len(probs), device="cpu")
        for chunk in (1, 2):
            part = multisource.sample_posterior_sources(probs, 60, WALKERS, seed=3, chunk=chunk, device="cpu")
            np.testing.assert_array_equal(part[0], whole[0])
            np.testing.assert_array_equal(part[1], whole[1])
        one = multisource.sample_posterior_sources(probs[2:3], 60, WALKERS, seed=3, device="cpu")
        assert one[0].shape == (1, 60, WALKERS, 2)
        assert multisource.source_seed(3, 0) != multisource.source_seed(3, 1)

    def test_matches_jax_fed_the_same_draws(self):
        probs = posterior_problems()
        keys = jax.random.split(jax.random.PRNGKey(0), len(probs))
        per = [_jax_draws(k, STEPS, WALKERS) for k in keys]
        draws = mcmc.Draws(*(torch.stack([d[i] for d in per], dim=1) for i in range(3)))
        chains, lps = multisource.sample_posterior_sources(probs, STEPS, WALKERS, seed=0, draws=draws,
                                                           device="cpu")
        want_chains, want_lps = jax_ms.sample_posterior_sources(probs, STEPS, WALKERS, seed=0)
        assert chains.shape == want_chains.shape and lps.shape == want_lps.shape
        np.testing.assert_allclose(chains[:, 0], want_chains[:, 0], rtol=1e-12)
        keys_ = ["a", "b"]
        for i in range(len(probs)):
            _, _, got = mcmc.summarize_chain(chains[i], lps[i], keys_, burn=BURN)
            _, _, want = mcmc.summarize_chain(want_chains[i], want_lps[i], keys_, burn=BURN)
            for k in keys_:
                err = max(got[k]["plus"], got[k]["minus"])
                assert abs(got[k]["median"] - want[k]["median"]) < 0.05 * err + 1e-12, (i, k)
                np.testing.assert_allclose(max(got[k]["plus"], got[k]["minus"]),
                                           max(want[k]["plus"], want[k]["minus"]), rtol=0.1)

    def test_ndim_mismatch_and_empty(self):
        probs = posterior_problems(2)
        probs[1] = {**probs[1], "basis": probs[1]["basis"][:, :1], "lo": probs[1]["lo"][:1],
                    "hi": probs[1]["hi"][:1]}
        with pytest.raises(ValueError, match="ndim"):
            multisource.sample_posterior_sources(probs, 10, 8, device="cpu")
        c, lp = multisource.sample_posterior_sources([], 10, 8, device="cpu")
        assert c.shape == (0, 10, 8, 0) and lp.shape == (0, 10, 8)
