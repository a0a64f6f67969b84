"""Parity of the port's delta-fold engine (crimp_tpu_torch.ops.deltafold and
its wiring) with crimp_tpu, on the CPU, where refold runs K4's plain twin.

- linear_param_vector equal and nonlinear_sha the same hex digest;
- basis_rows within rtol 1e-14 (BASE with waves, wave_in_f0 on and off);
- refold / refold_batch within 1e-12 cycles of crimp_tpu's (wrap-aware);
  batched rows bitwise equal to solo refolds, padding inert;
- fold_segments(delta_fold=1) for tests/test_deltafold.py's three updates
  and the wave case: the same mode as crimp_tpu, within 1e-9 cycles of its
  phases and under 1e-8 cycles from conftest.reference_fold;
- the cache: a bitwise hit, invalidation on a new event set and on a
  non-linear move, the budget trip, the disk round trip, a corrupted npz
  quarantined and folded exactly, delta_refold_batch bitwise the solo
  refolds and demoting only the offender;
- model_phase_residuals_delta within 1e-9 of crimp_tpu's, declining the
  same free sets;
- delta_fold=0 bitwise the slice-1 fold (prepare_anchors + anchored_fold).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimp_tpu.models import timing as jax_timing
from crimp_tpu.ops import anchored as jax_anchored
from crimp_tpu.ops import autotune as jax_autotune
from crimp_tpu.ops import deltafold as jax_deltafold
from crimp_tpu.pipelines import fit_utils as jax_fit_utils
from crimp_tpu_torch.models import timing
from crimp_tpu_torch.ops import anchored, deltafold
from crimp_tpu_torch.pipelines import fit_utils
from tests.conftest import reference_fold
from tests.test_deltafold import BASE, _frac, _segments, _wrap_dev

torch.set_num_threads(2)

WAVES = {**BASE, "WAVEEPOCH": 58360.0, "WAVE_OM": 0.0075,
         "WAVE1": {"A": 2e-3, "B": -1e-3}, "WAVE2": {"A": 5e-4, "B": 0.0}}
UPDATES = {
    "spin": {"F0": 3e-10, "F1": 2e-17},
    "glitch": {"GLPH_1": 1e-3, "GLF0_1": 5e-10, "GLF0D_1": 1e-9, "GLF0_2": -3e-10},
    "combined": {"F0": -2e-10, "F2": 1e-25, "GLF1_1": 3e-17, "GLPH_1": -5e-4},
}


@pytest.fixture(autouse=True)
def _isolated_engines(monkeypatch):
    """Empty fold caches on both sides and no stray crimp_tpu knobs."""
    deltafold.clear_cache()
    jax_deltafold.clear_cache()
    for var in ("CRIMP_TPU_DELTA_FOLD", "CRIMP_TPU_DELTA_FOLD_BUDGET", "CRIMP_TPU_FOLD_CACHE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE", "0")
    yield
    deltafold.clear_cache()
    jax_deltafold.clear_cache()


def _fold(pars, segs, **kw):
    """The port's fold_segments on the CPU, phases concatenated."""
    ph, _ = anchored.fold_segments(timing.from_dict(pars), segs, device="cpu", **kw)
    return np.concatenate(ph)


def _jax_fold(pars, segs, **kw):
    ph, _ = jax_anchored.fold_segments(jax_timing.from_dict(pars), segs, **kw)
    return np.concatenate([np.asarray(p) for p in ph])


class TestParameterSplit:
    @pytest.mark.parametrize("pars", [BASE, WAVES], ids=["base", "waves"])
    def test_vector_and_sha_equal_jax(self, pars):
        tm, ref = timing.from_dict(pars), jax_timing.from_dict(pars)
        np.testing.assert_array_equal(deltafold.linear_param_vector(tm), jax_deltafold.linear_param_vector(ref))
        assert deltafold.nonlinear_sha(tm) == jax_deltafold.nonlinear_sha(ref)
        moved = {**pars, "GLEP_1": 58401.0}
        assert deltafold.nonlinear_sha(timing.from_dict(moved)) == \
            jax_deltafold.nonlinear_sha(jax_timing.from_dict(moved)) != deltafold.nonlinear_sha(tm)
        amp = {**pars, "GLF0_1": 9e-8, "F1": -1e-14}
        np.testing.assert_array_equal(
            deltafold.delta_params(tm, timing.from_dict(amp)),
            jax_deltafold.delta_params(ref, jax_timing.from_dict(amp)))
        assert deltafold.delta_params(tm, timing.from_dict(moved)) is None

    def test_error_bound_and_taylor_basis_equal_jax(self):
        colmax, dp = np.array([1e7, 1e12, 3.0]), np.array([1e-9, -1e-14, 0.5])
        assert deltafold.error_bound_cycles(colmax, dp) == jax_deltafold.error_bound_cycles(colmax, dp)
        dt = np.linspace(-5e4, 5e4, 101)
        np.testing.assert_array_equal(deltafold.taylor_basis_seconds(dt, 2),
                                      jax_deltafold.taylor_basis_seconds(dt, 2))


class TestBasisRows:
    @pytest.mark.parametrize("wave_in_f0", [True, False])
    def test_rows_match_jax(self, wave_in_f0):
        segs = _segments(n_per=700)
        t = np.concatenate(segs)
        sizes = [s.size for s in segs]
        t_ref = np.asarray([(s[-1] - s[0]) / 2 + s[0] for s in segs])
        idx = np.repeat(np.arange(len(segs)), sizes)
        delta = anchored.anchor_deltas(t, t_ref, idx)
        got = deltafold.build_basis(timing.from_dict(WAVES), t_ref, delta, idx, wave_in_f0=wave_in_f0,
                                    device="cpu")
        want = jax_deltafold.build_basis(jax_timing.from_dict(WAVES), t_ref, delta, idx, wave_in_f0=wave_in_f0)
        assert got.b.shape == (t.size, deltafold.n_params(2)) == want.b.shape
        np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=1e-14, atol=0)
        np.testing.assert_allclose(got.colmax, want.colmax, rtol=1e-14, atol=0)


class TestRefold:
    def test_solo_refold_matches_jax(self):
        segs = _segments(n_per=800, n_seg=3)
        t = np.concatenate(segs)
        sizes = [s.size for s in segs]
        t_ref = np.asarray([(s[-1] - s[0]) / 2 + s[0] for s in segs])
        idx = np.repeat(np.arange(len(segs)), sizes)
        delta = anchored.anchor_deltas(t, t_ref, idx)
        folded = _fold(BASE, segs)
        fb = deltafold.build_basis(timing.from_dict(BASE), t_ref, delta, idx, device="cpu")
        dp = np.zeros(deltafold.n_params(2))
        dp[[0, 1, 13, 14, 17, 19]] = [3e-10, 2e-17, 1e-3, 5e-10, 1e-9, -3e-10]
        deltafold.reset_launches()
        got = deltafold.refold(torch.as_tensor(folded), fb.b, torch.as_tensor(dp)).numpy()
        assert deltafold.LAUNCHES["refold"] == 0  # the CPU takes the twin
        want = np.asarray(jax_deltafold.refold(jnp.asarray(folded), jnp.asarray(fb.b.numpy()), jnp.asarray(dp)))
        assert np.all((got >= 0.0) & (got < 1.0))
        assert _wrap_dev(got, want) < 1e-12

    def test_batched_rows_bitwise_solo_and_padding_inert(self):
        rng = np.random.default_rng(3)
        shapes = [(500, 4), (350, 4), (500, 2)]
        n_ev, n_par = 500, 4
        folded_pad = np.zeros((3, n_ev))
        basis_pad = np.zeros((3, n_ev, n_par))
        dp_pad = np.zeros((3, n_par))
        solos = []
        for r, (ne, np_) in enumerate(shapes):
            folded = rng.uniform(0.0, 1.0, ne)
            basis = rng.uniform(-1e6, 1e6, (ne, np_))
            dp = rng.uniform(-1e-9, 1e-9, np_)
            solos.append(deltafold.refold(torch.as_tensor(folded), torch.as_tensor(basis),
                                          torch.as_tensor(dp)).numpy())
            folded_pad[r, :ne], basis_pad[r, :ne, :np_], dp_pad[r, :np_] = folded, basis, dp
        out = deltafold.refold_batch(torch.as_tensor(folded_pad), torch.as_tensor(basis_pad),
                                     torch.as_tensor(dp_pad)).numpy()
        want = np.asarray(jax_deltafold.refold_batch(jnp.asarray(folded_pad), jnp.asarray(basis_pad),
                                                     jnp.asarray(dp_pad)))
        for r, (ne, _) in enumerate(shapes):
            assert np.array_equal(out[r, :ne], solos[r]), f"row {r}"
            assert _wrap_dev(out[r, :ne], want[r, :ne]) < 1e-12

    def test_malformed_operands_raise(self):
        f, b, d = torch.zeros(10, dtype=torch.float64), torch.zeros(10, 3, dtype=torch.float64), \
            torch.zeros(3, dtype=torch.float64)
        with pytest.raises(ValueError, match="float64"):
            deltafold.refold(f.float(), b, d)
        with pytest.raises(ValueError, match="contiguous"):
            deltafold.refold(f, torch.zeros(3, 10, dtype=torch.float64).T, d)
        with pytest.raises(ValueError, match="line up"):
            deltafold.refold(f, b, torch.zeros(4, dtype=torch.float64))


class TestFoldSegmentsDelta:
    @pytest.mark.parametrize("name", list(UPDATES))
    def test_update_matches_jax_and_oracle(self, name):
        segs = _segments()
        new = {**BASE, **{k: BASE.get(k, 0.0) + dv for k, dv in UPDATES[name].items()}}
        _fold(BASE, segs, delta_fold=1)
        _jax_fold(BASE, segs, delta_fold=1)
        got = _fold(new, segs, delta_fold=1)
        info = deltafold.last_fold_info()
        want = _jax_fold(new, segs, delta_fold=1)
        assert info["mode"] == jax_deltafold.last_fold_info()["mode"] == "delta"
        assert info["bound_cycles"] == pytest.approx(jax_deltafold.last_fold_info()["bound_cycles"], rel=1e-12)
        assert _wrap_dev(got, want) < 1e-9
        assert _wrap_dev(got, _frac(reference_fold(np.concatenate(segs), new))) < 1e-8

    def test_wave_update_through_f0_column(self):
        segs = _segments(n_per=1000)
        new = {**WAVES, "F0": WAVES["F0"] + 4e-10}
        _fold(WAVES, segs, delta_fold=1)
        _jax_fold(WAVES, segs, delta_fold=1)
        got = _fold(new, segs, delta_fold=1)
        assert deltafold.last_fold_info()["mode"] == "delta"
        want = _jax_fold(new, segs, delta_fold=1)
        assert jax_deltafold.last_fold_info()["mode"] == "delta"
        assert _wrap_dev(got, want) < 1e-9
        assert _wrap_dev(got, _frac(reference_fold(np.concatenate(segs), new))) < 1e-8

    def test_delta_fold_off_is_the_slice1_fold(self):
        segs = _segments(n_per=500)
        tm = timing.from_dict(BASE)
        ph, t_ref = anchored.fold_segments(tm, segs, device="cpu", delta_fold=0)
        sizes = [s.size for s in segs]
        idx = np.repeat(np.arange(len(segs)), sizes)
        delta = anchored.anchor_deltas(np.concatenate(segs), t_ref, idx)
        expect = anchored.anchored_fold(anchored.prepare_anchors(tm, t_ref), torch.as_tensor(delta),
                                        torch.as_tensor(idx)).numpy()
        assert np.array_equal(np.concatenate(ph), expect)
        # and the engine's exact branch stores those same bits
        assert np.array_equal(_fold(BASE, segs, delta_fold=1), expect)
        assert deltafold.last_fold_info()["mode"] == "exact"


class TestFoldCache:
    def test_hit_is_bitwise_and_invalidations(self):
        segs = _segments(n_per=500)
        first = _fold(BASE, segs, delta_fold=1)
        assert np.array_equal(_fold(BASE, segs, delta_fold=1), first)
        assert deltafold.last_fold_info()["mode"] == "cache"
        _fold(BASE, [s + 1e-6 for s in segs], delta_fold=1)  # a new event set
        assert deltafold.last_fold_info()["mode"] == "exact"
        _fold({**BASE, "GLEP_1": 58401.0}, segs, delta_fold=1)  # a non-linear move: a new key
        info = deltafold.last_fold_info()
        assert info["mode"] == "exact" and "fallback" not in info
        _fold(BASE, segs, delta_fold=1, fold_cache="off")
        _fold(BASE, segs, delta_fold=1, fold_cache="off")
        assert deltafold.last_fold_info()["mode"] == "exact"

    def test_budget_trip_folds_exactly(self):
        segs = _segments(n_per=500)
        new = {**BASE, "F0": BASE["F0"] + 1e-10}
        _fold(BASE, segs, delta_fold=1)
        got = _fold(new, segs, delta_fold=1, budget=1e-30)
        info = deltafold.last_fold_info()
        assert info["mode"] == "exact" and info["fallback"] == "budget" and info["bound_cycles"] > 1e-30
        assert np.array_equal(got, _fold(new, segs))

    def test_disk_round_trip_and_quarantine(self, tmp_path):
        segs = _segments(n_per=500)
        cache = str(tmp_path / "fc")
        first = _fold(BASE, segs, delta_fold=1, fold_cache=cache)
        (npz,) = (tmp_path / "fc").glob("*.npz")
        deltafold.clear_cache()  # a fresh process
        assert np.array_equal(_fold(BASE, segs, delta_fold=1, fold_cache=cache), first)
        assert deltafold.last_fold_info()["mode"] == "cache"
        _fold({**BASE, "F0": BASE["F0"] + 1e-10}, segs, delta_fold=1, fold_cache=cache)
        assert deltafold.last_fold_info()["mode"] == "delta"
        # bit rot under an intact zip container: only the sha footer sees it
        with np.load(npz, allow_pickle=False) as doc:
            payload = {k: doc[k] for k in doc.files}
        payload["phases"] = payload["phases"] + 0.25
        with open(npz, "wb") as fh:
            np.savez(fh, **payload)
        deltafold.clear_cache()
        assert np.array_equal(_fold(BASE, segs, delta_fold=1, fold_cache=cache), first)
        assert deltafold.last_fold_info()["mode"] == "exact"
        assert npz.with_name(npz.name + ".corrupt").exists() and npz.exists()
        # a torn write
        npz.write_bytes(npz.read_bytes()[:100])
        deltafold.clear_cache()
        assert np.array_equal(_fold(BASE, segs, delta_fold=1, fold_cache=cache), first)
        assert deltafold.last_fold_info()["mode"] == "exact"
        deltafold.clear_cache()
        _fold(BASE, segs, delta_fold=1, fold_cache=cache)
        assert deltafold.last_fold_info()["mode"] == "cache"  # the exact fold re-stored a good copy

    def test_key_carries_model_tag_and_device(self):
        segs = _segments(n_per=200)
        times, sizes = np.concatenate(segs), [s.size for s in segs]
        t_ref = np.asarray([s.mean() for s in segs])
        key = deltafold.fold_key(times, sizes, t_ref, model_sha="a", device="cpu")
        assert key != deltafold.fold_key(times, sizes, t_ref, model_sha="b", device="cpu")
        assert key != deltafold.fold_key(times, sizes, t_ref, model_sha="a", tag="src1", device="cpu")
        assert key != deltafold.fold_key(times, sizes, t_ref, model_sha="a", device="meta")
        assert key == deltafold.fold_key(times.copy(), list(sizes), t_ref, model_sha="a", device="cpu")


class TestBatchedRefolds:
    def _clients(self, n_clients=3, n_per=300):
        return [_segments(n_per=n_per - 40 * c, n_seg=3, seed=10 + c) for c in range(n_clients)]

    def test_batch_bitwise_solo_and_demotions(self):
        seg_lists = self._clients()
        news = []
        for c, segs in enumerate(seg_lists):
            pars = {**BASE, "F0": BASE["F0"] + 1e-5 * c}
            _fold(pars, segs, delta_fold=1, cache_tag=f"c{c}")
            news.append({**pars, "F0": pars["F0"] + (2 + c) * 1e-10})
        news[2] = {**news[2], "F0": news[2]["F0"] + 0.1}  # over the budget
        phase_lists, t_refs, infos = deltafold.delta_refold_batch(
            [timing.from_dict(p) for p in news], seg_lists, tags=["c0", "c1", "c2"], device="cpu")
        assert phase_lists[2] is None and infos[2]["fallback"] == "budget"
        for c in (0, 1):
            assert infos[c]["mode"] == "delta" and infos[c]["batched"] is True
            solo = _fold(news[c], seg_lists[c], delta_fold=1, cache_tag=f"c{c}")
            assert deltafold.last_fold_info()["mode"] == "delta"
            assert np.array_equal(np.concatenate(phase_lists[c]), solo), f"client {c}"
            assert len(phase_lists[c]) == 3
        # the same reasons as crimp_tpu's batch for the same clients
        for c, segs in enumerate(seg_lists):
            jax_anchored.fold_segments(jax_timing.from_dict({**BASE, "F0": BASE["F0"] + 1e-5 * c}), segs,
                                       delta_fold=1, cache_tag=f"c{c}")
        _, _, ref_infos = jax_deltafold.delta_refold_batch([jax_timing.from_dict(p) for p in news], seg_lists,
                                                           tags=["c0", "c1", "c2"])
        assert [i["mode"] for i in infos] == [i["mode"] for i in ref_infos]
        assert infos[2]["fallback"] == ref_infos[2]["fallback"]

    def test_zero_dp_miss_and_cache_off(self):
        segs = self._clients(n_clients=1)[0]
        ph = _fold(BASE, segs, delta_fold=1, cache_tag="same")
        lists, _, infos = deltafold.delta_refold_batch([timing.from_dict(BASE)], [segs], tags=["same"],
                                                       device="cpu")
        assert infos[0]["mode"] == "cache" and np.array_equal(np.concatenate(lists[0]), ph)
        lists, _, infos = deltafold.delta_refold_batch([timing.from_dict(BASE)], [segs], tags=["never"],
                                                       device="cpu")
        assert lists[0] is None and infos[0]["fallback"] == "miss"
        lists, _, infos = deltafold.delta_refold_batch([timing.from_dict(BASE)], [segs], tags=["same"],
                                                       fold_cache="off", device="cpu")
        assert lists[0] is None and infos[0]["fallback"] == "cache_off"
        tags_store = deltafold.store_product(timing.from_dict(BASE), np.concatenate(segs), [s.size for s in segs],
                                             [(s[-1] - s[0]) / 2 + s[0] for s in segs], ph, tag="seeded",
                                             device="cpu")
        assert tags_store is not None
        lists, _, infos = deltafold.delta_refold_batch([timing.from_dict({**BASE, "F1": BASE["F1"] + 1e-18})],
                                                       [segs], tags=["seeded"], device="cpu")
        assert infos[0]["mode"] == "delta"


class TestFitUtilsDelta:
    CFG = {"delta_fold": 1, "budget": jax_autotune.DELTA_FOLD_BUDGET_DEFAULT}

    def _parfile(self):
        flags1 = {"F0", "F1", "GLF0_1", "GLPH_1"}
        return {k: {"value": v, "flag": int(k in flags1)} for k, v in BASE.items()}

    @pytest.mark.parametrize("waves", [False, True])
    def test_matches_jax(self, waves):
        par = self._parfile()
        keys, pvec = ["F0", "F1", "GLF0_1", "GLPH_1"], np.array([3e-10, -2e-17, 5e-10, 1e-3])
        if waves:
            par["WAVEEPOCH"] = {"value": 58360.0, "flag": 0}
            par["WAVE_OM"] = {"value": 0.0075, "flag": 0}
            par["WAVE1"] = {"value": {"A": 2e-3, "B": -1e-3}}
            keys, pvec = ["F0", "GLF0_1"], np.array([2e-10, -4e-10])
        t = np.linspace(58320.0, 58700.0, 400)
        got = fit_utils.model_phase_residuals_delta(t, par, pvec, keys, cfg=self.CFG, device="cpu")
        want = jax_fit_utils.model_phase_residuals_delta(t, par, pvec, keys, cfg=self.CFG)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        np.testing.assert_allclose(got, fit_utils.model_phase_residuals(t, par, pvec, keys), rtol=0, atol=1e-9)
        assert fit_utils.linear_key_columns(par, keys) == jax_fit_utils.linear_key_columns(par, keys)

    def test_declines_as_jax(self):
        par = self._parfile()
        t = np.linspace(58320.0, 58700.0, 50)
        for keys, pvec, cfg in (
            (["GLEP_1"], np.array([0.5]), self.CFG),
            (["GLTD_1"], np.array([1.0]), self.CFG),
            (["F0", "WAVE1_A"], np.array([1e-10, 1e-3]), self.CFG),
            (["F13"], np.array([1e-30]), self.CFG),
            (["F0"], np.array([1e-10]), {"delta_fold": 0, "budget": 1e-9}),
            (["F0"], np.array([1e-10]), {"delta_fold": 1, "budget": 1e-30}),
        ):
            assert fit_utils.model_phase_residuals_delta(t, dict(par), pvec, keys, cfg=cfg, device="cpu") is None
            assert jax_fit_utils.model_phase_residuals_delta(t, dict(par), pvec, keys, cfg=cfg) is None
        assert fit_utils.model_phase_residuals_delta(t, par, np.array([1e-10]), ["F0"], device="cpu") is None
