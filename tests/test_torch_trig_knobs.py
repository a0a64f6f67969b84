"""The poly-trig and HBM-warning knobs of the port against crimp_tpu's.

- ``fasttrig.poly_trig_enabled``: the explicit argument, then
  CRIMP_TORCH_POLY_TRIG, then the device (on for cuda, off on the CPU);
  a word outside the on/off sets raises, as crimp_tpu's does.
- The port's default search path on the CPU is crimp_tpu's default path
  (both take hardware sin/cos there): ``PeriodSearch.ztest`` /
  ``twod_ztest``, ``semicoherent_z2_grid`` and ``ResumableScan``, at the
  tolerances of tests/test_search.py (K2's twin, rtol 2e-3 / atol 0.05)
  and tests/test_torch_semicoherent.py (rtol 1e-4 / atol 1e-3), same
  argmax; the knob turns the polynomial on for every default consumer.
- CRIMP_TORCH_HBM_WARN_PCT: default 90 (crimp_tpu's), a moved threshold,
  0 off; the same memory samples trip both packages alike.
"""

import numpy as np
import pytest
import torch

from crimp_tpu import knobs as jax_knobs
from crimp_tpu import obs as jax_obs
from crimp_tpu.ops import fasttrig as jax_fasttrig
from crimp_tpu.ops import resumable as jax_resumable
from crimp_tpu.ops import search as jax_search
from crimp_tpu.ops import semicoherent as jax_semi
from crimp_tpu_torch import knobs, obs
from crimp_tpu_torch.ops import fasttrig, resumable, search
from crimp_tpu_torch.ops import semicoherent as semi
from crimp_tpu_torch.utils import device as device_mod

torch.set_num_threads(2)

K2_TOL = dict(rtol=2e-3, atol=0.05)  # tests/test_search.py::TestPallasZ2
SEMI_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_torch_semicoherent.py


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("POLY_TRIG", "HBM_WARN_PCT", "OBS", "OBS_DIR", "GRID_MXU", "GRID_BLOCKS"):
        monkeypatch.delenv(f"CRIMP_TORCH_{name}", raising=False)
        monkeypatch.delenv(f"CRIMP_TPU_{name}", raising=False)
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE", "0")
    monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE", "0")


@pytest.fixture(scope="module")
def events():
    rng = np.random.RandomState(17)
    n = 4000
    base = np.sort(rng.uniform(0.0, 20000.0, n))
    pulsed = rng.rand(n) < 0.5
    phase = rng.vonmises(0.0, 2.0, n) / (2 * np.pi)
    t = np.where(pulsed, (np.round(base * 0.25) + phase) / 0.25, base)
    return np.sort(t) - 10000.0


FREQS = np.linspace(0.2496, 0.2504, 300)


class TestPolyTrigResolution:
    def test_registered_with_its_numeric_key(self):
        k = knobs.REGISTRY["CRIMP_TORCH_POLY_TRIG"]
        ref = jax_knobs.REGISTRY["CRIMP_TPU_POLY_TRIG"]
        assert (k.kind, k.numeric_key, k.consumer) == (ref.kind, ref.numeric_key, ref.consumer)

    @pytest.mark.parametrize("device,want", [("cpu", False), ("cuda", True), ("cuda:1", True)])
    def test_auto_is_on_for_the_card_and_off_on_the_cpu(self, device, want):
        assert fasttrig.poly_trig_enabled(device=device) is want
        assert fasttrig.poly_trig_enabled(device=torch.device(device)) is want

    def test_auto_on_the_cpu_is_jaxs_cpu_default(self):
        assert fasttrig.poly_trig_enabled(device="cpu") == jax_fasttrig.poly_trig_enabled() is False

    def test_device_none_is_the_default_device(self, monkeypatch):
        assert fasttrig.poly_trig_enabled() is True  # the card
        monkeypatch.setattr(device_mod, "_DEFAULT", "cpu")  # a script forced the CPU
        assert fasttrig.poly_trig_enabled() is False

    @pytest.mark.parametrize("word,want", [("1", True), ("on", True), ("always", True), ("0", False),
                                           ("off", False), ("never", False)])
    def test_the_knob_beats_auto(self, monkeypatch, word, want):
        monkeypatch.setenv("CRIMP_TORCH_POLY_TRIG", word)
        assert fasttrig.poly_trig_enabled(device="cpu") is want
        assert fasttrig.poly_trig_enabled(device="cuda") is want

    def test_the_argument_beats_the_knob(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_POLY_TRIG", "0")
        assert fasttrig.poly_trig_enabled(True, device="cpu") is True
        monkeypatch.setenv("CRIMP_TORCH_POLY_TRIG", "1")
        assert fasttrig.poly_trig_enabled(False, device="cuda") is False

    @pytest.mark.parametrize("word", ["auto", "", "  "])
    def test_auto_words_keep_the_device_rule(self, monkeypatch, word):
        monkeypatch.setenv("CRIMP_TORCH_POLY_TRIG", word)
        assert fasttrig.poly_trig_enabled(device="cpu") is False
        assert fasttrig.poly_trig_enabled(device="cuda") is True

    @pytest.mark.parametrize("word", ["of", "yes", "2"])
    def test_a_bad_word_raises_as_in_jax(self, monkeypatch, word):
        monkeypatch.setenv("CRIMP_TORCH_POLY_TRIG", word)
        monkeypatch.setenv("CRIMP_TPU_POLY_TRIG", word)
        with pytest.raises(ValueError, match="CRIMP_TORCH_POLY_TRIG"):
            fasttrig.poly_trig_enabled(device="cpu")
        with pytest.raises(ValueError, match="CRIMP_TPU_POLY_TRIG"):
            jax_fasttrig.poly_trig_enabled()

    def test_the_packages_do_not_steer_each_other(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TPU_POLY_TRIG", "1")
        assert fasttrig.poly_trig_enabled(device="cpu") is False
        monkeypatch.delenv("CRIMP_TPU_POLY_TRIG")
        monkeypatch.setenv("CRIMP_TORCH_POLY_TRIG", "1")
        assert jax_fasttrig.poly_trig_enabled() is False


class TestDefaultPathMatchesJax:
    def test_ztest(self, events):
        got = search.PeriodSearch(events, FREQS, 2, device="cpu").ztest()
        want = np.asarray(jax_search.PeriodSearch(events, FREQS, 2).ztest())
        np.testing.assert_allclose(got, want, **K2_TOL)
        assert int(np.argmax(got)) == int(np.argmax(want))

    def test_twod_ztest(self, events):
        log_fdots = np.array([-13.0, -12.0, -11.5])
        got, _ = search.PeriodSearch(events, FREQS, 2, device="cpu").twod_ztest(log_fdots)
        want, _ = jax_search.PeriodSearch(events, FREQS, 2).twod_ztest(log_fdots)
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got[:, 2], want[:, 2], **K2_TOL)
        assert int(np.argmax(got[:, 2])) == int(np.argmax(want[:, 2]))

    def test_semicoherent_z2_grid(self, events):
        kw = dict(f0=0.2496, df=2e-6, n_freq=97, fdots=np.array([-1e-12, 0.0]), fddots=np.array([0.0]),
                  nharm=2, n_segments=4)
        got = semi.semicoherent_z2_grid(events, device="cpu", **kw).numpy()
        want = np.asarray(jax_semi.semicoherent_z2_grid(events, mxu=False, **kw))
        np.testing.assert_allclose(got, want, **SEMI_TOL)
        assert int(np.argmax(got)) == int(np.argmax(want))

    def test_resumable_scan(self, events):
        got_scan = resumable.ResumableScan(events, FREQS, nharm=2, chunk_trials=128, device="cpu")
        want_scan = jax_resumable.ResumableScan(events, FREQS, nharm=2, chunk_trials=128)
        assert got_scan.poly is want_scan.poly is False
        got, want = got_scan.run(), np.asarray(want_scan.run())
        np.testing.assert_allclose(got, want, **K2_TOL)
        assert int(np.argmax(got)) == int(np.argmax(want))

    def test_the_default_is_hardware_trig_bitwise(self, events):
        ps = search.PeriodSearch(events, FREQS, 2, device="cpu")
        f0, df = search.uniform_grid(FREQS)
        hw = search.z2_power_grid(ps._centered(), f0, df, len(FREQS), 2, poly=False, device="cpu")
        np.testing.assert_array_equal(ps.ztest(), hw.numpy())

    def test_the_knob_turns_the_polynomial_on_for_every_default_consumer(self, events, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_POLY_TRIG", "1")
        ps = search.PeriodSearch(events, FREQS, 2, device="cpu")
        f0, df = search.uniform_grid(FREQS)
        poly = search.z2_power_grid(ps._centered(), f0, df, len(FREQS), 2, poly=True, device="cpu").numpy()
        np.testing.assert_array_equal(ps.ztest(), poly)
        np.testing.assert_array_equal(
            search.z2_power_grid(ps._centered(), f0, df, len(FREQS), 2, device="cpu").numpy(), poly)
        scan = resumable.ResumableScan(ps._centered(), FREQS, nharm=2, chunk_trials=128, device="cpu")
        assert scan.poly is True and scan._numeric_mode["poly_trig"] is True
        np.testing.assert_array_equal(scan.run(), poly)
        assert not np.array_equal(poly, search.z2_power_grid(ps._centered(), f0, df, len(FREQS), 2, poly=False,
                                                             device="cpu").numpy())


class TestHbmWarnPct:
    GIB = 1 << 30

    def _trips(self, obs_mod, monkeypatch, tmp_path, prefix, pct_used, env=None):
        monkeypatch.setenv(f"{prefix}_OBS", "1")
        monkeypatch.setenv(f"{prefix}_OBS_DIR", str(tmp_path / prefix.lower()))
        if env is not None:
            monkeypatch.setenv(f"{prefix}_HBM_WARN_PCT", env)
        limit = 80 * self.GIB
        with obs_mod.run("hbm_probe") as rec:
            rec._hbm_update({"bytes_in_use": 1, "peak_bytes_in_use": int(limit * pct_used / 100),
                             "bytes_limit": limit})
            rec._hbm_update({"bytes_in_use": 1, "peak_bytes_in_use": limit, "bytes_limit": limit})
            return rec.counters.get("hbm_warn_trips", 0), rec.gauges["hbm_peak_bytes"]

    def test_registered_with_jaxs_default(self):
        k = knobs.REGISTRY["CRIMP_TORCH_HBM_WARN_PCT"]
        ref = jax_knobs.REGISTRY["CRIMP_TPU_HBM_WARN_PCT"]
        assert (k.default, k.kind, k.numeric) == (ref.default, ref.kind, ref.numeric) == ("90", "float", False)

    @pytest.mark.parametrize("pct_used,env,want", [(95, None, 1), (60, None, 1), (95, "0", 0), (60, "50", 1),
                                                   (40, "50", 1), (99.5, "99.9", 1)])
    def test_trips_once_a_run_as_jax_does(self, monkeypatch, tmp_path, pct_used, env, want):
        """Two samples a run: ``pct_used`` of the card, then all of it. A
        trip counts once; 0 turns the warning off."""
        got = self._trips(obs, monkeypatch, tmp_path, "CRIMP_TORCH", pct_used, env)
        ref = self._trips(jax_obs, monkeypatch, tmp_path, "CRIMP_TPU", pct_used, env)
        assert got == ref
        assert got[0] == want

    def test_a_moved_threshold_decides_at_the_first_sample(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        limit = 80 * self.GIB
        for env, want in ((None, 0), ("70", 1), ("0", 0)):
            if env is None:
                monkeypatch.delenv("CRIMP_TORCH_HBM_WARN_PCT", raising=False)
            else:
                monkeypatch.setenv("CRIMP_TORCH_HBM_WARN_PCT", env)
            with obs.run("hbm_probe") as rec:
                rec._hbm_update({"bytes_in_use": 1, "peak_bytes_in_use": int(0.75 * limit), "bytes_limit": limit})
                assert rec.counters.get("hbm_warn_trips", 0) == want, env

    def test_a_malformed_threshold_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        monkeypatch.setenv("CRIMP_TORCH_HBM_WARN_PCT", "ninety")
        with pytest.raises(ValueError, match="CRIMP_TORCH_HBM_WARN_PCT"):
            with obs.run("hbm_probe") as rec:
                rec._hbm_update({"bytes_in_use": 1, "peak_bytes_in_use": 2, "bytes_limit": 4})
