"""The blind search on trial periods stepped evenly (the benchmark's
``blind_1e7.nonuniform`` cell) on the CPU, with seeded events over the
1E 2259+586 campaign's span:

- the grid, 1/period of periods stepped evenly, is not uniform in
  frequency: ``search.uniform_grid`` refuses it, so ``PeriodSearch.ztest``
  runs it on K3 (its twin here);
- the events are centred on the scan's device, to the bits of the host's
  centring;
- that scan matches the benchmark's plain float64 reference
  (``portbench/reference/z2.py``) within the K3 twin's f32 tolerance, with
  hardware and with polynomial sin/cos;
- the frozen K3 count the cell's roofline reads;
- the cell's driver, at a small size, is correct on the program and not
  correct under each fault: an answer altered, half the events, the last
  result again, Z^2 lowered in one 128-trial block.
"""

import copy

import numpy as np
import pytest
import torch

from crimp_tpu_torch.ops import search
from portbench import harness
from portbench.reference import z2 as ref_z2

torch.set_num_threads(2)

CELL = "blind_1e7.nonuniform"
F32 = (1e-4, 5e-3)  # (rtol, atol): the K3 twin's f32-trig tolerance (tests/test_torch_search_general.py)
N_PERIOD, EVENTS, STRIDE = 2000, 20_000, 128


def small_cell(sets: int = 2):
    """(config, mix) of the cell at about ``EVENTS`` events over all the
    campaign's intervals and ``N_PERIOD`` periods over the same band."""
    _, config, mix = harness.cell_files(CELL)
    config = dict(copy.deepcopy(config), events_total=EVENTS)
    mix = dict(copy.deepcopy(mix), event_sets=sets, z2_sample=64)
    mix["grid"] = dict(mix["grid"], n_period=N_PERIOD)
    assert mix["z2_stride"] == STRIDE
    return config, mix


@pytest.fixture(scope="module")
def events_and_freqs():
    config, mix = small_cell(sets=1)
    driver = harness.load_module(harness.HERE / "drivers" / "nonuniform.py").make(config, mix, 2718281828459, "cpu")
    driver.draw()
    return driver.sets[0], driver.freqs


def test_the_period_grid_is_not_uniform_in_frequency(events_and_freqs):
    _, freqs = events_and_freqs
    assert freqs.size == N_PERIOD and np.all(np.diff(freqs) > 0)
    assert search.uniform_grid(freqs) is None
    periods = 1.0 / freqs[::-1]
    np.testing.assert_allclose(np.diff(periods), np.diff(periods)[0], rtol=1e-6)


@pytest.mark.parametrize("poly", [False, True], ids=["hardware", "polynomial"])
def test_ztest_matches_the_plain_reference(events_and_freqs, poly, monkeypatch):
    times, freqs = events_and_freqs
    launched = []
    real = search.general_harmonic_sums
    monkeypatch.setattr(search, "general_harmonic_sums", lambda *a, **k: launched.append(1) or real(*a, **k))
    got = search.PeriodSearch(times, freqs, 2, poly_trig=poly, device="cpu").ztest()
    assert launched == [1]
    t = torch.as_tensor(times)
    want = ref_z2.z2_trials(t, torch.as_tensor(freqs), torch.zeros(freqs.size, dtype=torch.float64), 2).numpy()
    assert np.max(want) > 100  # the pulse lies in the band
    np.testing.assert_allclose(got, want, rtol=F32[0], atol=F32[1])


@pytest.mark.parametrize("entry,power", [("ztest", search.z2_power), ("htest", search.h_power)])
def test_events_centred_on_the_device_are_the_host_centred_bits(events_and_freqs, entry, power):
    times, freqs = events_and_freqs
    ps = search.PeriodSearch(times, freqs, 2, device="cpu")
    host = power(ps._centered(), freqs, 2, poly=ps._poly(), device="cpu").numpy()
    np.testing.assert_array_equal(getattr(ps, entry)(), host)


def test_k3_counts():
    from portbench.counts import k3

    # nharm 2: cast 1, polynomial sin/cos 24, first harmonic 3, one more harmonic 6
    assert k3.ops_per_pair(2) == 34 == search.z2_general.ops_per_pair(2, torch.float32, poly=True)[1]
    c = k3.scan_counts(n_events=1000, n_freq=300, n_rows=1, nharm=2)
    assert c["flops"] == 300 * 1000 * 34 and c["dtype"] == "f32"
    # events, frequencies, one row coefficient, C and S of 2 harmonics of 300 trials, all f64
    assert c["bytes"] == 8 * 1000 + 8 * 300 + 8 + 2 * 2 * 300 * 8


def run():
    config, mix = small_cell()
    return harness.run(CELL, 424242424242, 0.05, False, device="cpu", config=config, mix=mix,
                       log=lambda *a, **k: None)


def test_sound_run_is_correct():
    result = run()
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"search_pairs_per_s", "setup_s"}


def _break_ztest(kind, monkeypatch):
    real = search.PeriodSearch
    first = {}

    class Broken(real):
        def __init__(self, time, freq, *a, **kw):
            super().__init__(time[::2] if kind == "half" else time, freq, *a, **kw)

        def ztest(self):
            z2 = super().ztest()
            if kind == "altered":
                z2[np.argmax(z2)] *= 1.001
            if kind == "block":
                lo = int(np.argmax(z2)) // STRIDE * STRIDE
                z2[lo:lo + STRIDE] *= 0.95
            if kind == "unchanged":
                return first.setdefault("out", z2)
            return z2

    monkeypatch.setattr(search, "PeriodSearch", Broken)


@pytest.mark.parametrize("kind", ["altered", "half", "unchanged", "block"])
def test_fault_is_caught(kind, monkeypatch):
    _break_ztest(kind, monkeypatch)
    result = run()
    assert not result["correct"], result["checks"]
