"""The span readers' arithmetic on hand-built traces."""

import pytest

from portbench import harness, spans


class FakeTrace:
    def __init__(self, host_ops, device_ops, window_s):
        self.host_ops, self.device_ops, self.window_s = host_ops, device_ops, window_s

    def busy_intervals(self):
        return spans.union((a, b) for _, a, b in self.device_ops)


def ctx(host_ops, device_ops, window_ns, units=1):
    trace = FakeTrace(host_ops, device_ops, window_ns / 1e9)
    return harness.Context([{"seconds": 0.0}] * units, trace, {})


def test_idle_inside_a_span():
    c = ctx([("crimp.fold", 0, 10_000_000)], [("k", 2_000_000, 4_000_000), ("k", 6_000_000, 7_000_000)], 10e6)
    assert spans.idle_ms(c, spans.under("crimp.fold")) == pytest.approx(7.0)


def test_overlapping_ranges_count_once_and_divide_by_units():
    host = [("crimp.fold", 0, 6), ("crimp.fold.anchors", 1, 3), ("crimp.fold.pad", 5, 9), ("crimp.fit", 9, 20)]
    device = [("k", 4, 5), ("k", 8, 12)]
    c = ctx(host, device, 20, units=2)
    # fold ranges cover [0, 9]; the device is busy over [4, 5] and [8, 9] of it
    assert spans.idle_ms(c, spans.under("crimp.fold")) == pytest.approx(7 / 1e6 / 2)
    assert spans.idle_ms(c, spans.under("crimp.fit")) == pytest.approx(8 / 1e6 / 2)
    # a prefix that is not a span's whole segment matches nothing
    assert spans.idle_ms(c, spans.under("crimp.fo")) is None


def test_unattributed_share():
    host = [("crimp.pass", 0, 100), ("crimp.fit", 10, 60), ("crimp.fit.error_scan", 20, 40),
            ("toa_sweep_brute", 10, 15), ("aten::mul", 70, 80)]
    device = [("k", 12, 14), ("k", 50, 55), ("k", 90, 100)]
    c = ctx(host, device, 100)
    # idle 83 ns in all; the steps cover [10, 15] and [20, 40]: 3 + 20 idle
    assert spans.unattributed_pct(c) == pytest.approx(100 * (83 - 23) / 83)
    assert spans.is_step("crimp.fit.error_scan") and spans.is_step("toa_general_refine")
    assert not spans.is_step("crimp.fit") and not spans.is_step("crimp.pass") and not spans.is_step("aten::mul")


def test_launches_a_unit():
    host = [("toa_sweep_brute", 0, 1), ("toa_sweep_refine", 2, 3), ("toa_sweep_err_dense", 4, 5),
            ("toa_general_brute", 6, 7), ("aten::toa_sweep_", 8, 9)] * 2
    c = ctx(host, [], 10, units=2)
    assert spans.launches(c, "toa_sweep_") == 3
    assert spans.launches(c, "toa_general_") == 1


def test_nothing_to_read_is_none():
    c = ctx([("aten::mul", 0, 5), ("cudaLaunchKernel", 1, 2)], [("k", 0, 5)], 10)
    assert spans.idle_ms(c, spans.under("crimp.fold")) is None
    assert spans.unattributed_pct(c) is None
    assert spans.launches(c, "toa_sweep_") is None
    for name in ("scan_idle_ms.campaign", "fold_idle_ms.campaign", "fit_idle_ms.campaign", "htest_idle_ms.campaign",
                 "k5_launches.campaign", "idle_unattributed_pct.campaign", "fold_idle_ms.rv", "fit_idle_ms.rv",
                 "k6_launches.rv", "idle_unattributed_pct.rv", "idle_unattributed_pct.search"):
        assert harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(c) is None, name


def test_idle_ns_against_a_sweep_by_hand():
    busy = spans.union([(3, 5), (4, 8), (10, 11), (20, 30)])
    assert busy == [(3, 8), (10, 11), (20, 30)]
    assert spans.idle_ns([(0, 2)], busy) == 2
    assert spans.idle_ns([(0, 12)], busy) == 12 - 5 - 1
    assert spans.idle_ns([(4, 6), (9, 25)], busy) == 0 + 16 - 1 - 5
    assert spans.idle_ns([(31, 40)], busy) == 9
