"""The frozen counts against values worked by hand."""

import numpy as np
import pytest

from portbench.counts import k2, k5, k6, peaks


def test_k2_flops_per_pair():
    # nharm 2, R 8: 3 + 6 + (6 * 7 + 29) / 8 + (1 + 24 / 8) / 256
    assert k2.flops_per_pair(2) == pytest.approx(17.890625)
    # nharm 5, R 4: 3 + 24 + (18 + 29) / 4 + (1 + 6) / 256
    assert k2.flops_per_pair(5) == pytest.approx(27 + 11.75 + 7 / 256)


def test_k2_scan_counts():
    c = k2.scan_counts(n_events=1000, n_freq=300, n_rows=2, nharm=2)
    assert c["flops"] == pytest.approx(300 * 2 * 1000 * 17.890625)
    # events 8000, rows 16, sums: 2 (C, S) x 2 rows x 2 tiles x 2 harmonics x 256 x 4 bytes
    assert c["bytes"] == 8000 + 16 + 2 * 2 * 2 * 2 * 256 * 4
    assert c["dtype"] == "f32"


def test_k5_counts():
    assert k5.ops_per_event(6) == 24 + 1 + 100 + 6
    s = k5.sweep_counts([10, 10], 3, 6)
    assert s["flops"] == 2 * 3 * 10 * 131
    assert s["bytes"] == 2 * 10 * 9 + 2 * 8 + 2 * 3 * 8 + 8 * 20 + 3 * 2 * 3 * 8
    fit = k5.fit_counts([10, 10], 6, n_brute=4, refine_iters=1, loop_shifts=5, loop_events=50)
    # brute 2 x 4, golden 2 x 4 one-shift sweeps, first window 2 x 64, loop 5 shifts of 10 events
    assert fit["flops"] == (2 * 4 + 2 * 4 + 2 * 64 + 5) * 10 * 131


def test_k5_counts_sum_each_rows_own_events():
    # rows of 4 and 16 events: a sweep at 2 shifts reads 20 events twice
    s = k5.sweep_counts([4, 16], 2, 6)
    assert s["flops"] == 2 * 20 * 131
    assert s["bytes"] == 20 * 9 + 2 * 8 + 2 * 2 * 8 + 8 * 20 + 3 * 2 * 2 * 8
    # the error scan's loop: 3 shifts of the 16-event row
    fit = k5.fit_counts([4, 16], 6, n_brute=1, refine_iters=0, loop_shifts=3, loop_events=48)
    assert fit["flops"] == (1 + 2 + 64) * 20 * 131 + 48 * 131


def test_bound_seconds():
    assert peaks.bound_seconds({"flops": 67e12, "bytes": 1.0, "dtype": "f32"}) == pytest.approx(1.0)
    assert peaks.bound_seconds({"flops": 1.0, "bytes": 3.35e12, "dtype": "f64"}) == pytest.approx(1.0)


def test_check_indices_cover_every_block_of_every_row():
    from portbench import scan

    grid = {"freq_lo": 0.1, "freq_hi": 0.2, "n_freq": 70, "log_fdot_lo": -14, "log_fdot_hi": -13, "n_fdot": 6}
    sets = [scan.check_indices(grid, 99, k, 4, n_random=5, stride=16, edge_rows=2) for k in range(4)]
    every = np.unique(np.concatenate(sets))
    rows, freqs = every // 70, every % 70
    # one trial at least in each block (16-wide, the last ragged: 64-69) of each row
    assert {(r, f // 16) for r, f in zip(rows, freqs)} == {(r, b) for r in range(6) for b in range(5)}
    for picked in sets:
        assert {0, 69} <= set(picked % 70) and set(np.arange(6) * 70) <= set(picked)
        assert set(np.arange(6) * 70 + 69) <= set(picked)
        edges = [(i // 70, i % 70) for i in picked if i % 70 in (15, 16)]
        assert len({r for r, _ in edges}) >= 2  # block edges in two rows at least
    # a set draws the same trials from the same seed
    assert np.array_equal(sets[1], scan.check_indices(grid, 99, 1, 4, 5, 16, 2))


def test_k6_lower_bound():
    assert k6.ops_per_event(6) == 36
    # rows of 10 and 30 events; problems 4 brute + (2 + 2 x 1) golden + 2 x 2 dense = 12,
    # each F + 1 + iters = 3 + 1 + 5 = 9 evaluations
    c = k6.fit_counts([10, 30], 6, n_free=3, nm_iters=5, n_brute=4, refine_iters=1, dense_window=2)
    assert c["flops"] == 40 * 12 * 9 * 36
    assert c["bytes"] == 3 * 9 * 40 and c["dtype"] == "f64"
