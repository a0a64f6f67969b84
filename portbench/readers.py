"""What the per-layer metrics' readers share: kernels by name, rooflines.

A reader returns None where its run has nothing to read (no such kernel
ran, no count), and the harness then leaves the metric out of the line.
"""

from __future__ import annotations

import statistics

from portbench.counts import peaks


def is_k2(name: str) -> bool:
    """K2's launches: the tile kernel and its split reduction."""
    return "z2_tile_kernel" in name or "z2_reduce_splits" in name


def is_k5(name: str) -> bool:
    """K5's launches: the profile sweep and the ToA fit's golden refine
    (``golden_kernel`` over ``RowArgs``; K6's takes other arguments)."""
    return "profile_kernel" in name or ("golden_kernel" in name and "RowArgs" in name)


def is_k6(name: str) -> bool:
    """K6's launches: the readvaryparam Nelder-Mead, its golden refine
    (``golden_kernel`` over ``Args``, not K5's ``RowArgs``) and the
    evaluation kernel."""
    return "nm_kernel" in name or "eval_kernel" in name or ("golden_kernel" in name and "RowArgs" not in name)


def roofline_pct(ctx, key: str, match) -> float | None:
    """100 x the kernel's bound time over its device time in the window."""
    counts = ctx.counts.get(key)
    device_s = ctx.trace.kernel_seconds(match)
    if not counts or device_s <= 0:
        return None
    return 100.0 * peaks.bound_seconds(counts) / device_s


def idle_pct(ctx) -> float | None:
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def unit_p95_s(ctx) -> float | None:
    """95th percentile of the units' host-clock durations."""
    values = [r["seconds"] for r in ctx.records]
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=20, method="inclusive")[18]
