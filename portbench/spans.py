"""Reading the program's own spans out of a window's trace.

While ``torch.profiler`` records, the program marks its work with ranges
of the profiler's timeline: a layer span round each layer's work in a
call (``crimp.fit``), step spans round each stretch of host work in it
(``crimp.fit.error_scan``) and a kernel-site range round each hand-kernel
launch (``toa_sweep_brute``). ``Trace`` keeps them among its host
operations (name, start ns, end ns), on the device operations' clock. A
program without such ranges leaves nothing to read: each reader then
returns None.

The device's idle time inside some ranges is their union less the union
of the device's busy intervals. A step is a ``crimp.<layer>.<step>`` span
or a kernel site; the layer spans and ``crimp.pass`` are not steps.
"""

from __future__ import annotations

# the kernel sites on the cells' paths, by name prefix, one range a launch
SITES = ("grid_sums_2d", "anchored_fold", "toa_sweep_", "toa_general_")


def under(*layers: str):
    """A name test: the span ``layer`` itself and every span below it
    (``crimp.fold`` matches ``crimp.fold`` and ``crimp.fold.pad``)."""
    return lambda name: any(name == layer or name.startswith(layer + ".") for layer in layers)


def is_step(name: str) -> bool:
    return name.startswith(SITES) or (name.startswith("crimp.") and name.count(".") >= 2)


def union(intervals) -> list[tuple[int, int]]:
    """The sorted, disjoint union of (start, end) intervals."""
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_ns(spans: list, busy: list) -> int:
    """Nanoseconds of the disjoint sorted ``spans`` that no interval of the
    disjoint sorted ``busy`` covers."""
    total, j = 0, 0
    for a, b in spans:
        total += b - a
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            total -= min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return total


def ranges(ctx, match) -> list[tuple[int, int]]:
    """(start, end) of every host range whose name ``match`` accepts."""
    return [(a, b) for name, a, b in ctx.trace.host_ops if match(name)]


def idle_ms(ctx, match) -> float | None:
    """The device's idle milliseconds a unit inside the ranges ``match``
    accepts; None when there are none."""
    found = ranges(ctx, match)
    if not found or not ctx.records:
        return None
    return idle_ns(union(found), ctx.trace.busy_intervals()) / 1e6 / len(ctx.records)


def unattributed_pct(ctx) -> float | None:
    """Share of the window's device idle time inside no step span."""
    found = ranges(ctx, is_step)
    busy = ctx.trace.busy_intervals()
    idle = ctx.trace.window_s * 1e9 - sum(b - a for a, b in busy)
    if not found or idle <= 0:
        return None
    return 100.0 * (idle - idle_ns(union(found), busy)) / idle


def launches(ctx, prefix: str) -> float | None:
    """Kernel-site ranges a unit whose name starts with ``prefix``."""
    n = sum(1 for name, _, _ in ctx.trace.host_ops if name.startswith(prefix))
    return n / len(ctx.records) if n and ctx.records else None
