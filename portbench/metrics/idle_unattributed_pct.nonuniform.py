"""Share of the period-stepped search window's device idle time inside no
step span of the program: the steps of ``portbench/spans.py`` and K3's
kernel-site range ``general_sums``."""

from portbench import spans

K3_SITE = "general_sums"


def is_step(name: str) -> bool:
    return name == K3_SITE or spans.is_step(name)


def read(ctx):
    found = spans.ranges(ctx, is_step)
    busy = ctx.trace.busy_intervals()
    idle = ctx.trace.window_s * 1e9 - sum(b - a for a, b in busy)
    if not found or idle <= 0:
        return None
    return 100.0 * (idle - spans.idle_ns(spans.union(found), busy)) / idle
