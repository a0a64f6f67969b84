"""95th percentile of the campaign window's pass times, host clock."""

from portbench import readers


def read(ctx):
    return readers.unit_p95_s(ctx)
