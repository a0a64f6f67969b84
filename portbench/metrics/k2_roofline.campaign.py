"""K2's share of its roofline over the campaign window's scans."""

from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "k2", readers.is_k2)
