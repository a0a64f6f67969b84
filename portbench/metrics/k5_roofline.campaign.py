"""K5's share of its roofline over the campaign window's ToA fits."""

from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "k5", readers.is_k5)
