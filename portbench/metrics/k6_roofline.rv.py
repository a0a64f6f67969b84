"""K6's share of its roofline over the -rv window's fits (the count a lower
bound, ``counts/k6.py``)."""

from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "k6", readers.is_k6)
