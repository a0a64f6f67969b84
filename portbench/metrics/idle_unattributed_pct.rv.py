"""Share of the -rv window's device idle time inside no step span
of the program (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.unattributed_pct(ctx)
