"""Share of the period-stepped search window in which no operation ran on
the card."""

from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
