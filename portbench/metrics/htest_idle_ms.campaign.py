"""The device's idle milliseconds a campaign pass inside the H-test's spans
(``crimp.htest`` and below: each ToA's rows, the H sums)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.under("crimp.htest"))
