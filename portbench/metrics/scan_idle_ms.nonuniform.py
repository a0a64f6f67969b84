"""The device's idle milliseconds a period-stepped scan inside the scan's
spans (``crimp.scan`` and below)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.under("crimp.scan"))
