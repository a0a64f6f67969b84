"""The device's idle milliseconds a campaign pass inside the ToA fit's
spans (``crimp.fit`` and below): the host work round K5's launches."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.under("crimp.fit"))
