"""The device's idle milliseconds a -rv pass inside the readvaryparam fit's
spans (``crimp.fit`` and below): the host gaps round K6's launches."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.under("crimp.fit"))
