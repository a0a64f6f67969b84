"""The device's idle milliseconds a campaign pass inside the fold's spans
(``crimp.fold`` and below: slicing, anchors, the fold, padding)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.under("crimp.fold"))
