"""The device's idle milliseconds a campaign pass inside the scan's spans
(``crimp.scan`` and below) and the pass's preparation (``crimp.pass.prep``)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.under("crimp.scan", "crimp.pass.prep"))
