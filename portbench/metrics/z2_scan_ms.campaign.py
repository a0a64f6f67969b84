"""Mean time of a campaign pass's 2-D Z^2 scan (K2 and its host wrapper),
from the program's own stage clock."""


def read(ctx):
    return ctx.stage_ms("z2_scan")
