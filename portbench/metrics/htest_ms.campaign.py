"""Mean time of a campaign pass's per-ToA H-test, from the program's own
stage clock."""


def read(ctx):
    return ctx.stage_ms("htest")
