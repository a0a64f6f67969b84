"""Mean time of a campaign pass's .tim conversion and write, from the
program's own stage clock."""


def read(ctx):
    return ctx.stage_ms("tim")
