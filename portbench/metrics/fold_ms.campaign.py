"""Mean time of a campaign pass's fold (host anchors, device fold), from the
program's own stage clock."""


def read(ctx):
    return ctx.stage_ms("fold")
