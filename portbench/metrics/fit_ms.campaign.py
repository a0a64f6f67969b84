"""Mean time of a campaign pass's batched ToA fit (K5), from the program's
own stage clock."""


def read(ctx):
    return ctx.stage_ms("fit")
