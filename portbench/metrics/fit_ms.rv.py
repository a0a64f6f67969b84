"""Mean time of a -rv pass's readvaryparam fit (K6), host clock from the
fold's end to the fit's numpy results."""


def read(ctx):
    return ctx.stage_ms("fit")
