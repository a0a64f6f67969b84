"""The readvaryparam fit's row groups a -rv pass: the program's
``crimp.fit.group`` ranges, one round each group's chain of K6 launches,
over the passes."""

from portbench import spans


def read(ctx):
    return spans.launches(ctx, "crimp.fit.group")
