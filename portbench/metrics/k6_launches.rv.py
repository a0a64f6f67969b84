"""K6's launches a -rv pass: the program's ``toa_general_*`` kernel-site
ranges, one a launch, over the passes."""

from portbench import spans


def read(ctx):
    return spans.launches(ctx, "toa_general_")
