"""K5's launches a campaign pass: the program's ``toa_sweep_*`` kernel-site
ranges, one a launch, over the passes."""

from portbench import spans


def read(ctx):
    return spans.launches(ctx, "toa_sweep_")
