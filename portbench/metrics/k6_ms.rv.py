"""K6's device time a -rv pass: every launch of its Nelder-Mead, golden
and evaluation kernels in the window, over the passes."""

from portbench import readers


def read(ctx):
    seconds = ctx.trace.kernel_seconds(readers.is_k6)
    return 1e3 * seconds / len(ctx.records) if seconds > 0 and ctx.records else None
