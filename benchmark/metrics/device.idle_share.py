"""Device: 1 - (union of the profiled calls' device events) / (their
unprofiled wall time), in %. The unprofiled wall is the median
unprofiled call times the profiled calls, or for a stream the profiled
frame steps at the window's unprofiled rate."""

import math


def read(ctx):
    if ctx.busy_s <= 0 or not ctx.unprofiled_s > 0 \
            or math.isnan(ctx.unprofiled_s):
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.unprofiled_s)
