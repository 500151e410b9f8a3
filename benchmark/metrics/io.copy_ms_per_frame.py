"""Stream IO and transfers: device time of the profiled calls' Memcpy
events per frame step, ms."""


def read(ctx):
    if not ctx.kernels or not ctx.steps:
        return None
    return sum(d for _n, _a, d in ctx.copies) / 1e3 / ctx.steps
