"""Frame loop (host): device kernel events of the profiled calls, glue
included, per frame step."""


def read(ctx):
    if not ctx.kernels or not ctx.steps:
        return None
    return len(ctx.kernels) / ctx.steps
