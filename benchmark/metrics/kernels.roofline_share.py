"""Kernels and glue: the least time the card could take for the profiled
frames' work (lib/roofline.py, the stages in roofline/) over the device
time of all their kernels, copies left out, in %."""


def read(ctx):
    kernel_us = sum(d for _n, _a, d in ctx.kernels)
    if kernel_us <= 0 or ctx.least_s <= 0:
        return None
    return 100.0 * ctx.least_s / (kernel_us / 1e6)
