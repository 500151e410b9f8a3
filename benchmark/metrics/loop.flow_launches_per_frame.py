"""Frame loop (host): launches (CUDA runtime calls that put a kernel or
a memset on the card) whose innermost program span is kh.flow, a
profiled frame step (lib/spans.py)."""

from benchmark.lib import spans


def read(ctx):
    return spans.launches_per_frame(ctx, "kh.flow")
