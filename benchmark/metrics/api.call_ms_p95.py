"""API / driver layer: the 95th percentile of the host-clock time of the
unprofiled calls (call to trajectories on the host), ms. Clip and batch
calls only; a stream is one call."""

import statistics


def read(ctx):
    if ctx.kind == "stream" or len(ctx.call_ms) < 2:
        return None
    return statistics.quantiles(ctx.call_ms, n=100, method="inclusive")[94]
