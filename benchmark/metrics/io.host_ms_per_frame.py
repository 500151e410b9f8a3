"""Stream IO and transfers: the host side of the transfers, ms a
profiled frame step: the union of the time under the program's
kh.upload, kh.prefetch.wait, kh.rows.wait and kh.fetch spans inside its
kh.call spans (lib/spans.py), which the device's Memcpy time cannot
see."""

from benchmark.lib import spans


def read(ctx):
    got = spans.call_and_io_us(ctx)
    if got is None or not ctx.steps:
        return None
    return got[1] / 1e3 / ctx.steps
