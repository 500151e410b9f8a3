"""Frame loop (host): the host's own time issuing work, ms a profiled
frame step: the union of the program's kh.call spans less the union of
the time under its transfer and wait spans (kh.upload, kh.prefetch.wait,
kh.rows.wait, kh.fetch) inside them (lib/spans.py)."""

from benchmark.lib import spans


def read(ctx):
    got = spans.call_and_io_us(ctx)
    if got is None or not ctx.steps:
        return None
    call_us, io_us = got
    return (call_us - io_us) / 1e3 / ctx.steps
