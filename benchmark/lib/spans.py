"""The program's stage spans (kh.*, kalman_hydra_tpu_torch/utils/
profiling.py) among a traced run's host events, for the per-layer
readers of the frame loop and of the transfers.

Host events are (name, start us, end us[, thread]): the program's spans,
torch's operators and the CUDA runtime's calls. A reader's context does
not carry them (harness._context), so `host(ctx)` takes them, with their
threads, from the profiler of the harness frame that built the context.
Only the frame loop's thread counts: the thread that opened the kh.call
spans (`on_loop_thread`, which tools/idle_by_span.py uses too). The
spans nest there, so the innermost span around an instant is the open
one that started last. A launch is a runtime call that puts a kernel or
a memset on the card; it belongs to the innermost span around its start.
Each reader returns None where what it reads is absent (a program
without spans, a CPU run)."""

from __future__ import annotations

import sys
from collections import Counter

CALL = "kh.call"
STAGES = ("kh.flow", "kh.filter", "kh.lifecycle")
IO = ("kh.upload", "kh.prefetch.wait", "kh.rows.wait", "kh.fetch")
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cudaMemsetAsync"))


def on_loop_thread(events) -> list:
    """(name, start, end) of the events on the thread that opened the
    most kh.call spans, from (name, start, end, thread) events; events
    without a thread, or with no kh.call among them, as they are."""
    if not events or len(events[0]) < 4:
        return events
    calls = Counter(t for n, _a, _b, t in events if n == CALL)
    if not calls:
        return [(n, a, b) for n, a, b, _t in events]
    loop = calls.most_common(1)[0][0]
    return [(n, a, b) for n, a, b, t in events if t == loop]


def _profiled(ctx) -> list:
    """The host events, with their threads, of the torch.profiler `prof`
    beside `ctx` in a calling frame (harness.run's), else []."""
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        if loc.get("ctx") is ctx and hasattr(loc.get("prof"), "events"):
            from torch.autograd import DeviceType
            return [(e.name, e.time_range.start, e.time_range.end, e.thread)
                    for e in loc["prof"].events()
                    if e.device_type != DeviceType.CUDA]
        f = f.f_back
    return []


def host(ctx) -> list:
    """The frame loop's host events, (name, start us, end us), of the
    traced run whose readers read `ctx`: from ctx.host if it has them,
    else from the profiler beside `ctx` in harness.run's frame."""
    got = getattr(ctx, "host", None)
    return on_loop_thread(_profiled(ctx) if got is None else got)


def union(spans) -> list:
    """Merged [start, end] of (start, end) intervals, in order."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _length(merged) -> float:
    return sum(b - a for a, b in merged)


def _within(merged, outer) -> list:
    """The parts of merged intervals that lie inside merged `outer`."""
    out, j = [], 0
    for a, b in merged:
        while j < len(outer) and outer[j][1] <= a:
            j += 1
        k = j
        while k < len(outer) and outer[k][0] < b:
            lo, hi = max(a, outer[k][0]), min(b, outer[k][1])
            if lo < hi:
                out.append([lo, hi])
            k += 1
    return out


def _ranges(events, names) -> list:
    return [(a, b) for n, a, b in events if n in names]


def call_and_io_us(ctx):
    """(union of kh.call, union of the IO spans inside it), in us; None
    without kh.call or IO spans."""
    events = host(ctx)
    call = union(_ranges(events, (CALL,)))
    io = union(_ranges(events, IO))
    if not call or not io:
        return None
    return _length(call), _length(_within(io, call))


def launches_by_span(events) -> dict:
    """{innermost kh.* span or None: launches} over host events."""
    items = [(a, 0, -(b - a), b, n) for n, a, b in events
             if n.startswith("kh.")]
    items += [(a, 1, 0.0, a, n) for n, a, _b in events if n in LAUNCHES]
    counts, stack = {}, []
    for t, kind, _neg, end, name in sorted(items):
        while stack and stack[-1][0] < t:
            stack.pop()
        if kind == 0:
            stack.append((end, name))
        else:
            key = stack[-1][1] if stack else None
            counts[key] = counts.get(key, 0) + 1
    return counts


def launches_per_frame(ctx, stage: str):
    """Launches whose innermost span is `stage`, a profiled frame step;
    None without frame steps, stage spans or launches."""
    events = host(ctx)
    if not ctx.steps or not _ranges(events, STAGES) \
            or not any(n in LAUNCHES for n, _a, _b in events):
        return None
    return launches_by_span(events).get(stage, 0) / ctx.steps
