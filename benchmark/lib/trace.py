"""The profiler's side of a traced run: device events of the profiled
calls (torch.profiler, CPU and CUDA activities) reduced to what the
per-layer readers take, and the breakdown of the result line."""

from __future__ import annotations

import time

import torch


def profile(fn):
    """Run fn() under torch.profiler, synchronised at the end:
    (its result, the profiler, the wall seconds under the profiler)."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with prof_ctx(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, prof, wall


def _union(spans):
    """(busy us, merged [(start, end)]) of (start, end) intervals."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


class Reduced:
    """kernels / copies: [(name, start us, duration us)] of the device's
    kernel (Memset included) and Memcpy events; busy_s: the union of all
    of them; gaps: [(start us, end us)] between them; host: the CPU
    events [(name, start us, end us)]."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if e.name != "Activity Buffer Request":     # CUPTI's own
                    dev.append((e.name, tr.start, tr.end))
            else:
                host.append((e.name, tr.start, tr.end))
        self.copies = [(n, a, b - a) for n, a, b in dev
                       if n.startswith("Memcpy")]
        self.kernels = [(n, a, b - a) for n, a, b in dev
                        if not n.startswith("Memcpy")]
        busy, merged = _union((a, b) for _n, a, b in dev)
        self.busy_s = busy / 1e6
        self.gaps = [(merged[i][1], merged[i + 1][0])
                     for i in range(len(merged) - 1)]
        self.host = host


def _host_over(host, t: float) -> str:
    """The innermost host event running at time t."""
    best = None
    for n, a, b in host:
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (n, b - a)
    return best[0] if best else "(no host event)"


def breakdown(red: Reduced, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each named by the host event running over its middle."""
    totals = {}
    for n, _a, d in red.kernels + red.copies:
        totals[n] = totals.get(n, 0.0) + d
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(red.gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, d / 1e6] for n, d in ops],
            "idle_gaps": [[_host_over(red.host, (a + b) / 2), (b - a) / 1e6]
                          for a, b in gaps]}
