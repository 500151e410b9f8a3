#!/usr/bin/env python3
"""The card's idle time by the program's stage span, from a Chrome trace.

    python3 tools/idle_by_span.py TRACE.json [--steps N]

TRACE.json is a trace of torch.profiler that names the program's spans
(kalman_hydra_tpu_torch/utils/profiling.py::SPANS): the one that
`benchmark/run.py --trace 1` writes (build/benchmark/<cell>.json), or one
of `python -m kalman_hydra_tpu_torch track ... --profile DIR`. The card
is idle where none of its kernels, memsets or copies runs, from the
trace's first such event or span to its last. Each idle instant goes to
the innermost kh.* span open then on the frame loop's thread (the thread
of the kh.call spans), or to "(outside kh.call)". The script prints, for
each, the idle ms a frame step and its share of the idle time, and the
launches (CUDA runtime calls that put a kernel or a memset on the card)
a frame step whose innermost span it is. Frame steps are the kh.filter
spans (one a frame step of every clip; one more a call with
init_velocity), or --steps N.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmark.lib import spans as kh  # noqa: E402

DEVICE = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
OUTSIDE = "(outside kh.call)"


def _segments(spans, w0: float, w1: float) -> list:
    """[(start, end, innermost span or OUTSIDE)] covering [w0, w1], from
    (start, end, name) spans that nest."""
    segs, stack, t = [], [], w0

    def cut(a, b, label):
        if b > a:
            segs.append((a, b, label))

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            cut(t, end, top)
            t = max(t, end)
        cut(t, a, stack[-1][1] if stack else OUTSIDE)
        t = max(t, a)
        stack.append((b, name))
    while stack:
        end, top = stack.pop()
        cut(t, end, top)
        t = max(t, end)
    cut(t, w1, OUTSIDE)
    return segs


def idle_by_span(events) -> dict:
    """{"window_us", "busy_us", "idle_us": {label: us}, "launches":
    {label: n}, "filter_spans"} of a Chrome trace's events."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not any(e.get("name") == kh.CALL for e in xs):
        raise ValueError("no kh.call span in the trace")
    events = kh.on_loop_thread(
        [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
          (e["pid"], e["tid"])) for e in xs if e.get("cat") not in DEVICE])
    spans = [(a, b, n) for n, a, b in events if n.startswith("kh.")]
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
           if e.get("cat") in DEVICE]
    w0 = min([a for a, _b, _n in spans] + [a for a, _b in dev])
    w1 = max([b for _a, b, _n in spans] + [b for _a, b in dev])
    segs = _segments(spans, w0, w1)
    busy = kh.union(dev)
    idle, t = [], w0
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if w1 > t:
        idle.append((t, w1))
    out, j = Counter(), 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] += hi - lo
            k += 1
    launches = {OUTSIDE if k is None else k: n
                for k, n in kh.launches_by_span(events).items()}
    return {"window_us": w1 - w0, "busy_us": sum(b - a for a, b in busy),
            "idle_us": dict(out), "launches": launches,
            "filter_spans": sum(1 for _a, _b, n in spans
                                if n == "kh.filter")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace")
    p.add_argument("--steps", type=int, default=0,
                   help="frame steps in the trace (default: its kh.filter "
                   "spans)")
    args = p.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    r = idle_by_span(events)
    steps = args.steps or r["filter_spans"]
    if not steps:
        print("no frame steps: pass --steps", file=sys.stderr)
        return 2
    idle = sum(r["idle_us"].values())
    print(f"{args.trace}: window {r['window_us'] / 1e3:.3f} ms, card busy "
          f"{r['busy_us'] / 1e3:.3f} ms, idle {idle / 1e3:.3f} ms "
          f"({100 * idle / r['window_us']:.1f}%), {steps} frame steps"
          f" ({'--steps' if args.steps else 'kh.filter spans'})")
    print(f"{'innermost span':<20} {'idle ms/step':>13} {'idle share':>11}"
          f" {'launches/step':>14}")
    labels = sorted(set(r["idle_us"]) | set(r["launches"]),
                    key=lambda k: -r["idle_us"].get(k, 0.0))
    for k in labels:
        us = r["idle_us"].get(k, 0.0)
        print(f"{k:<20} {us / 1e3 / steps:>13.4f} "
              f"{100 * us / idle if idle else 0.0:>10.1f}% "
              f"{r['launches'].get(k, 0) / steps:>14.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
