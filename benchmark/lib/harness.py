"""One run of one cell: set-up, the measured window, the traced part (with
--trace 1), the output check against the reference, and the result
line's fields.

`run` takes the device and, for the CPU tests, a program and a frame size
of their own; the command line (run.py) always asks for the card.
"""

from __future__ import annotations

import math
import statistics
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark.reference import tracker
from . import card, check, drivers, roofline, spec, trace


def _e2e(cell, values: dict) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def _context(drv, cell, frame: dict, calls, pcalls, red, window_s: float,
             root: Path):
    """What the per-layer readers read (see metrics/)."""
    ok = [c for c in calls if c.error is None]
    call_ms = [(c.end - c.start) * 1e3 for c in ok]
    steps = sum(c.steps for c in pcalls if c.error is None)
    if cell.traffic["driver"] == "stream":
        done = sum(c.steps for c in ok)
        unprof = steps * window_s / done if done else math.nan
    else:
        unprof = (statistics.median(call_ms) / 1e3 * len(pcalls)
                  if call_ms else math.nan)
    stages = roofline.least_seconds(cell.config["stages"],
                                    cell.config["run_config"], frame,
                                    drv.counts(pcalls), root)
    return SimpleNamespace(kind=cell.traffic["driver"], call_ms=call_ms,
                           steps=steps, kernels=red.kernels,
                           copies=red.copies, busy_s=red.busy_s,
                           unprofiled_s=unprof, stages=stages,
                           least_s=sum(stages.values()))


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        root: Path = spec.ROOT, device: str = "cuda", program=None,
        frame: dict = None, t0: float = None, trace_dir: Path = None):
    """(result dict, log lines for standard error)."""
    t0 = time.perf_counter() if t0 is None else t0
    marks = [("imports", time.perf_counter())]
    cell = spec.cell(spec.load(root), workload, root)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        card.require(cell.chips)
    frame = dict(frame or cell.config["frame"])
    run_cfg = cell.config["run_config"]
    tracker.covers(run_cfg)
    if program is None:
        program = drivers.Program(run_cfg, device)
    marks.append(("card and program", time.perf_counter()))
    drv = drivers.make(cell.traffic, frame, run_cfg, seed, device, program)
    marks.append(("footage", time.perf_counter()))
    drv.warm()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    log = ["set-up by part: " + ", ".join(
        f"{n} {b - a:.3f} s" for (n, b), (_m, a)
        in zip(marks, [("start", t0)] + marks[:-1]))]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    calls = drv.window(seconds)
    drivers.sync(device)
    window_s = calls[-1].end - calls[0].start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    done = sum(c.steps for c in calls if c.error is None)
    log.append(f"window: {len(calls)} calls, {done} frame steps in "
               f"{window_s:.4f} s; set-up {setup_s:.4f} s; peak card memory "
               f"{peak} bytes")
    ms = sorted((c.end - c.start) * 1e3 for c in calls)
    log.append(f"calls: min {ms[0]:.3f} ms, median {statistics.median(ms):.3f}"
               f" ms, max {ms[-1]:.3f} ms")
    by_item = {}
    for c in calls:
        by_item.setdefault(c.item, []).append((c.end - c.start) * 1e3)
    log.append("median call by pool item: " + ", ".join(
        f"{i} {statistics.median(v):.3f} ms"
        for i, v in sorted(by_item.items())))
    values = {"frames_per_s": done / window_s, "setup_s": setup_s}
    metrics = _e2e(cell, values) if not traced else {}
    pcalls, extra = [], {}
    if traced:
        pcalls, prof, wall = trace.profile(
            lambda: drv.profiled(len(calls)))
        red = trace.Reduced(prof)
        ctx = _context(drv, cell, frame, calls, pcalls, red, window_s,
                       root)
        log.append(f"trace: {len(pcalls)} profiled calls, {ctx.steps} frame "
                   f"steps, {len(red.kernels)} kernel and {len(red.copies)} "
                   f"copy events, busy {red.busy_s:.6f} s of {wall:.6f} s "
                   f"under the profiler, {ctx.unprofiled_s:.6f} s unprofiled; "
                   f"least time by stage {ctx.stages}")
        if ctx.call_ms:
            log.append(f"api calls timed for the tail: {len(ctx.call_ms)}")
        for m in cell.per_layer:
            v = spec.reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": red.busy_s, "window_s": wall}
        breakdown = trace.breakdown(red)
        if trace_dir is not None:
            Path(trace_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(
                str(Path(trace_dir) / f"{workload}.json"))
        del prof, red
    all_calls = calls + pcalls
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    with torch.no_grad():
        ref = drv.reference(all_calls)
    verdict = check.judge(drv, all_calls, ref, cell.limits)
    log.append(f"reference: {len(ref)} clips in "
               f"{time.perf_counter() - t_ref:.2f} s")
    log += [f"error: {e}" for e in verdict["errors"]]
    checked = check.lines(verdict["worst"], cell.limits, verdict["failed"])
    log += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in checked.items()]
    dev = (card.describe(cell.chips, peak) if on_card else
           {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0})
    dev.update(extra)
    result = {"correct": len(all_calls) > 0 and verdict["failed"] == 0,
              "attempted": len(all_calls), "failed": verdict["failed"],
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = breakdown
    result["check"] = checked
    return result, log
