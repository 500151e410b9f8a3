"""Tracing and profiling hooks (port of
kalman_hydra_tpu/utils/profiling.py).

`trace(log_dir)` wraps a region in `torch.profiler.profile` (host
operators, and with a card its kernels and copies) and writes a Chrome
trace into `log_dir`; `span(name)` marks a stage of the program in
whatever `torch.profiler` session is recording, and costs one flag read
when none is; `cost(fn, *args)` runs fn once and reports its FLOPs
(`torch.utils.flop_counter.FlopCounterMode`) and its memory: argument
and output bytes, and with tensors on the card the peak card
allocation during the call.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict

import torch

# The program's stage spans (`span`), on the frame loop's thread; a
# span's parent is the span open around it. kh.call is one request
# (pipeline.track_clip, track_clips, track_stream). Inside it:
# kh.upload (host -> card copies), kh.flow (grayscale, flow pyramids,
# flow), kh.filter (the measurement update, the velocity priming),
# kh.lifecycle (corner pools, seeding, gate, kill, re-seed, fixed-lag
# push), kh.prefetch.wait (the stream's consumer waiting for its next
# frame), kh.rows.wait (a stream row's event wait and read-out) and
# kh.fetch (the results' device -> host read).
SPANS = ("kh.call", "kh.upload", "kh.flow", "kh.filter", "kh.lifecycle",
         "kh.prefetch.wait", "kh.rows.wait", "kh.fetch")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` (one of SPANS) as a range on the
    calling thread while a torch.profiler session records, on the
    profiler's clock beside the card's kernels and copies and in its
    Chrome trace; otherwise one shared no-op context. The range is a
    function-scope record (`_RecordFunctionFast`): a user annotation
    (`record_function`) would also put a copy of the range on the card's
    timeline, among the kernels."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def trace(log_dir: str = "./prof"):
    """Profile the enclosed region; its Chrome trace goes to
    `log_dir`/trace_<pid>_<n>.json (the directory is created)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len(os.listdir(log_dir))
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{n}.json"))


def _nbytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_nbytes(o) for o in obj.values())
    return 0


def _on_card(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, (tuple, list)):
        return any(_on_card(o) for o in obj)
    return False


def cost(fn, *args) -> Dict[str, Any]:
    """Run fn(*args) once and return {"cost": {"flops": ...},
    "memory": {"argument_bytes", "output_bytes", "peak_bytes"}}:
    the FLOPs that FlopCounterMode counts (the ATen operators it knows;
    a hand-written kernel's launch counts 0), the bytes of the tensor
    arguments and outputs, and the card's peak allocation during the call
    (None off the card)."""
    from torch.utils.flop_counter import FlopCounterMode
    card = _on_card(args)
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    peak = None
    if card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    return {"cost": {"flops": float(counter.get_total_flops())},
            "memory": {"argument_bytes": _nbytes(args),
                       "output_bytes": _nbytes(out), "peak_bytes": peak}}
