"""The port's stage spans (utils/profiling.span) on the CPU: with no
profiler recording a span is one shared no-op that enters no record;
under torch.profiler the entry points show their stages (kh.flow,
kh.filter, kh.lifecycle in every frame step, nested under the call's
kh.call, and the stream's waits); every span name the program opens is declared
in SPANS; and a traced call returns the untraced call's results bit for
bit."""

import dataclasses
import json
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.config import FlowConfig, RunConfig, TrackConfig
from kalman_hydra_tpu_torch.io.synthetic import moving_blob_clip
from kalman_hydra_tpu_torch.utils import profiling
import torch_threads  # noqa: F401  (one torch thread a worker)

PKG = Path(tp.__file__).resolve().parent
_CFG = RunConfig(flow=FlowConfig(levels=2),
                 tracks=TrackConfig(num_tracks=8, corner_pool=16,
                                    reinit_every=2))
_PAIRS = _CFG.replace(pair_batch=True)
T = 4


@pytest.fixture(scope="module")
def clips():
    return np.stack([moving_blob_clip(num_frames=T, height=48, width=64,
                                      num_points=8, seed=s)[0]
                     for s in (1, 2)])


def _entry(name, clips):
    """A zero-argument call of one entry point on the test clips."""
    if name == "clip":
        return lambda: [tp.track_clip(clips[0], _CFG, device="cpu")]
    if name == "pairs":
        return lambda: tp.track_clips(clips, _PAIRS, device="cpu")
    return lambda: [tp.track_stream(iter(clips[0]), _CFG, device="cpu")]


def _spans(fn):
    """(fn's result, [(span, parent span or None)]) of the kh.* ranges
    recorded while fn ran under torch.profiler; a span's parent is the
    shortest other kh.* range around it on its thread. No span is a user
    annotation, which the profiler would copy onto the card's timeline."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [(e.name, e.thread, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name in profiling.SPANS]
    assert not any(e.is_user_annotation for e in prof.events()
                   if e.name in profiling.SPANS)
    found = []
    for i, (n, th, a, b) in enumerate(evs):
        around = [(d - c, m) for j, (m, t2, c, d) in enumerate(evs)
                  if j != i and t2 == th and c <= a and b <= d]
        found.append((n, min(around)[1] if around else None))
    return out, found


def _under_call(found):
    """kh.call is the root; every other span has a kh.* parent."""
    for n, p in found:
        if n == "kh.call":
            assert p is None
        else:
            assert p is not None, n
            assert p in profiling.SPANS


def test_off_is_one_shared_noop(monkeypatch, clips):
    """No profiler: span() is the one shared no-op context and never
    builds a record; a whole call with every record builder broken
    still runs."""
    def refuse(*_a, **_k):
        raise AssertionError("a record was built with no profiler on")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("kh.flow")
    assert off is profiling.span("kh.call") is profiling._OFF
    with off:
        pass
    tr = tp.track_clip(clips[0], _CFG, device="cpu")
    assert tr.positions.shape == (T, 8, 2)


def test_span_names_are_declared():
    """Every span("...") the port opens names one of SPANS, and each of
    SPANS is opened somewhere."""
    used = set()
    for f in PKG.rglob("*.py"):
        used |= set(re.findall(r'\bspan\("([^"]+)"\)', f.read_text()))
    assert used == set(profiling.SPANS)


def test_clip_spans(clips):
    """track_clip: a frame step in the program's order, kh.flow (the
    pyramid), kh.lifecycle (the corner pool), kh.flow (the flow),
    kh.filter, kh.lifecycle (the tail); frame 0's grayscale, seeding and
    pyramid (flow, lifecycle, flow); the upload and the fetch; all under
    the call's one kh.call."""
    _, found = _spans(_entry("clip", clips))
    n = Counter(s for s, _ in found)
    assert n == {"kh.call": 1, "kh.upload": 1, "kh.flow": 2 * T,
                 "kh.filter": T - 1, "kh.lifecycle": 2 * T - 1,
                 "kh.fetch": 1}
    assert {p for s, p in found if s != "kh.call"} == {"kh.call"}
    _under_call(found)


def test_pair_batch_spans(clips):
    """track_clips with pair_batch: one kh.flow a call (every clip's
    flow at once), then a kh.filter and a kh.lifecycle a frame step of
    every clip (and two kh.lifecycle a clip: its seeding, then its corner
    pools)."""
    _, found = _spans(_entry("pairs", clips))
    n = Counter(s for s, _ in found)
    B = clips.shape[0]
    assert n["kh.call"] == 1 and n["kh.upload"] == 1
    assert n["kh.flow"] == 1
    assert n["kh.filter"] == B * (T - 1)
    assert n["kh.lifecycle"] == B * (T - 1) + 2 * B
    assert n["kh.fetch"] >= 1
    for s in ("kh.upload", "kh.flow", "kh.filter", "kh.lifecycle"):
        assert {p for m, p in found if m == s} == {"kh.call"}
    _under_call(found)


def test_stream_spans(clips):
    """track_stream: the stage spans of every frame step, the
    consumer's wait for each next frame (and for the end of the
    stream), a row's wait and read-out a step (and the last), under
    one kh.call."""
    _, found = _spans(_entry("stream", clips))
    n = Counter(s for s, _ in found)
    assert n["kh.call"] == 1
    assert n["kh.flow"] == 2 * T and n["kh.filter"] == T - 1
    assert n["kh.lifecycle"] == 2 * T - 1
    assert n["kh.prefetch.wait"] == T
    assert n["kh.rows.wait"] == T
    assert n["kh.fetch"] == 1               # frame 0's row
    for s in ("kh.prefetch.wait", "kh.rows.wait", "kh.flow", "kh.filter",
              "kh.lifecycle"):
        assert {p for m, p in found if m == s} == {"kh.call"}
    _under_call(found)


@pytest.mark.parametrize("entry", ["clip", "pairs", "stream"])
def test_traced_equals_untraced(entry, clips):
    """Under the profiler each entry point returns the same trajectories,
    bit for bit, as without it."""
    fn = _entry(entry, clips)
    plain = fn()
    traced, found = _spans(fn)
    assert found
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        for f in ("positions", "alive", "nis", "track_id"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape
            assert np.array_equal(x, y, equal_nan=True), f


# operators a call may run outside its stages: the output's assembly
# and conversions, the allocations around them, make_step's noise
# constants (eye, mul)
_GLUE = frozenset("aten::" + n for n in (
    "stack cat select slice view as_strided narrow to _to_copy copy_ "
    "lift_fresh detach resolve_conj resolve_neg empty empty_like "
    "empty_strided zeros_like zero_ resize_ eye mul").split())


def _with_smooth(cfg, **kw):
    return cfg.replace(smooth=dataclasses.replace(cfg.smooth, enabled=True,
                                                  **kw))


@pytest.mark.parametrize("case", ["stream_seeds_lag", "stream_chunk",
                                  "stream_resume", "clip_chunk",
                                  "clip_lag_seeds"])
def test_stages_cover_the_call(case, clips, tmp_path):
    """Seeds, a resumed stream and every smoother: the seeding, the
    resumed carry's pool and pyramid and the final smoothing run inside
    a stage span, so no operator but the glue runs under kh.call
    alone."""
    frames = clips[0]
    seeds = np.array([[10.0, 12.0], [30.0, 20.0]] * 4, np.float32)
    lag, chunk = _with_smooth(_CFG, lag=2), _with_smooth(_CFG, chunk=2)
    ck = str(tmp_path / "ck.npz")
    tp.track_stream(iter(frames[:3]), _CFG, checkpoint_path=ck,
                    checkpoint_every=2, device="cpu")
    fn = {"stream_seeds_lag": lambda: tp.track_stream(
              iter(frames), lag, seeds=seeds, device="cpu"),
          "stream_chunk": lambda: tp.track_stream(iter(frames), chunk,
                                                  device="cpu"),
          "stream_resume": lambda: tp.track_stream(
              iter(frames), _CFG, checkpoint_path=ck, resume=True,
              device="cpu"),
          "clip_chunk": lambda: tp.track_clip(frames, chunk, device="cpu"),
          "clip_lag_seeds": lambda: tp.track_clip(frames, lag, seeds=seeds,
                                                  device="cpu")}[case]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    evs = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()]
    kh = [(b - a, a, b, n) for n, a, b in evs if n in profiling.SPANS]

    def innermost(t):
        around = [(d, n) for d, a, b, n in kh if a <= t <= b]
        return min(around)[1] if around else None

    alone = {n for n, a, _b in evs
             if n.startswith("aten::") and innermost(a) == "kh.call"}
    assert alone <= _GLUE, alone - _GLUE
    staged = Counter(innermost(a) for n, a, _b in evs
                     if n.startswith("aten::"))
    assert staged["kh.flow"] and staged["kh.lifecycle"]


def _tool():
    import importlib.util
    path = PKG.parent / "tools" / "idle_by_span.py"
    spec = importlib.util.spec_from_file_location("idle_by_span", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_idle_by_span_splits_the_idle_time():
    """tools/idle_by_span.py on a made-up trace: each idle instant goes
    to the innermost span open on the loop's thread, each launch to the
    innermost span around its start."""
    def x(name, ts, dur, cat="cpu_op", tid=7):
        return {"ph": "X", "name": name, "cat": cat, "pid": 1, "tid": tid,
                "ts": ts, "dur": dur}
    events = [x("kh.call", 0, 100), x("kh.flow", 10, 30),
              x("kh.fetch", 20, 10), x("aten::add", 11, 2),
              x("cudaLaunchKernel", 11, 1, "cuda_runtime"),
              x("cudaMemsetAsync", 45, 1, "cuda_runtime"),
              x("cudaLaunchKernel", 5, 1, "cuda_runtime", tid=8),
              x("k", 12, 6, "kernel", tid=0), x("m", 50, 5, "gpu_memcpy", 0),
              x("s", 55, 5, "gpu_memset", tid=0)]
    r = _tool().idle_by_span(events)
    assert r["window_us"] == 100 and r["busy_us"] == 16
    assert r["idle_us"] == {"kh.call": 60, "kh.flow": 14, "kh.fetch": 10}
    assert r["launches"] == {"kh.flow": 1, "kh.call": 1}
    assert r["filter_spans"] == 0


def test_idle_by_span_reads_a_profile(tmp_path, clips, capsys):
    """The script on a `track --profile` trace: the spans are found on
    the loop's thread, one kh.filter a frame step, and on the CPU the
    whole window is idle and split among the spans."""
    from kalman_hydra_tpu_torch.cli import main
    path = str(tmp_path / "clip.npz")
    np.savez_compressed(path, frames=clips[0])
    prof = tmp_path / "prof"
    assert main(["track", path, "--out", str(tmp_path / "t.npz"),
                 "--tracks", "8", "--profile", str(prof),
                 "--device", "cpu"]) == 0
    trace = str(next(prof.iterdir()))
    tool = _tool()
    assert tool.main([trace]) == 0
    assert "kh.flow" in capsys.readouterr().out
    with open(trace) as f:
        r = tool.idle_by_span(json.load(f)["traceEvents"])
    assert r["filter_spans"] == T - 1 and r["busy_us"] == 0
    assert {"kh.call", "kh.flow", "kh.filter", "kh.lifecycle"} \
        <= set(r["idle_us"])
    assert sum(r["idle_us"].values()) == pytest.approx(r["window_us"])
