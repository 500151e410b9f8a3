"""The traffic drivers and the program they drive.

A traffic mix (traffic/<name>.json) names its driver kind: "clips" (one
clip a call, `api.track_video`), "batches" (a batch of clips a call,
`api.track_videos`) or "stream" (one `pipeline.track_stream` call over
the whole window). Each driver makes its pool of footage from the seed
on the device at set-up (traffic/blob.py), warms up, runs the measured
window as a closed loop with one client, runs the profiled calls of a
traced run, says how much work a set of calls did (for the roofline) and
works out the reference's answers for the calls it ran.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference import tracker
from benchmark.traffic import blob


class Call(NamedTuple):
    item: int               # pool item (clip, batch) or -1 for a stream
    start: float            # host clock, s
    end: float
    steps: int              # frame steps the call tracks
    outs: Optional[list]    # one {"pos", "alive", "track_id"} a clip
    error: Optional[str]


def rows(tracks) -> dict:
    return {"pos": tracks.positions, "alive": tracks.alive,
            "track_id": tracks.track_id}


class Program:
    """The system under test: kalman_hydra_tpu_torch's public entry
    points at the cell's RunConfig, on `device`."""

    def __init__(self, run_cfg: dict, device: str):
        from kalman_hydra_tpu_torch import api, pipeline
        from kalman_hydra_tpu_torch.config import RunConfig
        self.api, self.pipeline = api, pipeline
        self.cfg = RunConfig.from_json(json.dumps(run_cfg))
        self.device = device

    def clip(self, clip: np.ndarray) -> list:
        return [rows(self.api.track_video(clip, self.cfg,
                                          device=self.device))]

    def batch(self, clips: np.ndarray) -> list:
        return [rows(t) for t in self.api.track_videos(clips, self.cfg,
                                                       device=self.device)]

    def stream(self, frames) -> list:
        return [rows(self.pipeline.track_stream(frames, self.cfg,
                                                device=self.device))]


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _sigma(traffic: dict, frame: dict) -> float:
    return max(frame["height"], frame["width"]) \
        * traffic["blob_sigma_of_max_side"]


def pool_frames(n_frames: int, reinit_every: int) -> int:
    """Frames whose corner pool a track of n_frames computes: frame 0's,
    then every reinit_every-th (every frame at reinit_every <= 1)."""
    if reinit_every <= 1:
        return n_frames
    return 1 + (n_frames - 1) // reinit_every


def clip_counts(n_frames: int, clips: int, run_cfg: dict) -> dict:
    re = run_cfg["tracks"]["reinit_every"] if run_cfg["tracks"]["reinit"] \
        else 0
    return {"frames": clips * n_frames, "pairs": clips * (n_frames - 1),
            "track_steps": clips * (n_frames - 1),
            "pool_frames": clips * (pool_frames(n_frames, re) if re
                                    else 1)}


class CallLoop:
    """Driver kinds "clips" and "batches": a closed loop with one client,
    each call on the next item of a pool of `clips` distinct clips of
    `clip_len` frames, `batch` clips an item."""

    def __init__(self, traffic: dict, frame: dict, run_cfg: dict, seed: int,
                 device: str, program):
        self.t, self.frame, self.run_cfg = traffic, frame, run_cfg
        self.device, self.program = device, program
        self.batch = int(traffic["batch"])
        self.clip_len = int(traffic["clip_len"])
        pool = blob.clip_pool(seed, int(traffic["clips"]), self.clip_len,
                              frame["height"], frame["width"],
                              traffic["velocity"], _sigma(traffic, frame),
                              device)
        n = pool.shape[0] // self.batch
        self.items = (pool if self.batch == 1 else
                      pool[:n * self.batch].reshape(
                          (n, self.batch) + pool.shape[1:]))
        self.steps_per_call = self.batch * (self.clip_len - 1)

    def clips_of(self, item: int) -> np.ndarray:
        """(batch, T, H, W, 3) clips of pool item `item`."""
        it = self.items[item]
        return it[None] if self.batch == 1 else it

    def call(self, i: int) -> Call:
        item = i % len(self.items)
        start = time.perf_counter()
        try:
            outs = (self.program.clip(self.items[item]) if self.batch == 1
                    else self.program.batch(self.items[item]))
            err = None
        except Exception as e:          # a failed call counts as failed
            outs, err = None, f"{type(e).__name__}: {e}"
        return Call(item, start, time.perf_counter(), self.steps_per_call,
                    outs, err)

    def warm(self) -> None:
        for i in range(int(self.t["warmup_calls"])):
            c = self.call(i)
            if c.error:
                raise RuntimeError(f"warm-up call {i} failed: {c.error}")
        sync(self.device)

    def window(self, seconds: float, first: int = 0) -> List[Call]:
        """Whole calls while less than `seconds` have passed since the
        first one started."""
        calls = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            calls.append(self.call(first + len(calls)))
        return calls

    def profiled(self, first: int) -> List[Call]:
        return [self.call(first + j)
                for j in range(int(self.t["profile_calls"]))]

    def counts(self, calls: List[Call]) -> dict:
        return clip_counts(self.clip_len, self.batch * len(calls),
                           self.run_cfg)

    def reference(self, calls: List[Call]) -> dict:
        """{(item, clip in item): reference rows} for every clip of the
        items that the calls tracked, worked out on the device from the
        footage."""
        out = {}
        for item in sorted({c.item for c in calls}):
            for b, clip in enumerate(self.clips_of(item)):
                frames = torch.from_numpy(clip).to(self.device)
                out[(item, b)] = tracker.track_frames(frames, self.run_cfg)
        return out

    def answers(self, call: Call):
        """[(reference key, the call's rows)] of one call."""
        return [((call.item, b), o) for b, o in enumerate(call.outs)]

    def expected(self, call: Call) -> int:
        return self.batch


class Stream:
    """Driver kind "stream": one track_stream call over a recording that
    walks a pool of `pool_frames` continuous frames forward and back, fed
    until the window's seconds have passed. Every row the call returns is
    checked."""

    def __init__(self, traffic: dict, frame: dict, run_cfg: dict, seed: int,
                 device: str, program):
        self.t, self.frame, self.run_cfg = traffic, frame, run_cfg
        self.device, self.program = device, program
        self.pool = blob.clip_pool(seed, 1, int(traffic["pool_frames"]),
                                   frame["height"], frame["width"],
                                   traffic["velocity"],
                                   _sigma(traffic, frame), device)[0]

    def _walk(self, stop: Callable[[int], bool], fed: list):
        for n, i in enumerate(blob.ping_pong(len(self.pool))):
            if stop(n):
                return
            fed[0] = n + 1
            yield self.pool[i]

    def _run(self, stop: Callable[[int], bool]) -> Call:
        fed = [0]
        start = time.perf_counter()
        try:
            outs = self.program.stream(self._walk(stop, fed))
            err = None
        except Exception as e:
            outs, err = None, f"{type(e).__name__}: {e}"
        end = time.perf_counter()
        return Call(-1, start, end, max(fed[0] - 1, 0), outs, err)

    def frames(self, n: int) -> Call:
        """One track_stream call over the first `n` frames of the walk."""
        return self._run(lambda i: i >= n)

    def warm(self) -> None:
        c = self.frames(int(self.t["warmup_frames"]))
        if c.error:
            raise RuntimeError(f"warm-up stream failed: {c.error}")
        sync(self.device)

    def window(self, seconds: float, first: int = 0) -> List[Call]:
        lock = threading.Lock()
        t0 = [None]

        def stop(i: int) -> bool:
            with lock:
                if t0[0] is None:
                    t0[0] = time.perf_counter()
                return time.perf_counter() - t0[0] >= seconds
        return [self._run(stop)]

    def profiled(self, first: int) -> List[Call]:
        return [self.frames(int(self.t["profile_frames"]) + 1)]

    def counts(self, calls: List[Call]) -> dict:
        c = {"frames": 0, "pairs": 0, "track_steps": 0, "pool_frames": 0}
        for call in calls:
            for k, v in clip_counts(call.steps + 1, 1, self.run_cfg).items():
                c[k] += v
        return c

    def reference(self, calls: List[Call]) -> dict:
        """{(-1, rows): the reference's first rows of the walk} for each
        call's number of rows, all worked out in one pass over the
        longest, on the device, with each pool frame's pyramid and corner
        pool and each pair's flow computed once."""
        want = {c.steps + 1 for c in calls}
        n = max(want)
        pool = torch.from_numpy(self.pool).to(self.device)
        idx = list(itertools.islice(blob.ping_pong(len(self.pool)), n))
        ref = tracker.track_frames((pool[i] for i in idx), self.run_cfg,
                                   keys=idx)
        return {(-1, m): {k: v[:m] for k, v in ref.items()} for m in want}

    def answers(self, call: Call):
        """[(reference key, every row the call returned)]."""
        return [((-1, call.steps + 1), call.outs[0])]

    def expected(self, call: Call) -> int:
        return 1


DRIVERS = {"clips": CallLoop, "batches": CallLoop, "stream": Stream}


def make(traffic: dict, frame: dict, run_cfg: dict, seed: int, device: str,
         program):
    return DRIVERS[traffic["driver"]](traffic, frame, run_cfg, seed, device,
                                      program)
