"""Tracking pipeline (port of kalman_hydra_tpu/pipeline.py: the flow,
sparse-LK and photometric measurement paths).

Per-frame path (`track_arrays`): grayscale -> polyexp pyramid (K4 coarse
levels and K3 full res; or K11 level images then K3 on every level at
pe_fused=False) -> Farneback from the cached previous pyramid, warm-started
from the previous pair's flow with `temporal_init` (K8 after the exact
gather at fast_warp=0, the reference's default; else K5 on the levels
under its gate with `fi_level_fused`, K13 on the others with
`fi_pipeline`, K2 elsewhere) -> the measurement update: the flow sampled
at the tracks and a fused predict + update (K1) for "position", the
implicit-flow (I)EKF or the UKF otherwise, the plain update with
adaptive_q -> with "flow_photometric" a second, photometric update ->
gate, kill, reseed from a corner pool refreshed every `reinit_every`
frames (within the segmented body with `seed_in_body`).
`init_velocity` primes the seeds' velocities from a cold frame 0 -> 1
flow. measurement="photometric" computes no flow: Gauss-Newton on the
frames themselves (models/photometric.py) is the measurement.

Pair-batched path (`RunConfig.pair_batch`, `track_arrays_pairflow`): the
polyexp pyramids of every frame (K7b, K7a) and the flow of every frame
pair (K6 per level iteration, or the exact gather and K8-pairs at
fast_warp=0) first, then the same EKF/lifecycle steps over the
precomputed fields. `track_clips_pairflow` chains several clips through
the same launches (`clip_len`), then filters each clip in turn (a loop
over clips where the reference vmaps). `track_precomputed_flow` runs the
filter alone over a supplied flow sequence.

Lucas-Kanade (`FlowConfig.method`): with "lk_sparse" each step tracks
the filter's positions from the cached `lk_pyramid` of the previous
frame (K9, K10) with one K12 launch for all levels and feeds them to a
plain position Kalman update, a lost point counting as a miss; "lk_dense" is a
dense flow (K9, K10 and plain torch) that feeds K1 like Farneback's, per
frame or pair-batched (a loop over the pairs where the reference vmaps).

Smoothing (`RunConfig.smooth`, models/rts.py) runs on every path: a
monolithic RTS over the filter history, or with `lag` an online
fixed-lag smoother in each step and one RTS over the final window; with
`chunk` (and no lag) `track_clip` keeps the history in host memory and
smooths it a chunk at a time. `flow_sequence` is the flow of every frame
pair, optionally per-pixel KF smoothed (models/pixel_ekf.py).

The reference's `lax.scan` is a Python loop here and its `lax.cond`
refresh cadence a plain `if`; the clip stays on the device and only the
(T, K) trajectory rows leave it at the end. `track_stream` runs the same
per-frame step over a host frame stream with O(1) card memory: each
frame crosses to the card once (`io.video.device_prefetch`), each step's
row crosses back, and the state can be checkpointed and resumed
(`utils/checkpoint.py`).

Only the ported slices run: `check_slice` raises NotImplementedError,
naming the ROADMAP item, for any other setting (the mesh-render
channels). TPU-only knobs that do not change results (impl,
pallas_interpret, fi_tile_h, fi_shift_skip, pe_tile_h) are ignored.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import cuda_device
from .config import EkfConfig, FlowConfig, RunConfig, TrackConfig
from .io import Trajectories
from .io.video import device_prefetch
from .kernels.flow_iter import pair_count, pair_frames
from .kernels.polyexp import POLY_N_MAX
from .models import dynamics, lifecycle
from .models.ekf import (TrackState, commit_update, ekf_step, init_tracks,
                         measurement_noise, predict, update)
from .models.photometric import photometric_refine, photometric_step
from .models.pixel_ekf import PixelEkfParams, smooth_flow_sequence
from .models.rts import (fixed_lag_smooth, rts_smooth, rts_smooth_chunked,
                         segment_breaks)
from .ops.color import grayscale_u8
from .ops.farneback import (farneback, farneback_from_pyramids,
                            farneback_pairs_from_pyramids, polyexp_pyramid,
                            polyexp_pyramid_batch)
from .ops.features import corner_pool
from .ops.lk import lk_dense, lk_pyramid, lk_sparse
from .ops.segment import segment_body
from .ops.warp import sample_flow
from .utils.checkpoint import load_state, save_state

_ROWS = ("pos", "alive", "nis", "track_id")
_HISTORY = ("x_filt", "P_filt", "x_pred", "P_pred")


class Carry(NamedTuple):
    tracks: TrackState
    prev_gray: torch.Tensor     # (H, W) f32
    prev_rpyr: Tuple = ()       # cached pyramid of prev_gray: polyexp
    #                             levels (farneback), (pyr, grads) of
    #                             lk_pyramid (lk_sparse), () (lk_dense,
    #                             and measurement="photometric")
    corner_cache: Tuple = ()    # (pts, score) pool reused between refreshes
    frame_idx: int = 0          # filter steps taken (reinit_every cadence)
    lag_buf: Tuple = ()         # (xf, Pf, xp, Pp, tid, alive) windows,
    #                             oldest first, only with smooth.lag > 0
    prev_flow: Optional[torch.Tensor] = None  # (H, W, 2) previous pair's
    #                                          flow, only with temporal_init


def _lag_buf_init(state: TrackState, lag: int) -> Tuple:
    """The fixed-lag window primed with the seed state replicated (same
    track ids and alive mask everywhere: no artificial segment breaks)."""
    return tuple(a[None].expand((lag + 1,) + a.shape)
                 for a in (state.x, state.P, state.x, state.P,
                           state.track_id, state.alive))


def _lag_buf_push(buf: Tuple, state: TrackState, x_pred, P_pred) -> Tuple:
    new = (state.x, state.P, x_pred, P_pred, state.track_id, state.alive)
    return tuple(torch.cat([b[1:], n[None]]) for b, n in zip(buf, new))


def _lag(cfg: RunConfig) -> int:
    return cfg.smooth.lag if cfg.smooth.enabled else 0


def main_path_config(num_tracks: int = 1024) -> RunConfig:
    """The 1080p headline configuration, `bench.py`'s graph: Farneback
    (5 levels, winsize 15, 3 iterations, poly 5/1.1, fast_warp 8, bf16
    planes, whole-level kernels on the levels that pass the gate),
    6-state CA EKF with position measurements, corner pool refreshed
    every 4 frames."""
    return RunConfig(
        flow=FlowConfig(fast_warp=8, bf16_poly=True),
        ekf=EkfConfig(state_dim=6),
        tracks=TrackConfig(num_tracks=num_tracks,
                           corner_pool=max(256, num_tracks),
                           reinit_every=4),
        impl="pallas")


def pair_path_config(num_tracks: int = 1024) -> RunConfig:
    """`bench.py`'s cfg3 graph (720p, T=17): the main path's flow
    settings, K=1024 tracks on the 6-state EKF, a fresh corner pool every
    frame, and the pair-batched pipeline."""
    return RunConfig(
        flow=FlowConfig(fast_warp=8, bf16_poly=True),
        ekf=EkfConfig(state_dim=6),
        tracks=TrackConfig(num_tracks=num_tracks,
                           corner_pool=max(256, num_tracks),
                           reinit_every=1),
        impl="pallas", pair_batch=True)


def check_slice(cfg: RunConfig, flow_only: bool = False) -> None:
    """Raise NotImplementedError for any setting outside the ported slice
    (with flow_only, for the settings that the flow of `flow_sequence`
    reads)."""
    m = cfg.ekf.measurement
    if not flow_only and m in ("render", "flow_render"):
        raise NotImplementedError(
            f"ekf.measurement={m!r}, the mesh-render channel (ROADMAP "
            "P11b), is outside the ported slice of kalman_hydra_tpu")
    f = cfg.flow
    if f.method == "farneback" and f.poly_n > POLY_N_MAX:
        raise NotImplementedError(
            f"flow.poly_n={f.poly_n}: the polynomial expansion's tiles on "
            f"the card take poly_n <= {POLY_N_MAX} (ROADMAP section 3, "
            "F4's remaining limit)")


def _photometric(cfg: RunConfig) -> bool:
    """measurement="photometric": no flow at all, no flow pyramids."""
    return cfg.ekf.measurement == "photometric"


def _flow_pyramid(gray: torch.Tensor, cfg: RunConfig) -> Tuple:
    """What the step caches of a frame for the next: its polyexp pyramid
    (farneback), its lk_pyramid (lk_sparse), nothing (lk_dense, or
    measurement="photometric")."""
    if _photometric(cfg):
        return ()
    if cfg.flow.method == "farneback":
        return polyexp_pyramid(gray, cfg.flow)
    if cfg.flow.method == "lk_sparse":
        return lk_pyramid(gray, cfg.flow)
    return ()


def _flow_field(prev_gray: torch.Tensor, gray: torch.Tensor,
                cfg: RunConfig) -> torch.Tensor:
    """Dense (H, W, 2) flow of one frame pair from the frames alone,
    where no pyramid is cached: lk_dense's, or Farneback's (in
    photometric mode, for init_velocity's frame 0 -> 1 flow)."""
    if cfg.flow.method == "farneback":
        return farneback(prev_gray, gray, cfg.flow)
    if cfg.flow.method == "lk_dense":
        return lk_dense(prev_gray, gray, cfg.flow)
    raise ValueError(f"dense flow required, got {cfg.flow.method!r}")


def _seed_mask(gray: torch.Tensor, cfg: RunConfig):
    """The segmented body that seeding is restricted to with
    seed_in_body, else None."""
    return segment_body(gray) if cfg.tracks.seed_in_body else None


def _fresh_corner_pool(gray: torch.Tensor, cfg: RunConfig):
    """A frame's corner pool as every step refreshes it (within the
    segmented body with seed_in_body)."""
    return corner_pool(gray, cfg.tracks, mask=_seed_mask(gray, cfg))


def init_from_frame(frame0: torch.Tensor, cfg: RunConfig) -> Carry:
    """Seed the track pool from frame 0's corner pool (within the
    segmented body with seed_in_body) and cache its flow pyramid (and,
    with reinit_every > 1, its corner pool); prime the fixed-lag window
    and the cold warm-start field where configured."""
    gray0 = grayscale_u8(frame0)
    mask = _seed_mask(gray0, cfg)
    pts, score = corner_pool(gray0, cfg.tracks,
                             pool_size=cfg.tracks.num_tracks, mask=mask)
    state = init_tracks(cfg.ekf, pts, valid=score > 0)
    corner_cache = ()
    if cfg.tracks.reinit and cfg.tracks.reinit_every > 1:
        corner_cache = corner_pool(gray0, cfg.tracks, mask=mask)
    lag_buf = _lag_buf_init(state, _lag(cfg)) if _lag(cfg) else ()
    # pair 0 -> 1 is a cold start (zeros == cv2 USE_INITIAL_FLOW with a
    # zero field); the photometric channel computes no flow
    prev_flow = (torch.zeros(gray0.shape + (2,), dtype=torch.float32,
                             device=gray0.device)
                 if cfg.flow.temporal_init and not _photometric(cfg)
                 else None)
    return Carry(tracks=state, prev_gray=gray0,
                 prev_rpyr=_flow_pyramid(gray0, cfg),
                 corner_cache=corner_cache, frame_idx=0, lag_buf=lag_buf,
                 prev_flow=prev_flow)


def _with_velocity(state: TrackState, flow: torch.Tensor,
                   cfg: EkfConfig) -> TrackState:
    """The seeds' velocities set to the flow at them over dt."""
    x = state.x.clone()
    x[:, 2:4] = sample_flow(flow, state.x[:, 0:2]) / cfg.dt
    return state._replace(x=x)


def _prime_init_velocity(carry0: Carry, frame1: torch.Tensor,
                         cfg: RunConfig) -> Carry:
    """Prime track velocities with the cold frame 0 -> 1 flow at the
    seeds (TrackConfig.init_velocity), reusing frame 0's cached polyexp
    pyramid with Farneback where there is one; prev_flow is left as it
    was."""
    gray1 = grayscale_u8(frame1)
    if cfg.flow.method == "farneback" and carry0.prev_rpyr:
        flow01 = farneback_from_pyramids(
            carry0.prev_rpyr, polyexp_pyramid(gray1, cfg.flow), cfg.flow)
    else:
        flow01 = _flow_field(carry0.prev_gray, gray1, cfg)
    return carry0._replace(tracks=_with_velocity(carry0.tracks, flow01,
                                                 cfg.ekf))


def make_filter_tail(cfg: RunConfig, F: torch.Tensor):
    """The lifecycle and output tail of every step, after the measurement
    update: (state, aux, lag_buf, corner pool (pts, score) or None, h, w)
    -> (state, lag_buf, out). Gate, kill the tracks that left the (h, w)
    frame, reseed from the pool; with smooth.lag it also pushes the
    fixed-lag window and emits the smoothed position of the frame leaving
    it."""

    def tail(state: TrackState, aux: dict, lag_buf: Tuple, pool, h: int,
             w: int):
        state = lifecycle.gate(state, aux["x_pred"], aux["P_pred"],
                               aux["nis"], cfg.ekf)
        state = lifecycle.kill_lost(state, cfg.ekf, h, w)
        if cfg.tracks.reinit:
            state = lifecycle.reseed(state, *pool, cfg.ekf, cfg.tracks)
        out = {"pos": state.x[:, 0:2], "alive": state.alive,
               "nis": aux["nis"], "track_id": state.track_id,
               "x_filt": state.x, "P_filt": state.P,
               "x_pred": aux["x_pred"], "P_pred": aux["P_pred"]}
        if _lag(cfg):
            lag_buf = _lag_buf_push(lag_buf, state, aux["x_pred"],
                                    aux["P_pred"])
            out["smoothed_lag"] = fixed_lag_smooth(F, *lag_buf)[0][:, 0:2]
        return state, lag_buf, out

    return tail


def _filter_model(cfg: RunConfig, device):
    """(F, Q, tail) of every step builder: the dynamics and the shared
    lifecycle/output tail (`make_filter_tail`)."""
    F = torch.as_tensor(dynamics.transition(cfg.ekf), device=device)
    Q = torch.as_tensor(dynamics.process_noise(cfg.ekf), device=device)
    return F, Q, make_filter_tail(cfg, F)


def make_flow_scan_step(cfg: RunConfig, device):
    """EKF/lifecycle step over a given dense flow field:
    (tracks, lag_buf, flow (H, W, 2), corner pool (pts, score) or None)
    -> (tracks, lag_buf, out). The step of the pair-batched paths."""
    F, Q, tail = _filter_model(cfg, device)

    def step(tracks: TrackState, lag_buf: Tuple, flow: torch.Tensor, pool):
        state, aux = ekf_step(tracks, flow, cfg.ekf, F, Q)
        return tail(state, aux, lag_buf, pool, flow.shape[0], flow.shape[1])

    return step


def make_step(cfg: RunConfig, device):
    """Per-frame step function (carry, frame) -> (carry, out)."""
    F, Q, tail = _filter_model(cfg, device)
    H = torch.as_tensor(dynamics.position_H(cfg.ekf), device=device)
    R = measurement_noise(cfg.ekf, device)
    method = cfg.flow.method

    def step(carry: Carry, frame: torch.Tensor):
        gray = grayscale_u8(frame)
        rpyr = _flow_pyramid(gray, cfg)
        corner_cache = carry.corner_cache
        frame_idx = carry.frame_idx + 1
        pool = None
        if cfg.tracks.reinit:
            if cfg.tracks.reinit_every <= 1 or not corner_cache:
                pool = _fresh_corner_pool(gray, cfg)
            else:
                if frame_idx % cfg.tracks.reinit_every == 0:
                    corner_cache = _fresh_corner_pool(gray, cfg)
                pool = corner_cache
        flow = None
        if _photometric(cfg):
            # the appearance channel alone: Gauss-Newton on the frames
            state, aux = photometric_step(carry.tracks, carry.prev_gray,
                                          gray, cfg.ekf, F, Q)
        elif method == "lk_sparse":
            # the tracks' own positions, tracked by sparse LK, are the
            # measurement of a plain position update; a point LK lost
            # (status False) counts as a miss
            pos = carry.tracks.x[:, 0:2]
            new_pts, ok = lk_sparse(carry.prev_gray, gray, pos, cfg.flow,
                                    prev_pyr=carry.prev_rpyr or None,
                                    next_pyr=rpyr)
            state = carry.tracks
            x_pred, P_pred = predict(state.x, state.P, F, Q, state.q_scale)
            y = pos + (new_pts - pos) - x_pred[:, 0:2]
            x_new, P_new, nis = update(x_pred, P_pred, y, H, R)
            state, aux = commit_update(state, x_pred, P_pred, x_new, P_new,
                                       nis, cfg.ekf, valid=ok)
        else:
            flow = (farneback_from_pyramids(carry.prev_rpyr, rpyr, cfg.flow,
                                            flow0=carry.prev_flow)
                    if method == "farneback"
                    else _flow_field(carry.prev_gray, gray, cfg))
            state, aux = ekf_step(carry.tracks, flow, cfg.ekf, F, Q)
        if cfg.ekf.measurement == "flow_photometric":
            # the second, photometric update of the flow-updated state
            state, aux = photometric_refine(state, aux, carry.prev_gray,
                                            gray, carry.tracks.x[:, 0:2],
                                            cfg.ekf)
        state, lag_buf, out = tail(state, aux, carry.lag_buf, pool,
                                   gray.shape[0], gray.shape[1])
        # temporal warm start: this pair's flow seeds the next pair's
        # coarsest level
        prev_flow = None if carry.prev_flow is None else flow
        return Carry(tracks=state, prev_gray=gray, prev_rpyr=rpyr,
                     corner_cache=corner_cache, frame_idx=frame_idx,
                     lag_buf=lag_buf, prev_flow=prev_flow), out

    return step


def _finalize_track_outputs(state0: TrackState, final_lag_buf: Tuple,
                            rows: List[dict], cfg: RunConfig,
                            with_history: bool) -> dict:
    """Prepend the frame-0 row (the seeded state, nis 0, x_pred = x0,
    P_pred = P0) to the per-step rows, stack over T and run the configured
    smoother; the output tail of both paths."""
    first = {"pos": state0.x[:, 0:2], "alive": state0.alive,
             "nis": torch.zeros_like(state0.x[:, 0]),
             "track_id": state0.track_id, "x_filt": state0.x,
             "P_filt": state0.P, "x_pred": state0.x, "P_pred": state0.P,
             "smoothed_lag": state0.x[:, 0:2]}
    lag = _lag(cfg)
    keys = _ROWS
    if with_history or (cfg.smooth.enabled and not lag):
        keys += _HISTORY
    if lag:
        keys += ("smoothed_lag",)
    outs = {k: torch.stack([first[k]] + [r[k] for r in rows]) for k in keys}
    F = torch.as_tensor(dynamics.transition(cfg.ekf),
                        device=state0.x.device)
    if lag:
        # frames 0..T-1-L come from the per-step emissions (step t smoothed
        # frame t - L), the last L from one RTS over the final window,
        # whose entry i is frame T-1-L+i
        T = outs["pos"].shape[0]
        xf, Pf, xp, Pp, tid, alive = final_lag_buf
        xs_tail, _ = rts_smooth(F, xf, Pf, xp, Pp,
                                breaks=segment_breaks(tid, alive))
        if T > lag:
            outs["smoothed"] = torch.cat([outs["smoothed_lag"][lag:],
                                          xs_tail[1:, :, 0:2]])
        else:
            outs["smoothed"] = xs_tail[lag + 1 - T:, :, 0:2]
    elif cfg.smooth.enabled:
        xs, _ = rts_smooth(F, outs["x_filt"], outs["P_filt"],
                           outs["x_pred"], outs["P_pred"],
                           breaks=segment_breaks(outs["track_id"],
                                                 outs["alive"]))
        outs["smoothed"] = xs[..., 0:2]
    if not with_history:
        outs = {k: v for k, v in outs.items() if k in _ROWS + ("smoothed",)}
    return outs


def track_arrays(frames: torch.Tensor, cfg: RunConfig,
                 with_history: bool = False,
                 seeds: Optional[torch.Tensor] = None) -> dict:
    """(T, H, W[, 3]) frame tensor -> {"pos", "alive", "nis", "track_id"
    [, "smoothed"]} stacked over T (row 0 is the seeded state, nis 0);
    with_history adds the filter history (x_filt, P_filt, x_pred, P_pred).
    `seeds` (K, 2) replaces the corner-pool seeding."""
    check_slice(cfg)
    if cfg.pair_batch:
        return track_arrays_pairflow(frames, cfg, with_history, seeds)
    carry = init_from_frame(frames[0], cfg)
    if seeds is not None:
        carry = carry._replace(tracks=init_tracks(cfg.ekf, seeds))
    if cfg.tracks.init_velocity:
        carry = _prime_init_velocity(carry, frames[1], cfg)
    if carry.lag_buf and (seeds is not None or cfg.tracks.init_velocity):
        # re-prime the window from the replaced seed state
        carry = carry._replace(lag_buf=_lag_buf_init(carry.tracks, _lag(cfg)))
    s0 = carry.tracks
    step = make_step(cfg, frames.device)
    rows = []
    for t in range(1, frames.shape[0]):
        carry, out = step(carry, frames[t])
        rows.append(out)
    return _finalize_track_outputs(s0, carry.lag_buf, rows, cfg,
                                   with_history)


def _corner_pool_sequence(grays: torch.Tensor, cfg: RunConfig) -> list:
    """The corner pool each step t = 1..T-1 of the per-frame path holds:
    frame t's, refreshed when t % reinit_every == 0, else the latest
    refresh (frame 0's pool until the first one). Each distinct refresh
    frame is computed once."""
    T = grays.shape[0]
    re = max(cfg.tracks.reinit_every, 1)
    pools = {f: _fresh_corner_pool(grays[f], cfg)
             for f in sorted({(t // re) * re for t in range(1, T)})}
    return [pools[(t // re) * re] for t in range(1, T)]


def _track_from_pair_flows(grays: torch.Tensor, flows: torch.Tensor,
                           cfg: RunConfig, with_history: bool = False,
                           seeds: Optional[torch.Tensor] = None) -> dict:
    """Tail of the pair-batched paths: seed from frame 0's corner pool
    (within the segmented body with seed_in_body) or `seeds`, prime
    velocities from the first flow with init_velocity, then one
    EKF/lifecycle step per precomputed flow (T - 1, H, W, 2)."""
    if seeds is None:
        pts, score = corner_pool(grays[0], cfg.tracks,
                                 pool_size=cfg.tracks.num_tracks,
                                 mask=_seed_mask(grays[0], cfg))
        state0 = init_tracks(cfg.ekf, pts, valid=score > 0)
    else:
        state0 = init_tracks(cfg.ekf, seeds)
    if cfg.tracks.init_velocity:
        state0 = _with_velocity(state0, flows[0], cfg.ekf)
    lag_buf = _lag_buf_init(state0, _lag(cfg)) if _lag(cfg) else ()
    T = grays.shape[0]
    pools = (_corner_pool_sequence(grays, cfg) if cfg.tracks.reinit
             else [None] * (T - 1))
    step = make_flow_scan_step(cfg, grays.device)
    state, rows = state0, []
    for t in range(T - 1):
        state, lag_buf, out = step(state, lag_buf, flows[t], pools[t])
        rows.append(out)
    return _finalize_track_outputs(state0, lag_buf, rows, cfg, with_history)


def _pair_flows(grays: torch.Tensor, cfg: RunConfig,
                clip_len: int = 0) -> torch.Tensor:
    """The flow of every frame pair of an (N, H, W) stack (clip_len as
    in kernels/flow_iter.py): Farneback's in shared launches (K7b, K7a,
    K6), lk_dense's pair after pair (where the reference vmaps)."""
    if cfg.flow.method == "farneback":
        return farneback_pairs_from_pyramids(
            polyexp_pyramid_batch(grays, cfg.flow), cfg.flow,
            clip_len=clip_len)
    pairs = pair_count(grays.shape[0], clip_len)
    return torch.stack([_flow_field(grays[p], grays[p + 1], cfg)
                        for p in pair_frames(pairs, clip_len)])


def track_arrays_pairflow(frames: torch.Tensor, cfg: RunConfig,
                          with_history: bool = False,
                          seeds: Optional[torch.Tensor] = None) -> dict:
    """Pair-batched twin of track_arrays: the flow of every frame pair
    first (`_pair_flows`), then the EKF/lifecycle steps. The same
    trajectories as the per-frame path at fi_level_fused=False and
    fi_pipeline=False (at fast_warp=0 with f32 planes; with bf16 planes
    the pair path rounds M to bf16, as the reference's does)."""
    grays = grayscale_u8(frames)
    return _track_from_pair_flows(grays, _pair_flows(grays, cfg), cfg,
                                  with_history, seeds)


def track_clips_pairflow(frames_b: torch.Tensor, cfg: RunConfig,
                         with_history: bool = False,
                         seeds: Optional[torch.Tensor] = None) -> dict:
    """Multi-clip pair-batched pipeline: a (B, T, H, W[, 3]) clip stack
    runs the flow of all B (T - 1) frame pairs (Farneback's through
    shared launches), chained as one (B T) frame stack with clip_len = T
    so that no pair straddles two clips; then each clip's EKF/lifecycle
    steps run, clip after clip. `seeds` is (K, 2) for every clip or
    (B, K, 2). Returns the per-clip outputs stacked over B."""
    check_slice(cfg)
    B, T = frames_b.shape[0], frames_b.shape[1]
    grays_b = grayscale_u8(frames_b)
    flat = grays_b.reshape((B * T,) + grays_b.shape[2:])
    flows = _pair_flows(flat, cfg, clip_len=T)
    flows_b = flows.reshape((B, T - 1) + flows.shape[1:])
    if seeds is not None and seeds.ndim == 2:
        seeds = seeds.expand((B,) + seeds.shape)
    outs = [_track_from_pair_flows(grays_b[b], flows_b[b], cfg, with_history,
                                   None if seeds is None else seeds[b])
            for b in range(B)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def flow_sequence(frames: torch.Tensor, cfg: RunConfig,
                  smooth: bool = False) -> torch.Tensor:
    """Dense flow for every consecutive frame pair of a (T, H, W[, 3])
    clip -> (T - 1, H, W, 2), optionally per-pixel-KF smoothed
    (BASELINE.json:8 config 2). With pair_batch, or with lk_dense,
    `_pair_flows`; otherwise Farneback's per-frame chain, each frame's
    pyramid expanded once, and with temporal_init each pair's flow seeds
    the next (pair 0 cold). lk_sparse has no dense flow: ValueError, as
    in the reference."""
    check_slice(cfg, flow_only=True)
    grays = grayscale_u8(frames)
    if cfg.pair_batch or cfg.flow.method != "farneback":
        flows = _pair_flows(grays, cfg)
    else:
        rpyr = polyexp_pyramid(grays[0], cfg.flow)
        prev = (torch.zeros(grays.shape[1:] + (2,), dtype=torch.float32,
                            device=grays.device)
                if cfg.flow.temporal_init else None)
        out = []
        for gray in grays[1:]:
            rpyr_next = polyexp_pyramid(gray, cfg.flow)
            fl = farneback_from_pyramids(rpyr, rpyr_next, cfg.flow, prev)
            rpyr, prev = rpyr_next, (None if prev is None else fl)
            out.append(fl)
        flows = torch.stack(out)
    if smooth:
        flows = smooth_flow_sequence(flows, PixelEkfParams())
    return flows


def _device(device) -> torch.device:
    """`device` as a torch.device; a card is set up (TF32 off) before any
    work, and asking for one without a card raises."""
    device = torch.device(device)
    if device.type == "cuda":
        return cuda_device(device.index or 0)
    return device


def upload(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(_device(device))


def _seeds(seeds, device) -> Optional[torch.Tensor]:
    return (None if seeds is None
            else upload(np.asarray(seeds, np.float32), device))


def _trajectories(outs: dict) -> Trajectories:
    outs = {k: v.cpu().numpy() for k, v in outs.items()}
    return Trajectories(positions=outs["pos"], alive=outs["alive"],
                        nis=outs["nis"], track_id=outs["track_id"],
                        smoothed=outs.get("smoothed"))


def _smooth_history_chunked(outs: dict, cfg: RunConfig,
                            device) -> torch.Tensor:
    """Chunked RTS over a host-resident filter history (segment breaks at
    re-seeds and dead frames), one chunk on `device` at a time."""
    chunk = cfg.smooth.chunk if cfg.smooth.chunk > 0 else 64
    xs, _ = rts_smooth_chunked(
        dynamics.transition(cfg.ekf), outs["x_filt"], outs["P_filt"],
        outs["x_pred"], outs["P_pred"], chunk=chunk,
        breaks=segment_breaks(outs["track_id"], outs["alive"]),
        device=device)
    return xs


def track_precomputed_flow(flows: np.ndarray, seeds: np.ndarray,
                           cfg: RunConfig, *,
                           device="cuda") -> Trajectories:
    """Track from a supplied (T - 1, H, W, 2) flow sequence: the filter
    stack alone (measurement update, gate, kill) from the (K, 2) `seeds`,
    with no flow computation and no re-seeding (there are no frames for a
    corner pool), on `device`: the card (where the position update with
    a shared Q takes K1) unless the caller asks for "cpu"."""
    check_slice(cfg)
    flows_d = upload(np.asarray(flows, np.float32), device)
    state = init_tracks(cfg.ekf, _seeds(seeds, device))
    F, Q, _ = _filter_model(cfg, flows_d.device)
    h, w = flows_d.shape[1], flows_d.shape[2]
    rows = [{"pos": state.x[:, 0:2], "alive": state.alive,
             "nis": torch.zeros_like(state.x[:, 0]),
             "track_id": state.track_id}]
    for flow in flows_d:
        state, aux = ekf_step(state, flow, cfg.ekf, F, Q)
        state = lifecycle.gate(state, aux["x_pred"], aux["P_pred"],
                               aux["nis"], cfg.ekf)
        state = lifecycle.kill_lost(state, cfg.ekf, h, w)
        rows.append({"pos": state.x[:, 0:2], "alive": state.alive,
                     "nis": aux["nis"], "track_id": state.track_id})
    return _trajectories({k: torch.stack([r[k] for r in rows])
                          for k in _ROWS})


def track_clip(frames: np.ndarray, cfg: RunConfig,
               seeds: Optional[np.ndarray] = None,
               with_history: bool = False, render_tmpl=None, *,
               device="cuda") -> Trajectories:
    """Track a whole (T, H, W[, 3]) uint8 clip on `device` (the card
    unless the caller asks for "cpu"). With smooth.chunk > 0 and no lag
    the filter history is moved to host memory and smoothed a chunk at a
    time (the long-horizon memory plan). The reference's parameters, in
    its order: `with_history` has no effect there either (Trajectories
    carries no filter history); `render_tmpl`, the mesh-render channels'
    template, is not ported yet."""
    if render_tmpl is not None:
        raise NotImplementedError("track_clip(render_tmpl=...): the "
                                  "mesh-render channels are outside the "
                                  "ported slice (ROADMAP P11b)")
    frames_d = upload(frames, device)
    seeds_d = _seeds(seeds, device)
    if cfg.smooth.enabled and cfg.smooth.chunk > 0 and cfg.smooth.lag == 0:
        filt = cfg.replace(smooth=dataclasses.replace(cfg.smooth,
                                                      enabled=False))
        outs = {k: v.cpu() for k, v in track_arrays(
            frames_d, filt, with_history=True, seeds=seeds_d).items()}
        outs["smoothed"] = _smooth_history_chunked(
            outs, cfg, frames_d.device)[..., 0:2]
        return _trajectories({k: outs[k] for k in _ROWS + ("smoothed",)})
    return _trajectories(track_arrays(frames_d, cfg, seeds=seeds_d))


def track_clips(clips: np.ndarray, cfg: RunConfig,
                seeds: Optional[np.ndarray] = None, *,
                device="cuda") -> List[Trajectories]:
    """Track a (B, T, H, W[, 3]) uint8 clip batch on `device`: through
    `track_clips_pairflow` with cfg.pair_batch, else clip after clip
    through `track_arrays`. `seeds` is (K, 2) or (B, K, 2)."""
    clips_d = upload(clips, device)
    seeds_d = _seeds(seeds, device)
    if seeds_d is not None and seeds_d.ndim == 2:
        seeds_d = seeds_d.expand((clips_d.shape[0],) + seeds_d.shape)
    if cfg.pair_batch:
        outs = track_clips_pairflow(clips_d, cfg, seeds=seeds_d)
        return [_trajectories({k: v[b] for k, v in outs.items()})
                for b in range(clips_d.shape[0])]
    return [_trajectories(track_arrays(
        c, cfg, seeds=None if seeds_d is None else seeds_d[b]))
        for b, c in enumerate(clips_d)]


class _RowFetch:
    """Moves each step's row (its outputs under `keys`) to host memory.
    On the card a row is copied, non-blocking, into one of two sets of
    pinned buffers as soon as its step has been issued, and read once the
    next step has been issued: the host waits for the step before the one
    it just issued, never for that one."""

    def __init__(self, keys, device: torch.device):
        self.keys = keys
        self.cuda = device.type == "cuda"
        self.slots = [None, None]    # (pinned buffers, event after the copy)
        self.n = 0
        self.pending = None          # the last pushed row (CPU) or slot

    def push(self, out: dict) -> Optional[dict]:
        """Queue this step's row; return the previous step's, if any."""
        prev = self.flush()
        if not self.cuda:
            self.pending = {k: out[k].numpy().copy() for k in self.keys}
            return prev
        j = self.n % 2
        self.n += 1
        if self.slots[j] is None:
            self.slots[j] = ({k: torch.empty(out[k].shape,
                                             dtype=out[k].dtype,
                                             pin_memory=True)
                              for k in self.keys}, torch.cuda.Event())
        # the slot's last row was read out when the push after it ran
        bufs, done = self.slots[j]
        for k in self.keys:
            bufs[k].copy_(out[k], non_blocking=True)
        done.record()
        self.pending = j
        return prev

    def flush(self) -> Optional[dict]:
        """The queued row, read out (None if there is none)."""
        prev, self.pending = self.pending, None
        if prev is None or not self.cuda:
            return prev
        bufs, done = self.slots[prev]
        done.synchronize()
        return {k: v.numpy().copy() for k, v in bufs.items()}


def _state_row(carry: Carry, cfg: RunConfig, fetch_keys) -> dict:
    """Host row of a bare filter state (frame 0, or a resume at the end
    of the stream): nis 0, the state itself as its prediction."""
    x = carry.tracks.x.cpu().numpy()
    P = carry.tracks.P.cpu().numpy()
    row = {"pos": x[:, 0:2], "alive": carry.tracks.alive.cpu().numpy(),
           "nis": np.zeros(cfg.tracks.num_tracks, np.float32),
           "track_id": carry.tracks.track_id.cpu().numpy()}
    if "x_filt" in fetch_keys:
        row.update({"x_filt": x, "P_filt": P, "x_pred": x, "P_pred": P})
    if "smoothed_lag" in fetch_keys:
        row["smoothed_lag"] = x[:, 0:2]
    return row


def _assemble_lag_smoothed(rows: List[dict], carry: Carry,
                           cfg: RunConfig) -> np.ndarray:
    """Align the per-step fixed-lag emissions into a (T, K, 2) smoothed
    trajectory: step t's `smoothed_lag` is frame t - lag; the last `lag`
    frames come from one RTS over the final carry window (the window the
    step smoother held), so every frame is smoothed with all the future
    the window ever saw."""
    L = cfg.smooth.lag
    T = len(rows)
    smoothed = np.stack([r["pos"] for r in rows]).astype(np.float32)
    for t in range(L, T):
        smoothed[t - L] = rows[t]["smoothed_lag"]
    # the final window: entry i is frame T - 1 - L + i
    xf, Pf, xp, Pp, tid, alive = carry.lag_buf
    F = torch.as_tensor(dynamics.transition(cfg.ekf), device=xf.device)
    xs, _ = rts_smooth(F, xf, Pf, xp, Pp, breaks=segment_breaks(tid, alive))
    xs = xs[..., 0:2].cpu().numpy()
    for i in range(L + 1):
        f = T - 1 - L + i
        if 0 <= f < T:
            smoothed[f] = xs[i]
    return smoothed


def _resume_carry(path: str, cfg: RunConfig, dev: torch.device) -> Carry:
    """The Carry a checkpoint holds: the previous frame's pyramid rebuilt
    from its gray frame; the corner pool, the fixed-lag window and the
    warm-start field restored where the file has them (the pool
    recomputed from the frame, the window primed flat from the state,
    the field zero, where it does not)."""
    state, prev_gray, frame_idx, ccache, lbuf, pflow = load_state(path)
    prev_gray = upload(prev_gray, dev)
    tracks = TrackState(*[None if a is None else upload(a, dev)
                          for a in state])
    corner_cache = ()
    if cfg.tracks.reinit and cfg.tracks.reinit_every > 1:
        corner_cache = (tuple(upload(a, dev) for a in ccache)
                        if ccache is not None
                        else _fresh_corner_pool(prev_gray, cfg))
    lag = _lag(cfg)
    lag_buf = ()
    if lag:
        lag_buf = (tuple(upload(a, dev) for a in lbuf)
                   if lbuf is not None and lbuf[0].shape[0] == lag + 1
                   else _lag_buf_init(tracks, lag))
    prev_flow = None
    if cfg.flow.temporal_init and not _photometric(cfg):
        prev_flow = (upload(np.asarray(pflow, np.float32), dev)
                     if pflow is not None
                     else torch.zeros(prev_gray.shape + (2,),
                                      dtype=torch.float32, device=dev))
    return Carry(tracks=tracks, prev_gray=prev_gray,
                 prev_rpyr=_flow_pyramid(prev_gray, cfg),
                 corner_cache=corner_cache, frame_idx=frame_idx,
                 lag_buf=lag_buf, prev_flow=prev_flow)


def track_stream(frame_iter: Iterator[np.ndarray], cfg: RunConfig,
                 frame0: np.ndarray = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0, resume: bool = False,
                 render_tmpl=None, seeds: Optional[np.ndarray] = None, *,
                 device="cuda") -> Trajectories:
    """Track a host frame stream with O(1) card memory, on `device` (the
    card unless the caller asks for "cpu").

    One per-frame step a frame (`make_step`, whatever cfg.pair_batch
    says); the next frames' copies to the card overlap the step's compute
    (`io.video.device_prefetch`), and only each step's row comes back.
    With `checkpoint_path` and `checkpoint_every` the filter state is
    written every N frames; `resume=True` reloads it and skips the frames
    it has consumed. `seeds` replaces the corner seeding with (K, 2)
    positions (ignored on resume: the checkpoint carries the tracks).
    Smoothing: with `lag` the fixed-lag rows and one RTS over the final
    window; otherwise the filter history is kept in host memory and
    smoothed a chunk at a time. `render_tmpl`, the mesh-render channels'
    template, is not ported yet."""
    if render_tmpl is not None:
        raise NotImplementedError("track_stream(render_tmpl=...): the "
                                  "mesh-render channels are outside the "
                                  "ported slice (ROADMAP P11b)")
    check_slice(cfg)
    dev = _device(device)
    fetch_keys = _ROWS
    use_lag = bool(_lag(cfg))
    if use_lag:
        fetch_keys += ("smoothed_lag",)
    elif cfg.smooth.enabled:
        fetch_keys += _HISTORY

    rows = []
    it = iter(frame_iter)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        carry = _resume_carry(checkpoint_path, cfg, dev)
        # frame_idx counts filter steps: the state at frame_idx = k has
        # consumed frames 0..k (frame 0 seeded the filter)
        skipped = sum(1 for _ in itertools.islice(it, carry.frame_idx + 1))
        if skipped < carry.frame_idx + 1:
            raise ValueError(
                f"resume: stream ended after {skipped} frames but the "
                f"checkpoint was written at frame {carry.frame_idx}; the "
                f"stream must replay at least the first "
                f"{carry.frame_idx + 1} frames")
    else:
        if frame0 is None:
            frame0 = next(it)
        carry = init_from_frame(upload(frame0, dev), cfg)
        if seeds is not None:
            carry = carry._replace(tracks=init_tracks(cfg.ekf,
                                                      _seeds(seeds, dev)))
        if cfg.tracks.init_velocity:
            # peek at frame 1 to prime the velocities as track_arrays
            # does, then replay it through the loop
            frame1 = next(it, None)
            if frame1 is not None:
                carry = _prime_init_velocity(carry, upload(frame1, dev), cfg)
                it = itertools.chain([frame1], it)
        if carry.lag_buf and (seeds is not None or cfg.tracks.init_velocity):
            # re-prime the window from the replaced seed state
            carry = carry._replace(lag_buf=_lag_buf_init(carry.tracks,
                                                         _lag(cfg)))
        rows.append(_state_row(carry, cfg, fetch_keys))

    step = make_step(cfg, dev)
    fetch = _RowFetch(fetch_keys, dev)
    for frame in device_prefetch(it, depth=2, device=dev):
        carry, out = step(carry, frame)
        row = fetch.push(out)
        if row is not None:
            rows.append(row)
        if (checkpoint_path and checkpoint_every
                and carry.frame_idx % checkpoint_every == 0):
            save_state(checkpoint_path, carry.tracks, carry.prev_gray,
                       carry.frame_idx, corner_cache=carry.corner_cache,
                       lag_buf=carry.lag_buf, prev_flow=carry.prev_flow)
    row = fetch.flush()
    if row is not None:
        rows.append(row)
    if not rows:
        # resumed at (or past) the end of the stream: the restored state
        # as one row
        rows.append(_state_row(carry, cfg, fetch_keys))
    smoothed = None
    if use_lag and len(rows) > 1:
        smoothed = _assemble_lag_smoothed(rows, carry, cfg)
    elif cfg.smooth.enabled and len(rows) > 1:
        hist = {k: torch.from_numpy(np.stack([r[k] for r in rows]))
                for k in _HISTORY + ("track_id", "alive")}
        smoothed = _smooth_history_chunked(hist, cfg, dev)[..., 0:2].numpy()
    return Trajectories(
        **{f: np.stack([r[k] for r in rows]) for f, k in
           (("positions", "pos"), ("alive", "alive"), ("nis", "nis"),
            ("track_id", "track_id"))},
        smoothed=smoothed)
