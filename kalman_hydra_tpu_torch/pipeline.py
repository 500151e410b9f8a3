"""Tracking pipeline (port of the Farneback + position-EKF path of
kalman_hydra_tpu/pipeline.py).

Per frame: grayscale -> polyexp pyramid (K4 coarse levels, K3 full res)
-> Farneback iterations from the cached previous pyramid (K2) -> sample
the flow at the tracks -> fused predict + update (K1) -> gate, kill,
reseed from a corner pool refreshed every `reinit_every` frames. The
reference's `lax.scan` is a Python frame loop here and its `lax.cond`
refresh cadence a plain `if`; the clip stays on the device and only the
(T, K) trajectory rows leave it at the end.

Only the slice this package ports runs: `check_slice` raises
NotImplementedError, naming the ROADMAP item, for any other setting.
TPU-only knobs that do not change results (impl, pallas_interpret,
fi_tile_h, fi_shift_skip, pe_tile_h) are ignored.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import cuda_device
from .config import EkfConfig, FlowConfig, RunConfig, TrackConfig
from .io import Trajectories
from .models import dynamics, lifecycle
from .models.ekf import TrackState, ekf_step, init_tracks
from .ops.color import grayscale_u8
from .ops.farneback import farneback_from_pyramids, polyexp_pyramid
from .ops.features import corner_pool


class Carry(NamedTuple):
    tracks: TrackState
    prev_gray: torch.Tensor     # (H, W) f32
    prev_rpyr: Tuple = ()       # cached polyexp pyramid of prev_gray
    corner_cache: Tuple = ()    # (pts, score) pool reused between refreshes
    frame_idx: int = 0          # filter steps taken (reinit_every cadence)


def main_path_config(num_tracks: int = 1024) -> RunConfig:
    """The ported slice of the 1080p headline configuration: Farneback
    (5 levels, winsize 15, 3 iterations, poly 5/1.1, fast_warp 8, bf16
    planes, per-iteration kernels on every level), 6-state CA EKF with
    position measurements, corner pool refreshed every 4 frames."""
    return RunConfig(
        flow=FlowConfig(fast_warp=8, bf16_poly=True, fi_level_fused=False),
        ekf=EkfConfig(state_dim=6),
        tracks=TrackConfig(num_tracks=num_tracks,
                           corner_pool=max(256, num_tracks),
                           reinit_every=4),
        impl="pallas")


def check_slice(cfg: RunConfig) -> None:
    """Raise NotImplementedError for any setting outside the ported slice."""
    f, e, t = cfg.flow, cfg.ekf, cfg.tracks
    outside = (
        (f.method != "farneback", f"flow.method={f.method!r} (ROADMAP P10)"),
        (f.fi_level_fused, "flow.fi_level_fused=True: the whole-level "
         "kernel flow_level (ROADMAP K5); set fi_level_fused=False"),
        (f.fi_pipeline, "flow.fi_pipeline=True (ROADMAP K13)"),
        (f.fast_warp <= 0, "flow.fast_warp=0, the exact warp (ROADMAP K8)"),
        (not f.pe_fused, "flow.pe_fused=False (ROADMAP K11)"),
        (f.temporal_init, "flow.temporal_init (ROADMAP P9)"),
        (cfg.pair_batch, "pair_batch (ROADMAP P8)"),
        (cfg.smooth.enabled, "smoothing (ROADMAP P7)"),
        (t.init_velocity, "tracks.init_velocity (ROADMAP P9)"),
        (t.seed_in_body, "tracks.seed_in_body (ROADMAP P11)"),
        (e.adaptive_q > 0, "ekf.adaptive_q (ROADMAP P11)"),
        (e.measurement != "position",
         f"ekf.measurement={e.measurement!r} (ROADMAP P11)"),
    )
    for bad, what in outside:
        if bad:
            raise NotImplementedError(
                f"{what} is outside the ported slice of kalman_hydra_tpu")


def init_from_frame(frame0: torch.Tensor, cfg: RunConfig) -> Carry:
    """Seed the track pool from frame 0's corner pool and cache its
    polyexp pyramid (and, with reinit_every > 1, its corner pool)."""
    gray0 = grayscale_u8(frame0)
    pts, score = corner_pool(gray0, cfg.tracks,
                             pool_size=cfg.tracks.num_tracks)
    state = init_tracks(cfg.ekf, pts, valid=score > 0)
    corner_cache = ()
    if cfg.tracks.reinit and cfg.tracks.reinit_every > 1:
        corner_cache = corner_pool(gray0, cfg.tracks)
    return Carry(tracks=state, prev_gray=gray0,
                 prev_rpyr=polyexp_pyramid(gray0, cfg.flow),
                 corner_cache=corner_cache, frame_idx=0)


def make_step(cfg: RunConfig, device):
    """Per-frame step function (carry, frame) -> (carry, out)."""
    F = torch.as_tensor(dynamics.transition(cfg.ekf), device=device)
    Q = torch.as_tensor(dynamics.process_noise(cfg.ekf), device=device)

    def step(carry: Carry, frame: torch.Tensor):
        gray = grayscale_u8(frame)
        h, w = gray.shape
        rpyr = polyexp_pyramid(gray, cfg.flow)
        flow = farneback_from_pyramids(carry.prev_rpyr, rpyr, cfg.flow)
        state, aux = ekf_step(carry.tracks, flow, cfg.ekf, F, Q)
        state = lifecycle.gate(state, aux["x_pred"], aux["P_pred"],
                               aux["nis"], cfg.ekf)
        state = lifecycle.kill_lost(state, cfg.ekf, h, w)
        corner_cache = carry.corner_cache
        frame_idx = carry.frame_idx + 1
        if cfg.tracks.reinit:
            if cfg.tracks.reinit_every <= 1 or not corner_cache:
                cpts, cscore = corner_pool(gray, cfg.tracks)
            else:
                if frame_idx % cfg.tracks.reinit_every == 0:
                    corner_cache = corner_pool(gray, cfg.tracks)
                cpts, cscore = corner_cache
            state = lifecycle.reseed(state, cpts, cscore, cfg.ekf,
                                     cfg.tracks)
        out = {"pos": state.x[:, 0:2], "alive": state.alive,
               "nis": aux["nis"], "track_id": state.track_id}
        return Carry(tracks=state, prev_gray=gray, prev_rpyr=rpyr,
                     corner_cache=corner_cache, frame_idx=frame_idx), out

    return step


def track_arrays(frames: torch.Tensor, cfg: RunConfig) -> dict:
    """(T, H, W[, 3]) frame tensor -> {"pos", "alive", "nis", "track_id"}
    stacked over T (row 0 is the seeded state, nis 0)."""
    check_slice(cfg)
    carry = init_from_frame(frames[0], cfg)
    s0 = carry.tracks
    rows = [{"pos": s0.x[:, 0:2], "alive": s0.alive,
             "nis": torch.zeros_like(s0.x[:, 0]), "track_id": s0.track_id}]
    step = make_step(cfg, frames.device)
    for t in range(1, frames.shape[0]):
        carry, out = step(carry, frames[t])
        rows.append(out)
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def track_clip(frames: np.ndarray, cfg: RunConfig,
               device="cpu") -> Trajectories:
    """Track a whole (T, H, W[, 3]) uint8 clip on `device`."""
    device = torch.device(device)
    if device.type == "cuda":
        cuda_device(device.index or 0)       # TF32 off before any work
    frames_d = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    outs = {k: v.cpu().numpy() for k, v in track_arrays(frames_d, cfg).items()}
    return Trajectories(positions=outs["pos"], alive=outs["alive"],
                        nis=outs["nis"], track_id=outs["track_id"])
