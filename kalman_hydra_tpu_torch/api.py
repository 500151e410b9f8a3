"""Public API of the port (mirrors kalman_hydra_tpu/api.py).

With no config every entry point runs the reference's default, as the
reference does: `RunConfig()` (exact warp, f32 planes, 4-state CV
filter, 256 tracks, a fresh corner pool every frame), or `FlowConfig()`
for `flow`. Lucas-Kanade configs (`FlowConfig.method` "lk_sparse" or
"lk_dense") and every measurement channel but the mesh render
(`EkfConfig.measurement`, `filter_type`, `adaptive_q`) run through the
same entry points; `pipeline.track_precomputed_flow` tracks over
supplied flows. Only in-memory clips are
ported so far: file decode and
streaming wait for ROADMAP P12. Every entry point runs on the card unless
the caller passes device="cpu"; without a card it raises.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import pipeline as _pipeline
from .config import FlowConfig, RunConfig
from .io import Trajectories, save as save_tracks
from .ops.color import grayscale_u8
from .ops.farneback import farneback
from .ops.lk import lk_dense


def flow(a: np.ndarray, b: np.ndarray, cfg: Optional[FlowConfig] = None,
         initial: Optional[np.ndarray] = None, *,
         device="cuda") -> np.ndarray:
    """Dense flow between two frames, Farneback or dense LK by
    cfg.method, (H, W, 2) float32 on the host. Accepts uint8 or float
    frames, gray or colour; [0, 1]-normalized float frames are rescaled
    to the 0..255 range the solver constants assume. `initial`: optional
    (H, W, 2) warm start of Farneback's coarsest level (cv2's
    OPTFLOW_USE_INITIAL_FLOW); dense LK has none."""
    cfg = cfg or FlowConfig()
    if cfg.method not in ("farneback", "lk_dense"):
        raise ValueError("flow() needs a dense method")
    _pipeline.check_slice(RunConfig(flow=cfg), flow_only=True)
    if cfg.method == "lk_dense" and initial is not None:
        raise ValueError("initial flow is a Farneback feature "
                         "(cv2.OPTFLOW_USE_INITIAL_FLOW)")
    a_np, b_np = np.asarray(a), np.asarray(b)
    if a_np.dtype.kind == "f" and b_np.dtype.kind == "f":
        if max(float(a_np.max()), float(b_np.max())) <= 1.0:
            a_np, b_np = a_np * 255.0, b_np * 255.0
        a_np, b_np = a_np.astype(np.float32), b_np.astype(np.float32)
    a_t = grayscale_u8(_pipeline.upload(a_np, device))
    b_t = grayscale_u8(_pipeline.upload(b_np, device))
    if cfg.method == "lk_dense":
        return lk_dense(a_t, b_t, cfg).cpu().numpy()
    flow0 = (None if initial is None else
             _pipeline.upload(np.asarray(initial, np.float32), device))
    return farneback(a_t, b_t, cfg, flow0).cpu().numpy()


def track_video(source: np.ndarray, cfg: Optional[RunConfig] = None,
                out_path: Optional[str] = None, streaming: bool = False,
                max_frames: Optional[int] = None, *,
                device="cuda") -> Trajectories:
    """Track a (T, H, W[, 3]) uint8 clip on `device`; optionally export."""
    if isinstance(source, str) or streaming:
        raise NotImplementedError("video files and streaming are outside "
                                  "the ported slice (ROADMAP P12)")
    cfg = cfg or RunConfig()
    frames = source if max_frames is None else source[:max_frames]
    tracks = _pipeline.track_clip(frames, cfg, device=device)
    if out_path:
        save_tracks(tracks, out_path)
    return tracks


def flow_sequence(frames: np.ndarray, cfg: Optional[RunConfig] = None,
                  smooth: bool = False, *, device="cuda") -> np.ndarray:
    """Dense flow for each consecutive pair of a (T, H, W[, 3]) uint8
    clip, (T - 1, H, W, 2) on the host, optionally per-pixel-KF smoothed
    (BASELINE.json:8)."""
    cfg = cfg or RunConfig()
    return _pipeline.flow_sequence(_pipeline.upload(frames, device), cfg,
                                   smooth).cpu().numpy()


def smooth(frames_or_tracks: np.ndarray, cfg: Optional[RunConfig] = None,
           *, device="cuda") -> Trajectories:
    """Track a (T, H, W[, 3]) uint8 clip with the RTS smoother on
    (BASELINE.json:11); a config whose smoother is off gets the default
    SmoothConfig(enabled=True). The parameter keeps the reference's
    name, which also admits a video path there (ROADMAP P12)."""
    cfg = cfg or RunConfig()
    if not cfg.smooth.enabled:
        cfg = cfg.replace(smooth=cfg.smooth.__class__(enabled=True))
    return track_video(frames_or_tracks, cfg, device=device)


def track_videos(clips: np.ndarray, cfg: Optional[RunConfig] = None,
                 sharded: bool = False, *,
                 device="cuda") -> List[Trajectories]:
    """Track a (B, T, H, W[, 3]) uint8 clip batch on one device
    (BASELINE.json:10's multi-clip batch); returns B Trajectories.

    With cfg.pair_batch every clip's frame pairs share each flow launch
    (`pipeline.track_clips_pairflow`); otherwise the clips run one after
    another."""
    if sharded:
        raise NotImplementedError("track_videos(sharded=True): clips over "
                                  "several cards is outside the ported "
                                  "slice (ROADMAP P13)")
    cfg = cfg or RunConfig()
    return _pipeline.track_clips(clips, cfg, device=device)
