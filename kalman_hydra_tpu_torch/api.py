"""Public API of the port (mirrors kalman_hydra_tpu/api.py).

Only in-memory clips are ported so far: file decode and streaming wait
for ROADMAP P12.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import pipeline as _pipeline
from .config import RunConfig
from .io import Trajectories, save as save_tracks


def track_video(source: np.ndarray, cfg: Optional[RunConfig] = None,
                device="cpu", out_path: Optional[str] = None,
                streaming: bool = False,
                max_frames: Optional[int] = None) -> Trajectories:
    """Track a (T, H, W[, 3]) uint8 clip on `device`; optionally export.

    cfg defaults to `pipeline.main_path_config()` — the reference's
    RunConfig() default runs the exact warp and the whole-level kernel,
    neither of which is ported yet."""
    if isinstance(source, str) or streaming:
        raise NotImplementedError("video files and streaming are outside "
                                  "the ported slice (ROADMAP P12)")
    cfg = cfg or _pipeline.main_path_config()
    frames = source if max_frames is None else source[:max_frames]
    tracks = _pipeline.track_clip(frames, cfg, device=device)
    if out_path:
        save_tracks(tracks, out_path)
    return tracks
