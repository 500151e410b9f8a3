"""Checkpoint / resume for streaming tracking (a copy of
`kalman_hydra_tpu/utils/checkpoint.py`).

The pipeline's whole state is small: the track pool, the previous gray
frame, the step counter, the corner pool and the fixed-lag smoother's
window, so plain compressed npz holds it. The file has the reference's
keys, dtypes and shapes, so a checkpoint written by either package
resumes in the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.ekf import TrackState

# fixed-lag window entries, in pipeline.Carry.lag_buf order
_LAG_KEYS = ("lag_xf", "lag_Pf", "lag_xp", "lag_Pp", "lag_tid", "lag_alive")
_TRACK_KEYS = ("x", "P", "alive", "misses", "track_id")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous().numpy()
    return np.asarray(a)


def save_state(path: str, state: TrackState, prev_gray, frame_idx: int,
               corner_cache: Tuple = (), lag_buf: Tuple = (),
               prev_flow=None) -> None:
    """Write the state (tensors on any device, or arrays) to `path`."""
    extra = {}
    if corner_cache:
        extra["corner_pts"] = _np(corner_cache[0])
        extra["corner_score"] = _np(corner_cache[1])
    if prev_flow is not None:
        # the temporal warm start: without it the first pair after a
        # resume would start cold and leave the uninterrupted stream
        extra["prev_flow"] = _np(prev_flow)
    if state.q_scale is not None:
        extra["q_scale"] = _np(state.q_scale)
    if lag_buf:
        # the (lag + 1)-deep smoother window ((lag + 1, K, n[, n]) an
        # entry): with it a resume equals an uninterrupted stream, without
        # it the first `lag` smoothed rows lean on a flat re-primed window
        for k, a in zip(_LAG_KEYS, lag_buf):
            extra[k] = _np(a)
    np.savez_compressed(
        path, **{k: _np(getattr(state, k)) for k in _TRACK_KEYS},
        prev_gray=_np(prev_gray), frame_idx=np.int64(frame_idx), **extra)


def load_state(path: str) -> Tuple[TrackState, np.ndarray, int,
                                   Optional[Tuple], Optional[Tuple],
                                   Optional[np.ndarray]]:
    """Returns (state, prev_gray, frame_idx, corner_cache, lag_buf,
    prev_flow), as the NumPy arrays the file holds; the last three are
    None where the file has none (older checkpoints)."""
    with np.load(path) as z:
        state = TrackState(
            **{k: z[k] for k in _TRACK_KEYS},
            q_scale=z["q_scale"] if "q_scale" in z else None)
        corner_cache = None
        if "corner_pts" in z:
            corner_cache = (z["corner_pts"], z["corner_score"])
        lag_buf = None
        if _LAG_KEYS[0] in z:
            lag_buf = tuple(z[k] for k in _LAG_KEYS)
        prev_flow = z["prev_flow"] if "prev_flow" in z else None
        return state, z["prev_gray"], int(z["frame_idx"]), corner_cache, \
            lag_buf, prev_flow
