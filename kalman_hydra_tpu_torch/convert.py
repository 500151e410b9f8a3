"""Carry state between the JAX reference and the port.

The tracker has no learned weights: its whole state is the track pool
(TrackState) plus the per-frame carry (previous gray frame, the cached
polyexp pyramid, the corner pool, the step counter). Given the shared
RunConfig, that state is everything both packages need to compute the
same next step. The reference's state comes in as NumPy arrays (for
example a `jax.device_get` of its Carry); this module never imports jax.

bf16 arrays arrive as ml_dtypes.bfloat16 NumPy arrays and leave as
float32 (exact: every bf16 value is an f32 value).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.ekf import TrackState
from .pipeline import Carry

_TRACK_FIELDS = ("x", "P", "alive", "misses", "track_id")


def array_to_torch(a, device) -> torch.Tensor:
    a = np.array(a)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def tracks_to_torch(tracks, device) -> TrackState:
    """Any object with TrackState's fields (NumPy-convertible) -> the
    port's TrackState on `device`."""
    return TrackState(**{f: array_to_torch(getattr(tracks, f), device)
                         for f in _TRACK_FIELDS})


def tracks_to_numpy(tracks: TrackState) -> dict:
    return {f: tensor_to_numpy(getattr(tracks, f)) for f in _TRACK_FIELDS}


def carry_to_torch(carry, device) -> Carry:
    """The reference's Carry (tracks, prev_gray, prev_rpyr, corner_cache,
    frame_idx; NumPy-convertible leaves) -> the port's Carry."""
    return Carry(
        tracks=tracks_to_torch(carry.tracks, device),
        prev_gray=array_to_torch(carry.prev_gray, device),
        prev_rpyr=tuple(array_to_torch(R, device) for R in carry.prev_rpyr),
        corner_cache=tuple(array_to_torch(a, device)
                           for a in (carry.corner_cache or ())),
        frame_idx=int(np.asarray(carry.frame_idx)))


def carry_to_numpy(carry: Carry) -> dict:
    return {
        "tracks": tracks_to_numpy(carry.tracks),
        "prev_gray": tensor_to_numpy(carry.prev_gray),
        "prev_rpyr": tuple(tensor_to_numpy(R) for R in carry.prev_rpyr),
        "corner_cache": tuple(tensor_to_numpy(a)
                              for a in carry.corner_cache),
        "frame_idx": carry.frame_idx,
    }
