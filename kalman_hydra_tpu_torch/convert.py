"""Carry state between the JAX reference and the port.

The tracker has no learned weights: its whole state is the track pool
(TrackState, with adaptive_q's per-track Q scales or None) plus the
per-frame carry (previous gray frame, the cached flow pyramid, the
corner pool, the step counter, the fixed-lag smoother's window and the
temporal warm start's previous flow). Given one
configuration (the port's own RunConfig, which a reference config
becomes through `RunConfig.from_json(cfg.to_json())`), that state is
everything both packages need to compute the same next step. The
reference's state comes in as NumPy arrays (for example a
`jax.device_get` of its Carry); this module never imports jax.

bf16 arrays arrive as ml_dtypes.bfloat16 NumPy arrays and leave as
float32 (exact: every bf16 value is an f32 value).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.ekf import TrackState
from .models.render import RenderTemplate, template_from_arrays
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


def tree_to_torch(tree, device):
    """Nested tuples of arrays (the cached pyramids: a tuple of polyexp
    levels, or lk_sparse's (pyr, grads) with grads a tuple of (gx, gy))
    -> the same nesting of tensors."""
    if isinstance(tree, (tuple, list)):
        return tuple(tree_to_torch(t, device) for t in tree)
    return array_to_torch(tree, device)


def tree_to_numpy(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(tree_to_numpy(t) for t in tree)
    return tensor_to_numpy(tree)


def tracks_to_torch(tracks, device) -> TrackState:
    """Any object with TrackState's fields (NumPy-convertible; q_scale
    None or absent unless adaptive_q) -> the port's TrackState on
    `device`."""
    q = getattr(tracks, "q_scale", None)
    return TrackState(**{f: array_to_torch(getattr(tracks, f), device)
                         for f in _TRACK_FIELDS},
                      q_scale=None if q is None else array_to_torch(q, device))


def tracks_to_numpy(tracks: TrackState) -> dict:
    out = {f: tensor_to_numpy(getattr(tracks, f)) for f in _TRACK_FIELDS}
    out["q_scale"] = (None if tracks.q_scale is None
                      else tensor_to_numpy(tracks.q_scale))
    return out


def template_to_torch(tmpl, device) -> RenderTemplate:
    """The reference's RenderTemplate (tri, bary, tvals, rest, pix;
    NumPy-convertible) -> the port's, on `device`."""
    return template_from_arrays(*(np.asarray(getattr(tmpl, f)) for f in
                                  ("tri", "bary", "tvals", "rest", "pix")),
                                device=device)


def carry_to_torch(carry, device) -> Carry:
    """The reference's Carry (tracks, prev_gray, prev_rpyr, corner_cache,
    frame_idx, lag_buf, prev_flow; NumPy-convertible leaves) -> the
    port's Carry."""
    return Carry(
        tracks=tracks_to_torch(carry.tracks, device),
        prev_gray=array_to_torch(carry.prev_gray, device),
        prev_rpyr=tree_to_torch(carry.prev_rpyr, device),
        corner_cache=tuple(array_to_torch(a, device)
                           for a in (carry.corner_cache or ())),
        frame_idx=int(np.asarray(carry.frame_idx)),
        lag_buf=tuple(array_to_torch(a, device)
                      for a in (carry.lag_buf or ())),
        prev_flow=(None if carry.prev_flow is None
                   else array_to_torch(carry.prev_flow, device)))


def carry_to_numpy(carry: Carry) -> dict:
    return {
        "tracks": tracks_to_numpy(carry.tracks),
        "prev_gray": tensor_to_numpy(carry.prev_gray),
        "prev_rpyr": tree_to_numpy(carry.prev_rpyr),
        "corner_cache": tuple(tensor_to_numpy(a)
                              for a in carry.corner_cache),
        "frame_idx": carry.frame_idx,
        "lag_buf": tuple(tensor_to_numpy(a) for a in carry.lag_buf),
        "prev_flow": (None if carry.prev_flow is None
                      else tensor_to_numpy(carry.prev_flow)),
    }
