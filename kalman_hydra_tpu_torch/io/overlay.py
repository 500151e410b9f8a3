"""Debug track-overlay rendering (a copy of
`kalman_hydra_tpu/io/overlay.py`): host-side, post-hoc, never part of the
compute path. Tracks get stable colors keyed by (slot, generation), so a
re-seeded track visibly changes color. OpenCV draws; it computes nothing.
"""

from __future__ import annotations

import numpy as np

from .export import Trajectories
from .video import write_video


def _color(slot: int, gen: int) -> tuple:
    rng = np.random.default_rng(slot * 9973 + gen * 7919)
    c = rng.integers(64, 255, size=3)
    return int(c[0]), int(c[1]), int(c[2])


def render_overlay(frames: np.ndarray, tracks: Trajectories,
                   trail: int = 8, radius: int = 3) -> np.ndarray:
    """Draw tracks onto (T, H, W, 3) uint8 frames -> annotated copy."""
    import cv2  # drawing only
    out = frames.copy()
    if out.ndim == 3:
        out = np.repeat(out[..., None], 3, axis=-1)
    T, K = tracks.alive.shape
    gens = (tracks.track_id if tracks.track_id is not None
            else np.zeros_like(tracks.alive, dtype=np.int32))
    for t in range(T):
        img = out[t]
        for k in range(K):
            if not tracks.alive[t, k]:
                continue
            col = _color(k, int(gens[t, k]))
            x, y = tracks.positions[t, k]
            cv2.circle(img, (int(round(x)), int(round(y))), radius, col, 1)
            for tt in range(max(0, t - trail), t):
                if not tracks.alive[tt, k] or gens[tt, k] != gens[t, k]:
                    continue
                p0 = tracks.positions[tt, k]
                p1 = tracks.positions[tt + 1, k]
                cv2.line(img, (int(round(p0[0])), int(round(p0[1]))),
                         (int(round(p1[0])), int(round(p1[1]))), col, 1)
    return out


def write_overlay(path: str, frames: np.ndarray, tracks: Trajectories,
                  fps: float = 30.0, **kw) -> None:
    write_video(path, render_overlay(frames, tracks, **kw), fps=fps)


def flow_to_rgb(flow: np.ndarray, max_mag: float = None) -> np.ndarray:
    """HSV flow visualization: hue = direction, value = magnitude.

    flow: (H, W, 2) -> (H, W, 3) uint8 RGB. Host-side debug helper.
    """
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx * fx + fy * fy)
    ang = np.arctan2(fy, fx)
    if max_mag is None:
        max_mag = max(float(np.percentile(mag, 99)), 1e-6)
    h = (ang + np.pi) / (2 * np.pi)            # [0, 1)
    v = np.clip(mag / max_mag, 0, 1)
    i = (h * 6).astype(int) % 6
    f = h * 6 - np.floor(h * 6)
    p = np.zeros_like(v)
    q = v * (1 - f)
    t = v * f
    ii = i[..., None]
    rgb = np.select(
        [ii == 0, ii == 1, ii == 2, ii == 3, ii == 4, ii == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return (rgb * 255).astype(np.uint8)
