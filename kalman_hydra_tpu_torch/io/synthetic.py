"""Synthetic moving-blob clip with analytic ground truth (port of
kalman_hydra_tpu/io/synthetic.py::moving_blob_clip).

Host-side NumPy, seeded and deterministic: the same arguments give the
same uint8 frames, byte for byte, as the reference's generator.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.ndimage import convolve1d


@dataclass(frozen=True)
class SyntheticTruth:
    positions: np.ndarray   # (T, K, 2) float32 (x, y) per frame per point
    velocity: np.ndarray    # (T, 2) float32 blob velocity per frame


def _textured_background(h: int, w: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Band-limited random texture in [0.25, 0.6]: three passes of a
    separable 5-tap binomial over white noise. Dense flow needs texture
    everywhere (a plain blob is ambiguous away from its rim)."""
    noise = rng.standard_normal((h, w)).astype(np.float32)
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0
    for _ in range(3):
        noise = convolve1d(noise, k, axis=0, mode="reflect")
        noise = convolve1d(noise, k, axis=1, mode="reflect")
    noise -= noise.min()
    noise /= max(noise.max(), 1e-6)
    return 0.25 + 0.35 * noise


def _sigmoid(x: np.ndarray) -> np.ndarray:
    """Overflow-safe 1 / (1 + exp(x))."""
    return (1.0 / (1.0 + np.exp(np.clip(x, -60.0, 60.0)))).astype(np.float32)


def moving_blob_clip(num_frames: int = 16, height: int = 256,
                     width: int = 256, blob_sigma: float = 12.0,
                     velocity: tuple = (1.7, -1.1), accel: tuple = (0.0, 0.0),
                     num_points: int = 16, seed: int = 0, color: bool = True):
    """A textured clip with a bright, internally textured blob moving at
    (near-)constant velocity, and `num_points` points riding on it.

    Returns frames, (T, H, W, 3) uint8 if color else (T, H, W), and a
    SyntheticTruth with the points' (x, y) per frame."""
    rng = np.random.default_rng(seed)
    bg = _textured_background(height, width, rng)

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    c0 = np.array([width * 0.35, height * 0.6], dtype=np.float32)
    v = np.array(velocity, dtype=np.float32)
    a = np.array(accel, dtype=np.float32)

    ang = rng.uniform(0, 2 * np.pi, size=num_points)
    rad = rng.uniform(0.2, 0.9, size=num_points) * blob_sigma
    offsets = np.stack([rad * np.cos(ang), rad * np.sin(ang)],
                       axis=-1).astype(np.float32)

    frames = np.empty((num_frames, height, width), dtype=np.float32)
    positions = np.empty((num_frames, num_points, 2), dtype=np.float32)
    vel_t = np.empty((num_frames, 2), dtype=np.float32)
    blob_tex = _textured_background(height, width, rng)

    for t in range(num_frames):
        c = c0 + v * t + 0.5 * a * t * t
        vel_t[t] = v + a * t
        d = np.sqrt((xx - c[0]) ** 2 + (yy - c[1]) ** 2)
        # plateau ~1 inside 1.5 sigma, soft rim after: the points (inside
        # 0.9 sigma) see pure blob motion
        mask = _sigmoid((d - 1.5 * blob_sigma) / (0.25 * blob_sigma))
        sx, sy = c - c0                 # the blob texture moves rigidly
        x_src = np.clip(xx - sx, 0, width - 1)
        y_src = np.clip(yy - sy, 0, height - 1)
        x0 = np.floor(x_src).astype(np.int32)
        y0 = np.floor(y_src).astype(np.int32)
        x1 = np.minimum(x0 + 1, width - 1)
        y1 = np.minimum(y0 + 1, height - 1)
        fx = x_src - x0
        fy = y_src - y0
        tex = (blob_tex[y0, x0] * (1 - fx) * (1 - fy)
               + blob_tex[y0, x1] * fx * (1 - fy)
               + blob_tex[y1, x0] * (1 - fx) * fy
               + blob_tex[y1, x1] * fx * fy)
        fg = 0.55 + 0.45 * tex
        frames[t] = bg * (1 - mask) + fg * mask
        positions[t] = c[None, :] + offsets

    frames8 = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    if color:
        frames8 = np.repeat(frames8[..., None], 3, axis=-1)
    return frames8, SyntheticTruth(positions=positions, velocity=vel_t)
