"""Synthetic clips with analytic ground truth (a copy of
kalman_hydra_tpu/io/synthetic.py: `moving_blob_clip`, `translating_pair`,
`rotating_pair`, `sinusoidal_warp_clip` and `circling_blob_clip`; the
mesh-render clip, `deforming_body_clip`, waits for ROADMAP P11b).

Host-side NumPy, seeded and deterministic: the same arguments give the
same frames and truth, byte for byte, as the reference's generators.
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


def _bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Clamped bilinear sample of a 2-D float image at float coords."""
    h, w = img.shape
    x = np.clip(x, 0, w - 1.001)
    y = np.clip(y, 0, h - 1.001)
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    fx = (x - x0).astype(np.float32)
    fy = (y - y0).astype(np.float32)
    return (img[y0, x0] * (1 - fx) * (1 - fy)
            + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy
            + img[y0 + 1, x0 + 1] * fx * fy).astype(np.float32)


def rotating_pair(height: int = 128, width: int = 128,
                  angle_deg: float = 2.0, seed: int = 0):
    """A grayscale frame pair related by a rigid rotation about the image
    center: frame b(p) = a(f^-1(p)) with f(p) = c + R(theta)(p - c), so
    the prev -> next flow at p is exactly f(p) - p. Returns (a, b,
    flow_true), a/b float32 in [0, 255], flow_true (H, W, 2)."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(0.3 * max(height, width))) + 8
    big = _textured_background(height + 2 * pad, width + 2 * pad, rng) * 255.0
    a = big[pad:pad + height, pad:pad + width].astype(np.float32)

    th = np.deg2rad(angle_deg)
    c = np.array([(width - 1) * 0.5, (height - 1) * 0.5], dtype=np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    dx = xx - c[0]
    dy = yy - c[1]
    # inverse map (rotate by -theta) into the padded source
    cos, sin = np.cos(th), np.sin(th)
    xs = c[0] + cos * dx + sin * dy + pad
    ys = c[1] - sin * dx + cos * dy + pad
    b = _bilinear(big, xs, ys)

    fx = (c[0] + cos * dx - sin * dy) - xx
    fy = (c[1] + sin * dx + cos * dy) - yy
    flow_true = np.stack([fx, fy], axis=-1).astype(np.float32)
    return a, b, flow_true


def sinusoidal_warp_clip(num_frames: int = 10, height: int = 128,
                         width: int = 192, amplitude: float = 2.5,
                         wavelength: float = 96.0, omega: float = 0.45,
                         num_points: int = 12, seed: int = 0,
                         color: bool = True):
    """Non-rigid clip: a travelling sinusoidal vertical warp of a textured
    sheet. Material point q maps to (q_x, q_y + A sin(2 pi q_x / L +
    w t)); the displacement depends only on x, so the inverse is exact.
    Returns (frames, truth, flows): truth.positions the analytic point
    trajectories, flows the analytic (T - 1, H, W, 2) prev -> next flow."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(amplitude)) + 8
    big = _textured_background(height + 2 * pad, width + 2 * pad, rng) * 255.0

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    phase_x = 2.0 * np.pi * xx / wavelength

    # tracked points on a grid in the interior (material coords)
    g = int(np.ceil(np.sqrt(num_points)))
    qy, qx = np.mgrid[0:g, 0:g].astype(np.float32)
    m = 0.18
    qpts = np.stack([
        width * (m + (1 - 2 * m) * qx.ravel() / max(g - 1, 1)),
        height * (m + (1 - 2 * m) * qy.ravel() / max(g - 1, 1)),
    ], axis=-1)[:num_points].astype(np.float32)
    ph_q = 2.0 * np.pi * qpts[:, 0] / wavelength

    frames = np.empty((num_frames, height, width), dtype=np.float32)
    positions = np.empty((num_frames, num_points, 2), dtype=np.float32)
    flows = np.empty((num_frames - 1, height, width, 2), dtype=np.float32)
    for t in range(num_frames):
        disp = amplitude * np.sin(phase_x + omega * t)
        frames[t] = _bilinear(big, xx + pad, yy - disp + pad)
        positions[t, :, 0] = qpts[:, 0]
        positions[t, :, 1] = qpts[:, 1] \
            + amplitude * np.sin(ph_q + omega * t)
        if t > 0:
            # the particle at pixel p in frame t - 1 has q_x = p_x: its
            # next y minus its current y is the exact prev -> next flow
            d_prev = amplitude * np.sin(phase_x + omega * (t - 1))
            flows[t - 1, :, :, 0] = 0.0
            flows[t - 1, :, :, 1] = disp - d_prev
    frames8 = np.clip(frames, 0, 255).astype(np.uint8)
    if color:
        frames8 = np.repeat(frames8[..., None], 3, axis=-1)
    vel = np.zeros((num_frames, 2), dtype=np.float32)
    return frames8, SyntheticTruth(positions=positions, velocity=vel), flows


def circling_blob_clip(num_frames: int = 24, height: int = 192,
                       width: int = 192, blob_sigma: float = 14.0,
                       orbit_radius: float = 36.0, turn_rate: float = 0.22,
                       num_points: int = 12, seed: int = 0,
                       color: bool = True):
    """A textured blob whose center moves on a circle at a constant
    angular rate, the motion the coordinated-turn dynamics ("ct") is for.
    Rendered as `moving_blob_clip` is; only the center's path differs.
    Returns (frames, truth), truth.velocity the center's analytic
    velocity a frame."""
    rng = np.random.default_rng(seed)
    bg = _textured_background(height, width, rng)

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    orbit_c = np.array([width * 0.5, height * 0.5], dtype=np.float32)

    ang = rng.uniform(0, 2 * np.pi, size=num_points)
    rad = rng.uniform(0.2, 0.9, size=num_points) * blob_sigma
    offsets = np.stack([rad * np.cos(ang), rad * np.sin(ang)],
                       axis=-1).astype(np.float32)

    blob_tex = _textured_background(height, width, rng)
    phases = -np.pi / 2 + turn_rate * np.arange(num_frames)
    centers = orbit_c[None, :] + orbit_radius * np.stack(
        [np.cos(phases), np.sin(phases)], axis=-1).astype(np.float32)

    frames = np.empty((num_frames, height, width), dtype=np.float32)
    positions = np.empty((num_frames, num_points, 2), dtype=np.float32)
    vel_t = (orbit_radius * turn_rate * np.stack(
        [-np.sin(phases), np.cos(phases)], axis=-1)).astype(np.float32)
    c0 = centers[0]
    for t in range(num_frames):
        c = centers[t]
        d = np.sqrt((xx - c[0]) ** 2 + (yy - c[1]) ** 2)
        mask = _sigmoid((d - 1.5 * blob_sigma) / (0.25 * blob_sigma))
        shift = c - c0
        tex = _bilinear(blob_tex, xx - shift[0], yy - shift[1])
        fg = 0.55 + 0.45 * tex
        frames[t] = bg * (1 - mask) + fg * mask
        positions[t] = c[None, :] + offsets
    frames8 = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    if color:
        frames8 = np.repeat(frames8[..., None], 3, axis=-1)
    return frames8, SyntheticTruth(positions=positions, velocity=vel_t)


def translating_pair(height: int = 128, width: int = 128,
                     shift: tuple = (3.0, -2.0), seed: int = 0):
    """A grayscale frame pair related by a rigid subpixel translation:
    b(p) = a(p - shift), so the prev -> next flow is exactly `shift`.
    Returns (a, b, flow_true) with a, b float32 in [0, 255]."""
    rng = np.random.default_rng(seed)
    sx, sy = shift
    # the padding covers the shift (16 for |shift| <= 15)
    pad = max(16, int(np.ceil(max(abs(sx), abs(sy)))) + 1)
    big = _textured_background(height + 2 * pad, width + 2 * pad, rng) * 255.0

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    a = big[pad:pad + height, pad:pad + width].astype(np.float32)

    x_src = np.clip(xx + pad - sx, 0.0, width + 2 * pad - 1.001)
    y_src = np.clip(yy + pad - sy, 0.0, height + 2 * pad - 1.001)
    x0 = np.floor(x_src).astype(np.int32)
    y0 = np.floor(y_src).astype(np.int32)
    fx = (x_src - x0).astype(np.float32)
    fy = (y_src - y0).astype(np.float32)
    b = (big[y0, x0] * (1 - fx) * (1 - fy)
         + big[y0, x0 + 1] * fx * (1 - fy)
         + big[y0 + 1, x0] * (1 - fx) * fy
         + big[y0 + 1, x0 + 1] * fx * fy).astype(np.float32)

    flow_true = np.broadcast_to(
        np.array(shift, dtype=np.float32), (height, width, 2)).copy()
    return a, b, flow_true
