"""Shi-Tomasi corner response and the static-shape corner pool (port of
kalman_hydra_tpu/ops/features.py).

cv2.cornerMinEigenVal response (Sobel-3, box window, min eigenvalue of
the structure tensor); one candidate per min_distance tile, then the
global top-k. Ties keep the lower index first, as lax.top_k and argmax
do in the reference (stable sorts here).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TrackConfig
from .filters import box_filter, correlate1d

_SOBEL = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SMOOTH = np.array([1.0, 2.0, 1.0], dtype=np.float32)


def min_eig_response(gray: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """cv2.cornerMinEigenVal twin on (H, W) f32, OpenCV's
    1/(4 * 255 * block) scale folded in."""
    scale = 1.0 / (4.0 * 255.0 * block_size)
    gx = correlate1d(correlate1d(gray, _SOBEL, dim=-1), _SMOOTH,
                     dim=-2) * scale
    gy = correlate1d(correlate1d(gray, _SOBEL, dim=-2), _SMOOTH,
                     dim=-1) * scale

    def win(v):
        return box_filter(box_filter(v, block_size, dim=-2,
                                     border="reflect101", normalize=False),
                          block_size, dim=-1, border="reflect101",
                          normalize=False)

    a = win(gx * gx) * 0.5
    b = win(gx * gy) * 0.5
    c = win(gy * gy) * 0.5
    return (a + c) - torch.sqrt((a - c) ** 2 + 4.0 * b * b)


def corner_pool(gray: torch.Tensor, cfg: TrackConfig, pool_size: int = None):
    """Top-k tile-max corner candidates: (pts (P, 2) f32 (x, y),
    score (P,) f32); slots without a confident corner carry score 0."""
    pool_size = pool_size or cfg.corner_pool
    resp = min_eig_response(gray, cfg.corner_block)
    h, w = resp.shape
    tile = max(int(cfg.min_distance), 1)
    ph = (tile - h % tile) % tile
    pw = (tile - w % tile) % tile
    rp = torch.nn.functional.pad(resp, (0, pw, 0, ph), value=-float("inf"))
    th, tw = rp.shape[0] // tile, rp.shape[1] // tile
    tiles = rp.reshape(th, tile, tw, tile).permute(0, 2, 1, 3).reshape(
        th, tw, tile * tile)
    tile_max = tiles.amax(dim=-1)
    tile_arg = tiles.argmax(dim=-1)          # first maximum on ties
    dev = gray.device
    ys = (torch.arange(th, device=dev)[:, None] * tile
          + tile_arg // tile).to(torch.float32)
    xs = (torch.arange(tw, device=dev)[None, :] * tile
          + tile_arg % tile).to(torch.float32)
    flat_score = tile_max.reshape(-1)
    thresh = resp.max() * cfg.quality_level
    flat_score = torch.where(flat_score >= thresh, flat_score,
                             torch.full_like(flat_score, -float("inf")))
    k = min(pool_size, flat_score.shape[0])
    top_score, idx = torch.sort(flat_score, descending=True, stable=True)
    top_score, idx = top_score[:k], idx[:k]
    pts = torch.stack([xs.reshape(-1)[idx], ys.reshape(-1)[idx]], dim=-1)
    score = torch.where(torch.isfinite(top_score), top_score,
                        torch.zeros_like(top_score))
    if k < pool_size:
        pts = torch.nn.functional.pad(pts, (0, 0, 0, pool_size - k))
        score = torch.nn.functional.pad(score, (0, pool_size - k))
    return pts, score
