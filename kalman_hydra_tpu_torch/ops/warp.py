"""Bilinear sampling (port of kalman_hydra_tpu/ops/warp.py).

Coordinate convention: (x, y) with x = column, matching OpenCV. Samples
outside the image clamp to the border pixel.
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample (..., H, W) images at float coords x, y of one query shape;
    returns (..., *query_shape). Border: clamp."""
    h, w = img.shape[-2], img.shape[-1]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x), 0, w - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, h - 2).to(torch.int64)
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    i00 = img[..., y0, x0]
    i01 = img[..., y0, x0 + 1]
    i10 = img[..., y0 + 1, x0]
    i11 = img[..., y0 + 1, x0 + 1]
    return (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
            + i10 * (1 - fx) * fy + i11 * fx * fy)


def sample_flow(flow: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample (H, W, 2) flow at (K, 2) (x, y) points -> (K, 2). Queries are
    clipped just inside the last pixel (w - 1.001), as the oracle does."""
    h, w = flow.shape[0], flow.shape[1]
    x = torch.clamp(pts[:, 0], 0.0, w - 1.001)
    y = torch.clamp(pts[:, 1], 0.0, h - 1.001)
    return bilinear_sample(flow.movedim(-1, 0), x, y).T
