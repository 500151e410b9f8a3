"""Farneback pyramid plan and OpenCV-compatible linear resize (port of
kalman_hydra_tpu/ops/pyramid.py).

`farneback_images` builds each level the way cv2.calcOpticalFlowFarneback
does — GaussianBlur of the ORIGINAL image, then an INTER_LINEAR resize —
and is the per-stage reference for the fused K4 kernel
(kernels/level_image.py).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .filters import cv_round, gaussian_blur


def resize_coeffs(n_out: int, n_in: int):
    """Half-pixel-centre clamped bilinear coefficients (cv2 INTER_LINEAR):
    (i0, i1, frac) numpy arrays of length n_out."""
    scale = n_in / n_out
    s = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.clip(np.floor(s), 0, n_in - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = np.clip(s - i0, 0.0, 1.0)
    return i0, i1, f


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(INTER_LINEAR) on the last two dims (..., H, W)."""
    h, w = img.shape[-2], img.shape[-1]
    dev = img.device
    y0, y1, fy = (torch.as_tensor(a, device=dev)
                  for a in resize_coeffs(out_h, h))
    x0, x1, fx = (torch.as_tensor(a, device=dev)
                  for a in resize_coeffs(out_w, w))
    fy = fy.to(torch.float32)[:, None]
    fx = fx.to(torch.float32)
    rows = (img.index_select(-2, y0) * (1 - fy)
            + img.index_select(-2, y1) * fy)
    return (rows.index_select(-1, x0) * (1 - fx)
            + rows.index_select(-1, x1) * fx)


def farneback_levels(h: int, w: int, levels: int, pyr_scale: float
                     ) -> List[Tuple[int, int, int, float, int]]:
    """Static per-level plan of cv2.calcOpticalFlowFarneback, coarsest
    first: [(k, level_h, level_w, sigma, ksize)] with OpenCV's min_size=32
    clamp, cvRound sizes, sigma = (1/scale - 1)/2 and
    ksize = max(cvRound(5 sigma) | 1, 3)."""
    min_size = 32
    k = 0
    scale = 1.0
    while k < levels:
        scale *= pyr_scale
        if w * scale < min_size or h * scale < min_size:
            break
        k += 1
    plan = []
    for k in range(k, -1, -1):
        scale = pyr_scale ** k
        sigma = (1.0 / scale - 1.0) * 0.5
        ksize = max(cv_round(sigma * 5) | 1, 3)
        plan.append((k, cv_round(h * scale), cv_round(w * scale), sigma,
                     ksize))
    return plan


def gaussian_blur_level(img: torch.Tensor, cfg, k: int = 0) -> torch.Tensor:
    """The blur (no resize) that produces Farneback's level-k image; for
    k = 0 this is the fine-level input (ksize 3, sigma 0)."""
    h, w = img.shape[-2], img.shape[-1]
    for (kk, _lh, _lw, sigma, ksize) in farneback_levels(
            h, w, cfg.levels, cfg.pyr_scale):
        if kk == k:
            return gaussian_blur(img.to(torch.float32), ksize, sigma)
    raise ValueError(f"level {k} not in plan")


def farneback_images(img: torch.Tensor, levels: int,
                     pyr_scale: float) -> List[torch.Tensor]:
    """Level images, coarsest first, each blurred from the ORIGINAL image
    (reflect101) and resized."""
    h, w = img.shape[-2], img.shape[-1]
    f = img.to(torch.float32)
    return [resize_linear(gaussian_blur(f, ksize, sigma), lh, lw)
            for (_k, lh, lw, sigma, ksize)
            in farneback_levels(h, w, levels, pyr_scale)]
