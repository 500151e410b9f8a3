"""Grayscale conversion (port of kalman_hydra_tpu/ops/color.py).

uint8 BGR uses OpenCV 5.x's 15-bit fixed-point BT.601 weights,
(B*3735 + G*19235 + R*9798 + 16384) >> 15, in integer arithmetic: the
result is bit-exact against the reference and cv2.cvtColor.
"""

from __future__ import annotations

import torch

_B, _G, _R = 3735, 19235, 9798


def grayscale_u8(frame: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 BGR -> (..., H, W) float32 holding the exact
    uint8 gray values. Float colour frames take the float weights; gray
    frames are cast."""
    if frame.ndim >= 3 and frame.shape[-1] == 3:
        if frame.dtype.is_floating_point:
            return grayscale(frame)
        f = frame.to(torch.int32)
        y = (f[..., 0] * _B + f[..., 1] * _G + f[..., 2] * _R
             + (1 << 14)) >> 15
        return y.to(torch.float32)
    return frame.to(torch.float32)


def grayscale(frame: torch.Tensor) -> torch.Tensor:
    """Float grayscale (no uint8 rounding): Y = .299R + .587G + .114B."""
    if frame.ndim >= 3 and frame.shape[-1] == 3:
        f = frame.to(torch.float32)
        return f[..., 0] * 0.114 + f[..., 1] * 0.587 + f[..., 2] * 0.299
    return frame.to(torch.float32)
