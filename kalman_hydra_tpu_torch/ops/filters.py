"""Separable filtering primitives (port of kalman_hydra_tpu/ops/filters.py).

OpenCV border names: "reflect101" = cv2.BORDER_REFLECT_101 (edge pixel not
repeated), "replicate" = cv2.BORDER_REPLICATE. Borders are index maps, so
every filter here is a sum of gathered shifted copies in f32.
"""

from __future__ import annotations

import numpy as np
import torch

# OpenCV getGaussianKernel fixed small kernels for sigma <= 0
_SMALL_GAUSSIAN = {
    1: np.array([1.0], np.float64),
    3: np.array([0.25, 0.5, 0.25], np.float64),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float64),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125], np.float64),
}


def cv_round(x: float) -> int:
    """OpenCV cvRound: round half to even."""
    return int(np.rint(x))


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel (float64 internals, float32 result)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].astype(np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    g = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def border_index(n: int, lo: int, hi: int, border: str) -> np.ndarray:
    """Source indices of the padded axis [-lo, n + hi) under `border`."""
    i = np.arange(-lo, n + hi)
    if border == "replicate":
        return np.clip(i, 0, n - 1)
    if border == "reflect101":
        if n == 1:
            return np.zeros_like(i)
        period = 2 * n - 2
        i = np.abs(i) % period
        return np.where(i >= n, period - i, i)
    raise ValueError(f"unknown border {border!r}")


def pad1d(x: torch.Tensor, lo: int, hi: int, dim: int,
          border: str) -> torch.Tensor:
    dim = dim % x.ndim
    idx = torch.as_tensor(border_index(x.shape[dim], lo, hi, border),
                          device=x.device)
    return x.index_select(dim, idx)


def correlate1d(x: torch.Tensor, kernel, dim: int,
                border: str = "reflect101") -> torch.Tensor:
    """Same-shape 1-D correlation along `dim` with an odd-length kernel:
    out[i] = sum_k kernel[k] * x[i + k - r] (f32 shifted adds)."""
    kernel = np.asarray(kernel, dtype=np.float32)
    dim = dim % x.ndim
    r = len(kernel) // 2
    n = x.shape[dim]
    xp = pad1d(x, r, r, dim, border)
    out = None
    for k, wk in enumerate(kernel):
        term = float(wk) * xp.narrow(dim, k, n)
        out = term if out is None else out + term
    return out


def sep_filter2d(x: torch.Tensor, kx, ky, border: str = "reflect101"):
    """Separable 2-D correlation over the last two dims (..., H, W)."""
    x = correlate1d(x, ky, dim=-2, border=border)
    return correlate1d(x, kx, dim=-1, border=border)


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float,
                  border: str = "reflect101") -> torch.Tensor:
    """cv2.GaussianBlur twin (separable, same kernel generation)."""
    k = gaussian_kernel(ksize, sigma)
    return sep_filter2d(x, k, k, border=border)


def box_filter(x: torch.Tensor, size: int, dim: int,
               border: str = "replicate", normalize: bool = True):
    """Odd-size box filter along one dim, summed in f32 in the reference's
    order: for size = 3a >= 9 a 3-tap sum, then a of those at stride 3
    (its _box_split3); otherwise tap after tap."""
    dim = dim % x.ndim
    r = size // 2
    n = x.shape[dim]
    xp = pad1d(x, r, r, dim, border).to(torch.float32)
    if size >= 9 and size % 3 == 0:
        m = n + size - 3
        xp = xp.narrow(dim, 0, m) + xp.narrow(dim, 1, m) \
            + xp.narrow(dim, 2, m)
        taps = [xp.narrow(dim, 3 * j, n) for j in range(size // 3)]
    else:
        taps = [xp.narrow(dim, k, n) for k in range(size)]
    out = taps[0]
    for t in taps[1:]:
        out = out + t
    return out / size if normalize else out


def box_blur2d(x: torch.Tensor, size: int, border: str = "replicate",
               normalize: bool = True):
    """size x size box filter over the last two dims (cv2.blur twin):
    `box_filter` down the rows, then along them."""
    x = box_filter(x, size, -2, border=border, normalize=normalize)
    return box_filter(x, size, -1, border=border, normalize=normalize)
