"""K3 wrapper: Farneback polynomial expansion (csrc/polyexp.cu).

Replaces kalman_hydra_tpu/kernels/polyexp_pallas.py::poly_expansion_planar:
(H, W) f32 -> (5, H, W) planes [b_x, b_y, a_xx, a_yy, axy] in f32 or bf16,
replicate border, all arithmetic f32 with one rounding at the store.

CPU tensors take `poly_expansion_planar_plain`; CUDA tensors launch the
kernel, or raise.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build
from ..ops.filters import pad1d

_DTYPES = (torch.float32, torch.bfloat16)


@lru_cache(maxsize=32)
def _poly_inv_gram(n: int, sigma: float):
    """Closed-form inverse-Gram coefficients of the basis
    {1, x, y, x^2, y^2, xy} under the separable Gaussian applicability
    (OpenCV FarnebackPrepareGaussian; ops/farneback.py in the reference).
    Returns (g, ig11, ig03, ig33, ig55) as float32."""
    i = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(i * i) / (2.0 * sigma * sigma))
    g /= g.sum()
    G = np.zeros((6, 6), dtype=np.float64)
    for yk, wy in zip(i, g):
        for xk, wx in zip(i, g):
            w = wx * wy
            G[0, 0] += w
            G[1, 1] += w * xk * xk
            G[2, 2] += w * yk * yk
            G[3, 3] += w * xk ** 4
            G[4, 4] += w * yk ** 4
            G[5, 5] += w * xk * xk * yk * yk
            G[0, 3] += w * xk * xk
            G[0, 4] += w * yk * yk
            G[3, 4] += w * xk * xk * yk * yk
    G[3, 0] = G[0, 3]
    G[4, 0] = G[0, 4]
    G[4, 3] = G[3, 4]
    invG = np.linalg.inv(G)
    return (g.astype(np.float32), np.float32(invG[1, 1]),
            np.float32(invG[0, 3]), np.float32(invG[3, 3]),
            np.float32(invG[5, 5]))


@lru_cache(maxsize=32)
def poly_taps(n: int, sigma: float) -> np.ndarray:
    """Kernel constants [g, xg, xxg (2n+1 each), ig11, ig03, ig33, ig55]."""
    g, ig11, ig03, ig33, ig55 = _poly_inv_gram(n, float(sigma))
    i = np.arange(-n, n + 1, dtype=np.float32)
    arr = np.concatenate([g, (i * g).astype(np.float32),
                          (i * i * g).astype(np.float32),
                          np.array([ig11, ig03, ig33, ig55], np.float32)])
    arr.setflags(write=False)
    return arr


def polyexp_valid_plain(src: torch.Tensor, n: int,
                        sigma: float) -> torch.Tensor:
    """Valid-mode expansion of an image padded by n on each side:
    (h + 2n, w + 2n) -> (5, h, w) f32, in the TPU kernel's tap order."""
    taps = poly_taps(n, float(sigma))
    t = 2 * n + 1
    g, xg, xxg = (taps[j * t:(j + 1) * t].tolist() for j in range(3))
    ig11, ig03, ig33, ig55 = taps[3 * t:].tolist()
    h, w = src.shape[0] - 2 * n, src.shape[1] - 2 * n
    src = src.to(torch.float32)
    v0 = v1 = v2 = None
    for k in range(t):
        row = src[k:k + h, :]
        v0 = g[k] * row if v0 is None else v0 + g[k] * row
        v1 = xg[k] * row if v1 is None else v1 + xg[k] * row
        v2 = xxg[k] * row if v2 is None else v2 + xxg[k] * row
    m00 = m10 = m20 = m01 = m11 = m02 = None
    for k in range(t):
        c0, c1, c2 = v0[:, k:k + w], v1[:, k:k + w], v2[:, k:k + w]
        terms = (g[k] * c0, xg[k] * c0, xxg[k] * c0, g[k] * c1,
                 xg[k] * c1, g[k] * c2)
        if m00 is None:
            m00, m10, m20, m01, m11, m02 = terms
        else:
            m00, m10, m20, m01, m11, m02 = (
                a + b for a, b in zip((m00, m10, m20, m01, m11, m02), terms))
    return torch.stack([m10 * ig11, m01 * ig11, m00 * ig03 + m20 * ig33,
                        m00 * ig03 + m02 * ig33, m11 * ig55])


def poly_expansion_planar_plain(img: torch.Tensor, poly_n: int,
                                poly_sigma: float,
                                out_dtype=torch.float32) -> torch.Tensor:
    n = poly_n
    src = pad1d(pad1d(img.to(torch.float32), n, n, 0, "replicate"),
                n, n, 1, "replicate")
    return polyexp_valid_plain(src, n, poly_sigma).to(out_dtype)


def poly_expansion_planar(img: torch.Tensor, poly_n: int, poly_sigma: float,
                          out_dtype=torch.float32) -> torch.Tensor:
    """(H, W) f32 -> (5, H, W) coefficient planes in out_dtype."""
    if img.device.type == "cpu":
        return poly_expansion_planar_plain(img, poly_n, poly_sigma,
                                           out_dtype)
    _build.require(img, "img", (torch.float32,), 2)
    if out_dtype not in _DTYPES:
        raise TypeError(f"poly_expansion_planar: out_dtype {out_dtype}")
    h, w = img.shape
    out = torch.empty((5, h, w), dtype=out_dtype, device=img.device)
    taps = poly_taps(poly_n, float(poly_sigma))
    fn = _build.function("kh_polyexp", _build.P, _build.I, _build.I,
                         _build.P, _build.I, _build.I, _build.P, _build.P)
    rc = fn(img.data_ptr(), h, w, taps.ctypes.data, poly_n,
            int(out_dtype == torch.bfloat16), out.data_ptr(),
            _build.stream(img))
    _build.check(rc, "kh_polyexp")
    poly_expansion_planar.launches += 1
    return out


poly_expansion_planar.launches = 0
