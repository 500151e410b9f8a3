"""K4 wrapper: coarse Farneback level images + polyexp (csrc/level_image.cu).

Replaces kalman_hydra_tpu/kernels/level_image_pallas.py::
coarse_polyexp_fused. For every coarse plan entry (k >= 1, coarsest
first) the level image is GaussianBlur(original, reflect101) composed
with the INTER_LINEAR resize, replicate-padded by n, and expanded into 5
polyexp planes. Returns a list of (5, lh, lw) arrays; level 0 is the
caller's business.

The composed weights are the reference's band matrices (_band_mats,
_band_mats_padded) stored sparsely: per output row (or column) the source
indices and float32 weights of its non-zeros. CPU tensors take
`coarse_polyexp_fused_plain`, which builds the level images stage by stage
(ops.pyramid.farneback_images: full-res blur, then resize) — an
independent route to the same values. CUDA tensors launch the kernel per
level, or raise.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build
from .polyexp import poly_taps, polyexp_valid_plain
from ..ops.filters import border_index, gaussian_kernel, pad1d
from ..ops.pyramid import farneback_images, farneback_levels, resize_coeffs


def _axis_matrix(n_out: int, n_in: int, ksize: int, sigma: float):
    """Dense (n_out, n_in) float64 blur(reflect101)+resize composition,
    built exactly as the reference's _band_mats.axis_mat."""
    g = gaussian_kernel(ksize, sigma).astype(np.float64)
    r = ksize // 2

    def blur_row(c: int) -> np.ndarray:
        row = np.zeros(n_in, np.float64)
        src = border_index(n_in, r, r, "reflect101")[c:c + ksize]
        np.add.at(row, src, g)
        return row

    M = np.zeros((n_out, n_in), np.float64)
    i0s, i1s, fs = resize_coeffs(n_out, n_in)
    for o in range(n_out):
        f = float(fs[o])
        M[o] += (1.0 - f) * blur_row(int(i0s[o]))
        if f > 0.0:
            M[o] += f * blur_row(int(i1s[o]))
    return M


def _tap_table(mat: np.ndarray):
    """Rows of a float32 band matrix -> (idx (rows, T) int32, wt (rows, T)
    f32) of its non-zeros, zero-weight padded to a common T."""
    nz = [np.flatnonzero(row) for row in mat]
    T = max(len(z) for z in nz)
    idx = np.zeros((mat.shape[0], T), np.int32)
    wt = np.zeros((mat.shape[0], T), np.float32)
    for o, z in enumerate(nz):
        idx[o, :len(z)] = z
        wt[o, :len(z)] = mat[o, z]
    return idx, wt


@lru_cache(maxsize=16)
def level_tables(h: int, w: int, levels: int, pyr_scale: float, n: int):
    """Per coarse plan entry (coarsest first): (lh, lw, iv, wv, ih, wh)
    where (iv, wv) map the n-padded level rows to image rows and (ih, wh)
    the n-padded level columns to image columns."""
    out = []
    for (k, lh, lw, sigma, ksize) in farneback_levels(h, w, levels,
                                                      pyr_scale):
        if k == 0:
            continue
        V = _axis_matrix(lh, h, ksize, sigma).astype(np.float32)
        Hm = _axis_matrix(lw, w, ksize, sigma).astype(np.float32)
        V = V[border_index(lh, n, n, "replicate")]
        Hm = Hm[border_index(lw, n, n, "replicate")]
        out.append((lh, lw, *_tap_table(V), *_tap_table(Hm)))
    return tuple(out)


_device_tables: dict = {}


def _tables_on(device, h, w, levels, pyr_scale, n):
    key = (str(device), h, w, levels, float(pyr_scale), n)
    tabs = _device_tables.get(key)
    if tabs is None:
        tabs = [(lh, lw) + tuple(torch.as_tensor(a, device=device)
                                 for a in arrs)
                for (lh, lw, *arrs) in level_tables(h, w, levels,
                                                    float(pyr_scale), n)]
        _device_tables[key] = tabs
    return tabs


def coarse_polyexp_fused_plain(img: torch.Tensor, levels: int,
                               pyr_scale: float, poly_n: int,
                               poly_sigma: float, out_dtype=torch.float32):
    n = poly_n
    outs = []
    for lvl in farneback_images(img, levels, pyr_scale)[:-1]:  # k >= 1
        lvl = pad1d(pad1d(lvl, n, n, 0, "replicate"), n, n, 1, "replicate")
        outs.append(polyexp_valid_plain(lvl, n, poly_sigma).to(out_dtype))
    return outs


def coarse_polyexp_fused(img: torch.Tensor, levels: int, pyr_scale: float,
                         poly_n: int, poly_sigma: float,
                         out_dtype=torch.float32):
    """(H, W) image -> list of (5, lh, lw) planes, coarse levels only."""
    if img.device.type == "cpu":
        return coarse_polyexp_fused_plain(img, levels, pyr_scale, poly_n,
                                          poly_sigma, out_dtype)
    _build.require(img, "img", (torch.float32,), 2)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"coarse_polyexp_fused: out_dtype {out_dtype}")
    h, w = img.shape
    n = poly_n
    taps = poly_taps(n, float(poly_sigma))
    P, I = _build.P, _build.I
    fn = _build.function("kh_level_polyexp", P, I, I, P, P, I, I, P, P, I,
                         I, P, I, I, P, P, P, P)
    outs = []
    for (lh, lw, iv, wv, ih, wh) in _tables_on(img.device, h, w, levels,
                                                pyr_scale, n):
        ho, wo = lh + 2 * n, lw + 2 * n
        tmp = torch.empty((ho, w), dtype=torch.float32, device=img.device)
        lvl = torch.empty((ho, wo), dtype=torch.float32, device=img.device)
        out = torch.empty((5, lh, lw), dtype=out_dtype, device=img.device)
        rc = fn(img.data_ptr(), h, w, iv.data_ptr(), wv.data_ptr(),
                iv.shape[1], ho, ih.data_ptr(), wh.data_ptr(), ih.shape[1],
                wo, taps.ctypes.data, n, int(out_dtype == torch.bfloat16),
                tmp.data_ptr(), lvl.data_ptr(), out.data_ptr(),
                _build.stream(img))
        _build.check(rc, "kh_level_polyexp")
        outs.append(out)
    coarse_polyexp_fused.launches += 1
    return outs


coarse_polyexp_fused.launches = 0
