"""K4 and K7b wrappers: coarse Farneback level images + polyexp of one
frame or of a frame stack; K11: the level images alone
(csrc/level_image.cu).

K4 replaces kalman_hydra_tpu/kernels/level_image_pallas.py::
coarse_polyexp_fused. For every coarse plan entry (k >= 1, coarsest
first) the level image is GaussianBlur(original, reflect101) composed
with the INTER_LINEAR resize, replicate-padded by n, and expanded into 5
polyexp planes. Returns a list of (5, lh, lw) arrays; level 0 is the
caller's business. K7b replaces ::coarse_polyexp_fused_batch: (N, H, W)
-> list of (N, 5, lh, lw), the same kernels with a frame index and one
set of tap tables for all frames, so it equals per-frame K4 bit for bit.

The composed weights are the reference's band matrices (_band_mats,
_band_mats_padded) stored sparsely: per output row (or column) the source
indices and float32 weights of its non-zeros. CPU tensors take
`coarse_polyexp_fused_plain` (any leading dims, so it is K7b's plain
version too), which builds the level images stage by stage
(ops.pyramid.farneback_images: full-res blur, then resize) — an
independent route to the same values. CUDA tensors launch the kernel per
level, or raise.

K11 (`coarse_level_images`) replaces ::farneback_images_pallas: the same
level images at padding 0 (the reference's unpadded _band_mats), with no
polyexp, each (lh, lw) f32, coarse levels only (level 0, the 3-tap blur,
stays plain torch as the reference leaves it to XLA). Its plain version
is `coarse_level_images_plain`, the coarse entries of
ops.pyramid.farneback_images.
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
        lvl = pad1d(pad1d(lvl, n, n, -2, "replicate"), n, n, -1,
                    "replicate")
        outs.append(polyexp_valid_plain(lvl, n, poly_sigma).to(out_dtype))
    return outs


def _launch(imgs: torch.Tensor, levels: int, pyr_scale: float, n: int,
            poly_sigma: float, out_dtype):
    """kh_level_polyexp per coarse level over a (N, H, W) f32 stack ->
    list of (N, 5, lh, lw)."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"coarse_polyexp_fused: out_dtype {out_dtype}")
    N, h, w = imgs.shape
    dev = imgs.device
    taps = poly_taps(n, float(poly_sigma))
    P, I = _build.P, _build.I
    fn = _build.function("kh_level_polyexp", P, I, I, I, P, P, I, I, P, P,
                         I, I, P, I, I, P, P, P, P)
    outs = []
    for (lh, lw, iv, wv, ih, wh) in _tables_on(dev, h, w, levels,
                                                pyr_scale, n):
        ho, wo = lh + 2 * n, lw + 2 * n
        tmp = torch.empty((N, ho, w), dtype=torch.float32, device=dev)
        lvl = torch.empty((N, ho, wo), dtype=torch.float32, device=dev)
        out = torch.empty((N, 5, lh, lw), dtype=out_dtype, device=dev)
        rc = fn(imgs.data_ptr(), N, h, w, iv.data_ptr(), wv.data_ptr(),
                iv.shape[1], ho, ih.data_ptr(), wh.data_ptr(), ih.shape[1],
                wo, taps.ctypes.data, n, int(out_dtype == torch.bfloat16),
                tmp.data_ptr(), lvl.data_ptr(), out.data_ptr(),
                _build.stream(imgs))
        _build.check(rc, "kh_level_polyexp")
        outs.append(out)
    return outs


def coarse_polyexp_fused(img: torch.Tensor, levels: int, pyr_scale: float,
                         poly_n: int, poly_sigma: float,
                         out_dtype=torch.float32):
    """(H, W) image -> list of (5, lh, lw) planes, coarse levels only."""
    if img.device.type == "cpu":
        return coarse_polyexp_fused_plain(img, levels, pyr_scale, poly_n,
                                          poly_sigma, out_dtype)
    _build.require(img, "img", (torch.float32,), 2)
    outs = [o[0] for o in _launch(img[None], levels, pyr_scale, poly_n,
                                  poly_sigma, out_dtype)]
    coarse_polyexp_fused.launches += 1
    return outs


coarse_polyexp_fused.launches = 0


def coarse_polyexp_fused_batch(imgs: torch.Tensor, levels: int,
                               pyr_scale: float, poly_n: int,
                               poly_sigma: float, out_dtype=torch.float32):
    """(N, H, W) frames -> list of (N, 5, lh, lw) planes, coarse levels
    only, one launch group for all frames."""
    if imgs.device.type == "cpu":
        return coarse_polyexp_fused_plain(imgs, levels, pyr_scale, poly_n,
                                          poly_sigma, out_dtype)
    _build.require(imgs, "imgs", (torch.float32,), 3)
    outs = _launch(imgs, levels, pyr_scale, poly_n, poly_sigma, out_dtype)
    coarse_polyexp_fused_batch.launches += 1
    return outs


coarse_polyexp_fused_batch.launches = 0


def coarse_level_images_plain(img: torch.Tensor, levels: int,
                              pyr_scale: float):
    return farneback_images(img, levels, pyr_scale)[:-1]      # k >= 1


def coarse_level_images(img: torch.Tensor, levels: int, pyr_scale: float):
    """(H, W) image -> list of (lh, lw) f32 level images, coarse levels
    only, coarsest first."""
    if img.device.type == "cpu":
        return coarse_level_images_plain(img, levels, pyr_scale)
    _build.require(img, "img", (torch.float32,), 2)
    h, w = img.shape
    P, I = _build.P, _build.I
    fn = _build.function("kh_level_images", P, I, I, P, P, I, I, P, P, I, I,
                         P, P, P)
    outs = []
    for (lh, lw, iv, wv, ih, wh) in _tables_on(img.device, h, w, levels,
                                                pyr_scale, 0):
        tmp = torch.empty((lh, w), dtype=torch.float32, device=img.device)
        out = torch.empty((lh, lw), dtype=torch.float32, device=img.device)
        rc = fn(img.data_ptr(), h, w, iv.data_ptr(), wv.data_ptr(),
                iv.shape[1], lh, ih.data_ptr(), wh.data_ptr(), ih.shape[1],
                lw, tmp.data_ptr(), out.data_ptr(), _build.stream(img))
        _build.check(rc, "kh_level_images")
        outs.append(out)
    coarse_level_images.launches += 1
    return outs


coarse_level_images.launches = 0
