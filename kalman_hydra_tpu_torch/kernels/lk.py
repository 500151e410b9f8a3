"""K12 wrapper: one pyramid level of sparse pyramidal Lucas-Kanade for K
points (csrc/lk.cu).

Replaces kalman_hydra_tpu/kernels/lk_pallas.py::lk_sparse (`_lk_level`),
the per-point kernel of ops/lk.py::_track_point_level in the reference,
and covers its batched block-halo solvers too: those differ from the
exact path only in the window that clamps the moving guess, which here
is an argument. Inputs are the level's images img_a, img_b and the
Scharr planes gx, gy of img_a, each (h, w) f32, implicitly
replicate-padded by `pad`; pt and guess (K, 2) f32 in padded
coordinates; the window: base (K, 2) f32 (integral) and span (sx, sy),
the patch's top-left offset clip(guess - half - base, 0, span). Returns
(new guess (K, 2) in padded coordinates, ok (K,) bool): ok is the
structure tensor's gate, and a point that fails it does not move.

CPU tensors take `lk_level_plain` (_track_point_level line by line,
batched over K); CUDA tensors launch the kernel, or raise. Both sum the
windows in float64 (see csrc/lk.cu): summation-order noise in f32 sums
would otherwise decide the eps early exit of a point now and then.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build


def _patches(img, by, bx, fx, fy, win: int, pad: int) -> torch.Tensor:
    """(K, win, win) bilinear patches of `img` replicate-padded by `pad`
    whose (win + 1)^2 blocks start at padded (by, bx), at fractions
    (fx, fy); the reference's product order."""
    h, w = img.shape
    r = torch.arange(win + 1, device=img.device)
    rows = torch.clamp(by[:, None] + r - pad, 0, h - 1)
    cols = torch.clamp(bx[:, None] + r - pad, 0, w - 1)
    blk = img[rows[:, :, None], cols[:, None, :]]
    fx, fy = fx[:, None, None], fy[:, None, None]
    return (blk[:, :win, :win] * (1 - fx) * (1 - fy)
            + blk[:, :win, 1:] * fx * (1 - fy)
            + blk[:, 1:, :win] * (1 - fx) * fy
            + blk[:, 1:, 1:] * fx * fy)


def _wsum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=(1, 2), dtype=torch.float64).to(torch.float32)


def lk_level_plain(img_a, img_b, gx, gy, pt, guess, base, span, pad: int,
                   win: int, max_iter: int, eps: float, min_eig: float,
                   with_iters: bool = False):
    """`with_iters` also returns the Gauss-Newton steps each point took."""
    half = (win - 1) * 0.5
    t = pt - half
    t0 = torch.floor(t)
    f = t - t0
    ti = t0.to(torch.int64)
    pa, pgx, pgy = (_patches(im, ti[:, 1], ti[:, 0], f[:, 0], f[:, 1], win,
                             pad) for im in (img_a, gx, gy))
    g11, g12, g22 = _wsum(pgx * pgx), _wsum(pgx * pgy), _wsum(pgy * pgy)
    eig = ((g11 + g22) - torch.sqrt((g11 - g22) ** 2 + 4.0 * g12 ** 2)) \
        * 0.5 / (win * win)
    det = g11 * g22 - g12 * g12
    ok = (eig > min_eig) & (det > 1e-12)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    eps2 = float(np.float32(eps * eps))
    span_t = torch.tensor(span, dtype=torch.float32, device=pt.device)
    g, active = guess.clone(), ok.clone()
    iters = torch.zeros(pt.shape[0], dtype=torch.int32, device=pt.device)
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        o = torch.minimum(torch.clamp(g - half - base, min=0.0), span_t)
        o0 = torch.floor(o)
        fb = o - o0
        s = (base + o0).to(torch.int64)
        diff = _patches(img_b, s[:, 1], s[:, 0], fb[:, 0], fb[:, 1], win,
                        pad) - pa
        b1, b2 = _wsum(diff * pgx), _wsum(diff * pgy)
        dx = -(g22 * b1 - g12 * b2) * inv_det
        dy = -(g11 * b2 - g12 * b1) * inv_det
        g = torch.where(active[:, None], g + torch.stack([dx, dy], -1), g)
        iters += active.to(torch.int32)
        active = active & (dx * dx + dy * dy > eps2)
    return (g, ok, iters) if with_iters else (g, ok)


def lk_level(img_a, img_b, gx, gy, pt, guess, base, span, pad: int,
             win: int, max_iter: int, eps: float, min_eig: float):
    if img_a.device.type == "cpu":
        return lk_level_plain(img_a, img_b, gx, gy, pt, guess, base, span,
                              pad, win, max_iter, eps, min_eig)
    f32 = (torch.float32,)
    for name, t in (("img_a", img_a), ("img_b", img_b), ("gx", gx),
                    ("gy", gy)):
        _build.require(t, name, f32, 2)
        if t.shape != img_a.shape:
            raise ValueError(f"lk_level: {name} {tuple(t.shape)} is not "
                             f"{tuple(img_a.shape)}")
    K = pt.shape[0]
    for name, t in (("pt", pt), ("guess", guess), ("base", base)):
        _build.require(t, name, f32, 2)
        if t.shape != (K, 2):
            raise ValueError(f"lk_level: {name} {tuple(t.shape)} is not "
                             f"({K}, 2)")
    out = torch.empty((K, 2), dtype=torch.float32, device=pt.device)
    ok = torch.empty(K, dtype=torch.bool, device=pt.device)
    if K == 0:
        return out, ok
    h, w = img_a.shape
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.function("kh_lk_level", P, P, P, P, I, I, I, P, P, P, F, F,
                         I, I, I, F, F, P, P, P)
    rc = fn(img_a.data_ptr(), img_b.data_ptr(), gx.data_ptr(),
            gy.data_ptr(), h, w, pad, pt.data_ptr(), guess.data_ptr(),
            base.data_ptr(), float(span[0]), float(span[1]), K, win,
            max_iter, float(np.float32(eps * eps)), float(min_eig),
            out.data_ptr(), ok.data_ptr(), _build.stream(pt))
    _build.check(rc, "kh_lk_level")
    lk_level.launches += 1
    return out, ok


lk_level.launches = 0
