"""K12 wrappers: sparse pyramidal Lucas-Kanade for K points, every level
of a frame step in one launch (`lk_sparse_levels`, the walk) or one level
(`lk_level`, the one-level launch of the same kernel; it counts in
lk_sparse_levels.launches) (csrc/lk.cu).

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

The walk takes each level's images and Scharr planes (finest first) and
the level-0 points, and does in the kernel what ops/lk.py did between
one-level launches (`level_args`: the point and guess clipped to the
level and moved into its padded frame, the clamp `window`; the answer
moved back out, x2 between levels, level 0's status), MAX_LEVELS levels
a launch: a deeper pyramid takes one walk for each MAX_LEVELS levels,
coarsest first, each handing the next its finest level's guess x2 (the
level loop's own step). Its plain version,
`lk_sparse_levels_plain`, is that per-level loop over `lk_level_plain`
with the torch glue, which `lk_sparse` runs on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

MAX_LEVELS = 8            # levels of one walk (csrc/lk.cu kMaxLevels)


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
    out, ok = _launch_level(img_a, img_b, gx, gy, pt, guess, base, span,
                            pad, win, max_iter, eps, min_eig)
    lk_sparse_levels.launches += K > 0
    return out, ok


def _launch_level(img_a, img_b, gx, gy, pt, guess, base, span, pad, win,
                  max_iter, eps, min_eig):
    """kh_lk_level on checked tensors -> (out (K, 2), ok (K,))."""
    K = pt.shape[0]
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
    return out, ok


def _clamp_xy(p: torch.Tensor, lo, hi_x, hi_y) -> torch.Tensor:
    """(K, 2) (x, y) clamped to [lo, hi_x] x [lo, hi_y] with scalar
    bounds (no bound tensor to upload)."""
    return torch.stack([p[:, 0].clamp(lo, hi_x), p[:, 1].clamp(lo, hi_y)],
                       -1)


def window(h: int, w: int, guess: torch.Tensor, win: int, halo: int):
    """The clamp window of a level's Gauss-Newton steps, (base (K, 2) f32,
    span (sx, sy)), for an (h, w) level padded by half + 2 and the
    level's initial guess in padded coordinates: the whole padded level
    (base 0) at halo 0 or when the level is smaller than the halo'd
    block; otherwise the block around the initial guess, whose top left
    is clip(floor(guess - half) - halo, 0, padded extent - block)."""
    half = (win - 1) * 0.5
    pad = (win - 1) // 2 + 2
    hp, wp = h + 2 * pad, w + 2 * pad
    bb = win + 1 + 2 * halo
    if halo > 0 and min(hp, wp) >= bb:
        base = _clamp_xy(torch.floor(guess - half).to(torch.int64) - halo,
                         0, wp - bb, hp - bb)
        return base.to(torch.float32), (float(2 * halo), float(2 * halo))
    return (torch.zeros_like(guess),
            (wp - 1 - half - 2 - half, hp - 1 - half - 2 - half))


def level_args(img_a, img_b, gx, gy, pts, guess, win: int, max_iter: int,
               eps: float, min_eig: float, halo: int):
    """The arguments of one level's K12 launch (`lk_level`) from the
    level's own coordinates: the points clipped to the level, the guess
    clipped to pad // 2 beyond it, both moved into the padded frame, and
    the clamp `window`."""
    h, w = img_a.shape
    pad = (win - 1) // 2 + 2
    pt_p = _clamp_xy(pts, 0.0, w - 1.0, h - 1.0) + pad
    guess_p = _clamp_xy(guess, -float(pad // 2), w - 1.0 + pad // 2,
                        h - 1.0 + pad // 2) + pad
    base, span = window(h, w, guess_p, win, halo)
    return (img_a, img_b, gx, gy, pt_p, guess_p, base, span, pad, win,
            max_iter, eps, min_eig)


def lk_sparse_levels_plain(pyr_a, pyr_b, grads, pts, win: int,
                           max_iter: int, eps: float, min_eig: float,
                           halo: int, guess=None):
    """The walk's plain version: coarsest level first, one
    `lk_level_plain` call on `level_args`, its answer moved back out of
    the padded frame, x2 between levels; only level 0's gate and an
    in-bounds test there enter the status. Returns (points (K, 2), status (K,) bool)."""
    L = len(pyr_a)
    guess = pts * (1.0 / (2 ** (L - 1))) if guess is None else guess
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    for lvl in range(L - 1, -1, -1):
        gx, gy = grads[lvl]
        args = level_args(pyr_a[lvl], pyr_b[lvl], gx, gy,
                          pts * (1.0 / (2 ** lvl)), guess, win, max_iter,
                          eps, min_eig, halo)
        new, ok = lk_level_plain(*args)
        guess = new - args[8]
        if lvl == 0:
            h, w = pyr_a[0].shape
            inb = ((guess[:, 0] >= 0) & (guess[:, 0] <= w - 1)
                   & (guess[:, 1] >= 0) & (guess[:, 1] <= h - 1))
            status = status & ok & inb
        else:
            guess = guess * 2.0
    return guess, status


def lk_sparse_levels(pyr_a, pyr_b, grads, pts, win: int, max_iter: int,
                     eps: float, min_eig: float, halo: int, guess=None):
    """A frame step of sparse LK over the levels of `pyr_a` (each (h, w)
    f32, finest first), `pyr_b` and the Scharr planes `grads` ((gx, gy)
    per level of pyr_a): (K, 2) level-0 points -> (new points (K, 2),
    status (K,) bool). `guess` is the coarsest level's initial guess
    (default pts / 2^(levels - 1)). `pts` may be a column slice (rows
    any stride apart, columns adjacent), as the filter state's is."""
    if pts.device.type == "cpu":
        return lk_sparse_levels_plain(pyr_a, pyr_b, grads, pts, win,
                                      max_iter, eps, min_eig, halo, guess)
    L = len(pyr_a)
    if L < 1 or len(pyr_b) != L or len(grads) != L:
        raise ValueError(f"lk_sparse_levels: {L} levels of images, "
                         f"{len(pyr_b)} and {len(grads)} of the others "
                         f"(1 or more, equal)")
    f32 = (torch.float32,)
    K = pts.shape[0]
    if (pts.device.type != "cuda" or pts.dtype != torch.float32
            or pts.shape != (K, 2) or pts.stride(1) != 1):
        raise ValueError(f"lk_sparse_levels: pts must be (K, 2) f32 on the "
                         f"card with unit column stride, got "
                         f"{tuple(pts.shape)} {pts.dtype} {pts.device} "
                         f"strides {pts.stride()}")
    if guess is not None:
        _build.require(guess, "guess", f32, 2)
        if guess.shape != (K, 2):
            raise ValueError(f"lk_sparse_levels: guess "
                             f"{tuple(guess.shape)} is not ({K}, 2)")
    for lvl in range(L):
        for name, t in zip(("pyr_a", "pyr_b", "gx", "gy"),
                           (pyr_a[lvl], pyr_b[lvl], *grads[lvl])):
            _build.require(t, f"{name}[{lvl}]", f32, 2)
            if t.shape != pyr_a[lvl].shape:
                raise ValueError(f"lk_sparse_levels: {name}[{lvl}] "
                                 f"{tuple(t.shape)} is not "
                                 f"{tuple(pyr_a[lvl].shape)}")
    return _walks(pyr_a, pyr_b, grads, pts, win, max_iter, eps, min_eig,
                  halo, guess)


def _walks(pyr_a, pyr_b, grads, pts, win, max_iter, eps, min_eig, halo,
           guess):
    """One `_launch_walk` for each MAX_LEVELS levels, coarsest first: walk
    [l0, l0 + MAX_LEVELS) tracks pts / 2^l0 as its level-0 points (a
    power of two: exact), and its finest level's answer x2 seeds the next
    walk's coarsest level, as the level loop carries it."""
    L, K = len(pyr_a), pts.shape[0]
    starts = list(range(0, L, MAX_LEVELS))[::-1]
    if len(starts) > 1 and guess is None:
        guess = pts * (1.0 / (2 ** (L - 1)))
    for l0 in starts:
        if l0 < starts[0]:
            guess = out * 2.0
        sl = slice(l0, l0 + MAX_LEVELS)
        out, status = _launch_walk(pyr_a[sl], pyr_b[sl], grads[sl],
                                   pts if l0 == 0 else pts * (1.0 / 2 ** l0),
                                   win, max_iter, eps, min_eig, halo, guess)
        lk_sparse_levels.launches += K > 0
    return out, status


def _launch_walk(pyr_a, pyr_b, grads, pts, win, max_iter, eps, min_eig,
                 halo, guess):
    """kh_lk_levels on checked tensors -> (out (K, 2), status (K,))."""
    K = pts.shape[0]
    out = torch.empty((K, 2), dtype=torch.float32, device=pts.device)
    status = torch.empty(K, dtype=torch.bool, device=pts.device)
    if K == 0:
        return out, status
    ptrs = np.ascontiguousarray(
        [[t.data_ptr() for t in (a, b, *g)]
         for a, b, g in zip(pyr_a, pyr_b, grads)], dtype=np.uint64)
    dims = np.ascontiguousarray([a.shape for a in pyr_a], dtype=np.int32)
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.function("kh_lk_levels", P, P, I, P, I, P, I, I, I, F, F,
                         I, P, P, P)
    rc = fn(ptrs.ctypes.data, dims.ctypes.data, len(pyr_a), pts.data_ptr(),
            pts.stride(0), None if guess is None else guess.data_ptr(), K,
            win, max_iter,
            float(np.float32(eps * eps)), float(min_eig), halo,
            out.data_ptr(), status.data_ptr(), _build.stream(pts))
    _build.check(rc, "kh_lk_levels")
    return out, status


lk_sparse_levels.launches = 0
