"""Pyramidal Lucas-Kanade flow, sparse and dense (port of
kalman_hydra_tpu/ops/lk.py).

Sparse (cv2.calcOpticalFlowPyrLK): Scharr/32 derivatives of each level of
the previous frame's pyramid (one K9 and one K10 launch on the card,
`lk_pyramid`, cached per frame by the pipeline), then coarsest level
first one K12 launch per level for all points: bilinear patches, the
structure tensor and its min-eigenvalue gate, Gauss-Newton steps with
the eps early exit, x2 between levels. `FlowConfig.lk_block_halo` > 0
clamps each level's moving guess to a halo'd block around its initial
guess (the reference's batched solvers); `lk_solver` and
`lk_blocked_gather` choose TPU layouts of that same computation and are
ignored here, as `impl` is.

Dense: the same normal equations with the window as unnormalised box
sums over the whole image (per-pixel G and b), re-solved for the total
flow `lk_max_iter` times per level with a backward warp of the next
frame (the fast select-sum warp at fast_warp > 0), coarse to fine; plain
torch around K9 (one launch per frame's pyramid) and K10 (one launch for
the previous frame's levels), as the reference's is XLA around its ops.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import FlowConfig
from ..kernels.lk import lk_level
from ..kernels.scharr import scharr_gradients_levels
from ..kernels.scharr import scharr_gradients  # noqa: F401  (ops.lk's API,
#                                                 as in the reference)
from .filters import box_filter
from .pyramid import build_pyramid, resize_linear
from .warp import warp_image, warp_selectsum


def lk_pyramid(img: torch.Tensor, cfg: FlowConfig) -> Tuple[tuple, tuple]:
    """(pyr, grads) of one frame: `levels` pyrDown images (one K9
    launch) and the Scharr planes (gx, gy) of each (one K10 launch). The
    pipeline carries the previous frame's pair, so each frame's pyramid
    is built once."""
    pyr = build_pyramid(img.to(torch.float32).contiguous(), cfg.levels)
    return tuple(pyr), scharr_gradients_levels(pyr)


def _clamp_xy(p: torch.Tensor, lo, hi_x, hi_y) -> torch.Tensor:
    """(K, 2) (x, y) clamped to [lo, hi_x] x [lo, hi_y] with scalar
    bounds (no bound tensor to upload)."""
    return torch.stack([p[:, 0].clamp(lo, hi_x), p[:, 1].clamp(lo, hi_y)],
                       -1)


def lk_window(h: int, w: int, guess: torch.Tensor, cfg: FlowConfig):
    """The clamp window of a level's Gauss-Newton steps, (base (K, 2) f32,
    span (sx, sy)), for an (h, w) level padded by half + 2 and the
    level's initial guess in padded coordinates: the whole padded level
    (base 0) at lk_block_halo = 0 or when the level is smaller than the
    halo'd block; otherwise the block around the initial guess, whose top
    left is clip(floor(guess - half) - halo, 0, padded extent - block)."""
    win = cfg.lk_winsize
    half = (win - 1) * 0.5
    pad = (win - 1) // 2 + 2
    hp, wp = h + 2 * pad, w + 2 * pad
    D = cfg.lk_block_halo
    bb = win + 1 + 2 * D
    if D > 0 and min(hp, wp) >= bb:
        base = _clamp_xy(torch.floor(guess - half).to(torch.int64) - D, 0,
                         wp - bb, hp - bb)
        return base.to(torch.float32), (float(2 * D), float(2 * D))
    return (torch.zeros_like(guess),
            (wp - 1 - half - 2 - half, hp - 1 - half - 2 - half))


def lk_level_args(img_a, img_b, gx, gy, pts, guess, cfg: FlowConfig):
    """The arguments of one level's K12 launch (kernels/lk.py::lk_level)
    from the level's own coordinates: the points clipped to the level,
    the guess clipped to pad // 2 beyond it, both moved into the padded
    frame, and the clamp window of `lk_window`."""
    h, w = img_a.shape
    pad = (cfg.lk_winsize - 1) // 2 + 2
    pt_p = _clamp_xy(pts, 0.0, w - 1.0, h - 1.0) + pad
    guess_p = _clamp_xy(guess, -float(pad // 2), w - 1.0 + pad // 2,
                        h - 1.0 + pad // 2) + pad
    base, span = lk_window(h, w, guess_p, cfg)
    return (img_a, img_b, gx, gy, pt_p, guess_p, base, span, pad,
            cfg.lk_winsize, cfg.lk_max_iter, cfg.lk_eps, cfg.lk_min_eig)


def lk_sparse_level(img_a, img_b, gx, gy, pts, guess, cfg: FlowConfig):
    """One level of lk_sparse in the level's own coordinates: one K12
    launch on `lk_level_args`, its answer moved back out of the padded
    frame. Returns (guess, ok)."""
    args = lk_level_args(img_a, img_b, gx, gy, pts, guess, cfg)
    new, ok = lk_level(*args)
    return new - args[8], ok


def lk_sparse(prev: torch.Tensor, nxt: torch.Tensor, pts: torch.Tensor,
              cfg: FlowConfig, prev_pyr=None, next_pyr=None):
    """Track (K, 2) f32 points from prev to nxt -> (new points (K, 2),
    status (K,) bool). Only level 0's gate and an in-bounds test at level
    0 enter the status. `lk_pyramid` pairs of either frame may be passed
    to skip building them."""
    pyr_a, grads = prev_pyr if prev_pyr is not None else lk_pyramid(prev,
                                                                    cfg)
    pyr_b = (next_pyr[0] if next_pyr is not None
             else build_pyramid(nxt.to(torch.float32).contiguous(),
                                cfg.levels))
    guess = pts * (1.0 / (2 ** (cfg.levels - 1)))
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    for lvl in range(cfg.levels - 1, -1, -1):
        gx, gy = grads[lvl]
        guess, ok = lk_sparse_level(pyr_a[lvl], pyr_b[lvl], gx, gy,
                                    pts * (1.0 / (2 ** lvl)), guess, cfg)
        if lvl == 0:
            h, w = pyr_a[0].shape
            inb = ((guess[:, 0] >= 0) & (guess[:, 0] <= w - 1)
                   & (guess[:, 1] >= 0) & (guess[:, 1] <= h - 1))
            status = status & ok & inb
        else:
            guess = guess * 2.0
    return guess, status


def lk_dense(prev: torch.Tensor, nxt: torch.Tensor,
             cfg: FlowConfig) -> torch.Tensor:
    """Dense pyramidal LK flow, (H, W, 2) f32 (x, y displacement)."""
    pyr_a = build_pyramid(prev.to(torch.float32).contiguous(), cfg.levels)
    pyr_b = build_pyramid(nxt.to(torch.float32).contiguous(), cfg.levels)
    grads = scharr_gradients_levels(pyr_a)
    w = cfg.lk_winsize

    def wsum(v):
        return box_filter(box_filter(v, w, dim=-2, border="replicate",
                                     normalize=False),
                          w, dim=-1, border="replicate", normalize=False)

    flow = None
    for lvl in range(cfg.levels - 1, -1, -1):
        ia, ib = pyr_a[lvl], pyr_b[lvl]
        h_l, w_l = ia.shape
        if flow is None:
            flow = torch.zeros((h_l, w_l, 2), dtype=torch.float32,
                               device=ia.device)
        else:
            flow = resize_linear(flow.movedim(-1, 0), h_l,
                                 w_l).movedim(0, -1) * 2.0
        gx, gy = grads[lvl]
        gxx, gxy, gyy = gx * gx, gx * gy, gy * gy
        g11, g12, g22 = wsum(gxx), wsum(gxy), wsum(gyy)
        det = g11 * g22 - g12 * g12
        min_eig = ((g11 + g22) - torch.sqrt((g11 - g22) ** 2
                                            + 4.0 * g12 ** 2)) \
            * 0.5 / (w * w)
        ok = (min_eig > cfg.lk_min_eig) & (det > 1e-12)
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        for _ in range(cfg.lk_max_iter):
            # the absolute re-solve of the reference: the window's normal
            # equations G u_new = sum(grad grad^T u_old - dI grad)
            ux, uy = flow[..., 0], flow[..., 1]
            if cfg.fast_warp > 0:
                warped = warp_selectsum(ib[None], ux, uy, cfg.fast_warp)[0]
            else:
                warped = warp_image(ib, flow)
            diff = warped - ia
            h1 = wsum(gxx * ux + gxy * uy - diff * gx)
            h2 = wsum(gxy * ux + gyy * uy - diff * gy)
            new = torch.stack([(g22 * h1 - g12 * h2) * inv_det,
                               (g11 * h2 - g12 * h1) * inv_det], dim=-1)
            flow = torch.where(ok[..., None], new, flow)
    return flow
