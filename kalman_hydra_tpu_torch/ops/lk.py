"""Pyramidal Lucas-Kanade flow, sparse and dense (port of
kalman_hydra_tpu/ops/lk.py).

Sparse (cv2.calcOpticalFlowPyrLK): Scharr/32 derivatives of each level of
the previous frame's pyramid (one K9 and one K10 launch on the card,
`lk_pyramid`, cached per frame by the pipeline), then coarsest level
first, one K12 launch for all levels and points: bilinear patches, the
structure tensor and its min-eigenvalue gate, Gauss-Newton steps with
the eps early exit, x2 between levels, the glue between levels in the
kernel. `FlowConfig.lk_block_halo` > 0
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
from ..kernels.lk import lk_sparse_levels
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


def lk_sparse(prev: torch.Tensor, nxt: torch.Tensor, pts: torch.Tensor,
              cfg: FlowConfig, prev_pyr=None, next_pyr=None):
    """Track (K, 2) f32 points from prev to nxt -> (new points (K, 2),
    status (K,) bool): one K12 launch walks every level (kernels/lk.py::
    lk_sparse_levels). Only level 0's gate and an in-bounds test at
    level 0 enter the status. `lk_pyramid` pairs of either frame may be
    passed to skip building them."""
    pyr_a, grads = prev_pyr if prev_pyr is not None else lk_pyramid(prev,
                                                                    cfg)
    pyr_b = (next_pyr[0] if next_pyr is not None
             else build_pyramid(nxt.to(torch.float32).contiguous(),
                                cfg.levels))
    L = cfg.levels
    return lk_sparse_levels(tuple(pyr_a[:L]), tuple(pyr_b[:L]),
                            tuple(grads[:L]), pts, cfg.lk_winsize,
                            cfg.lk_max_iter, cfg.lk_eps, cfg.lk_min_eig,
                            cfg.lk_block_halo)


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
