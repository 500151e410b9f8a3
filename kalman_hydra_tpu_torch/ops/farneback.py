"""Dense Farneback optical flow from polyexp pyramids (port of the
impl="pallas" branches of kalman_hydra_tpu/ops/farneback.py).

Per frame: `polyexp_pyramid` expands every level: with `pe_fused` (the
default) the coarse levels through K4 and the full-res level through K3
after its 3-tap blur; with `pe_fused=False` the coarse level images
through K11, then K3 on every level. Per frame pair:
`farneback_from_pyramids` runs each level coarsest first, upsampling the
flow by 1/pyr_scale between levels, from zeros or from a warm start
`flow0` at the coarsest level. At `fast_warp=0` (the reference's
`RunConfig()` default) every iteration is one K8 launch, the exact
bilinear gather of the unwarped planes included (the reference gathers
in XLA, `_warp_poly_planar`, then runs its Pallas kernel; the plain
gather is `ops.warp.warp_poly_planar`). At `fast_warp > 0`, with
`fi_level_fused`, the run of levels that pass K5's gate
(`kernels.flow_level.fits`; every level fails it at a window no walk tile
holds, `walk_fits`) runs in one K5 launch for every MAX_LEVELS of
them, every iteration of each and the resizes between them (the
reference runs one Pallas call a level, the resize in XLA between them);
every other level runs all its iterations in one K13 launch with
`fi_pipeline` (and iterations >= 2), else `iterations` K2 launches (the
reference's order, kalman_hydra_tpu/ops/farneback.py:466-499).

The pair-batched twins serve a whole clip, or several chained clips, at
once: `polyexp_pyramid_batch` expands every frame in one K7b and one K7a
launch (per frame at `pe_fused=False`), and
`farneback_pairs_from_pyramids` runs each iteration of a level as one K6
launch over all frame pairs at fast_warp > 0; at fast_warp = 0 as one
K8-pairs launch, the gather included (the reference vmaps plain XLA
there; it has no K5 or K13 branch on the pair path either). The whole
stack stays on the card; the TPU's chunks of at most 33 frames (a VMEM
limit) are not ported. Flow is carried planar, (2, lh, lw); the public
result is (H, W, 2).

The reference's single-level ops keep their names, signatures and
layouts: `poly_expansion` (H, W, 5) and `poly_expansion_p` (5, H, W)
through K3's routes; `update_matrices(_p)` and `update_flow(_p)`, which
the reference computes in XLA, in plain torch on either device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import FlowConfig
from ..kernels.flow_iter import (border_damp, flow_iter, flow_iter_pairs,
                                 flow_iters_pipelined, normal_matrices,
                                 pair_count)
from ..kernels.flow_level import fits, flow_levels, walk_fits
from ..kernels.flow_update import flow_update, flow_update_pairs
from ..kernels.level_image import (coarse_level_images, coarse_polyexp_fused,
                                   coarse_polyexp_fused_batch)
from ..kernels.polyexp import (poly_expansion_planar,
                               poly_expansion_planar_batch)
from .filters import box_filter, correlate1d, gaussian_kernel
from .pyramid import gaussian_blur_level, resize_linear
from .warp import warp_poly_planar, warp_selectsum


def poly_expansion_p(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Quadratic-fit coefficient planes of an (H, W) image, (5, H, W)
    f32 [b_x, b_y, a_xx, a_yy, axy] (axy the full xy coefficient): K3
    (a stack (N, H, W) -> (N, 5, H, W) through K7a)."""
    img = img.to(torch.float32).contiguous()
    if img.ndim == 2:
        return poly_expansion_planar(img, n, sigma)
    flat = img.reshape(-1, *img.shape[-2:])
    return poly_expansion_planar_batch(flat, n, sigma).reshape(
        *img.shape[:-2], 5, *img.shape[-2:])


def poly_expansion(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """poly_expansion_p with the planes last: (H, W) -> (H, W, 5)."""
    return poly_expansion_p(img, n, sigma).movedim(-3, -1)


def update_matrices_p(R0p: torch.Tensor, R1p: torch.Tensor,
                      flow_p: torch.Tensor, fast_warp: int = 0
                      ) -> torch.Tensor:
    """The per-pixel normal equations M (5, H, W) = (G11, G12, G22, h1,
    h2) of two frames' (5, H, W) planes and a (2, H, W) flow: R1 warped
    by the flow (exact bilinear gather, or at fast_warp > 0 the
    select-sum warp clamped to +-fast_warp, its flow and fractions in
    the planes' type), then the border-damped products in f32, stored in
    the planes' type. Plain torch on either device, as the reference
    computes it in XLA (K2 and K8 fuse it with the window and solve)."""
    h, w = R0p.shape[-2:]
    if fast_warp > 0:
        fl = flow_p.to(R1p.dtype).to(torch.float32)
        R1w = warp_selectsum(R1p.to(torch.float32), fl[0], fl[1], fast_warp,
                             frac_dtype=R1p.dtype)
    else:
        R1w = warp_poly_planar(R1p, flow_p)
    M = normal_matrices(R0p.to(torch.float32), R1w.to(torch.float32),
                        flow_p, border_damp(h, w, R0p.device))
    return M.to(R1p.dtype)


def update_matrices(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                    fast_warp: int = 0) -> torch.Tensor:
    """update_matrices_p with the planes last: (H, W, 5) x 2 and an
    (H, W, 2) flow -> M (H, W, 5)."""
    return update_matrices_p(R0.movedim(-1, 0), R1.movedim(-1, 0),
                             flow.movedim(-1, 0), fast_warp).movedim(0, -1)


def update_flow_p(Mp: torch.Tensor, winsize: int,
                  gaussian: bool) -> torch.Tensor:
    """M (5, H, W) smoothed over the winsize window (the cv2 Gaussian of
    sigma (winsize // 2) 0.3, or a box), replicate border, then the 2x2
    solve per pixel -> flow (2, H, W) f32. Plain torch on either device,
    as the reference computes it in XLA."""
    if gaussian:
        m = winsize // 2
        kern = gaussian_kernel(2 * m + 1, m * 0.3)
        Ms = correlate1d(correlate1d(Mp, kern, -2, border="replicate"),
                         kern, -1, border="replicate")
    else:
        Ms = box_filter(box_filter(Mp, winsize, -2, border="replicate"),
                        winsize, -1, border="replicate")
    g11, g12, g22, h1, h2 = Ms.to(torch.float32).unbind(-3)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g22 * h1 - g12 * h2) * idet,
                        (g11 * h2 - g12 * h1) * idet], dim=-3)


def update_flow(M: torch.Tensor, winsize: int, gaussian: bool) -> torch.Tensor:
    """update_flow_p with the planes last: M (H, W, 5) -> flow (H, W, 2)."""
    return update_flow_p(M.movedim(-1, -3), winsize, gaussian).movedim(-3, -1)


def _plane_dtype(cfg: FlowConfig):
    return torch.bfloat16 if cfg.bf16_poly else torch.float32


def polyexp_pyramid(img: torch.Tensor, cfg: FlowConfig,
                    fine: bool = True) -> Tuple[torch.Tensor, ...]:
    """(H, W) f32 frame -> per-level (5, lh, lw) planes, coarsest first,
    in bf16 when cfg.bf16_poly; with fine=False the coarse levels alone
    (parallel/spatial.py expands the full-res level by row bands)."""
    dt = _plane_dtype(cfg)
    n, s = cfg.poly_n, cfg.poly_sigma
    fine_img = [gaussian_blur_level(img, cfg, k=0)] if fine else []
    if not cfg.pe_fused:
        imgs = coarse_level_images(img, cfg.levels, cfg.pyr_scale) + fine_img
        return tuple(poly_expansion_planar(i, n, s, out_dtype=dt)
                     for i in imgs)
    coarse = coarse_polyexp_fused(img, cfg.levels, cfg.pyr_scale, n, s,
                                  out_dtype=dt)
    return tuple(coarse) + tuple(poly_expansion_planar(i, n, s, out_dtype=dt)
                                 for i in fine_img)


def farneback_from_pyramids(Rs_a, Rs_b, cfg: FlowConfig,
                            flow0: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Flow prev -> next, (H, W, 2) f32, from two polyexp pyramids.
    `flow0` (H, W, 2) seeds the coarsest level, resized and scaled by
    pyr_scale ** (levels in the plan - 1) (cv2 OPTFLOW_USE_INITIAL_FLOW)."""
    flow_p = None
    n, i = len(Rs_a), 0
    while i < n:
        R0, R1 = Rs_a[i], Rs_b[i]
        lh, lw = R0.shape[1], R0.shape[2]
        if flow_p is not None:
            flow_p = resize_linear(flow_p, lh, lw) * (1.0 / cfg.pyr_scale)
        elif flow0 is not None:
            flow_p = (resize_linear(flow0.movedim(-1, 0), lh, lw)
                      * (cfg.pyr_scale ** (n - 1)))
        else:
            flow_p = torch.zeros((2, lh, lw), dtype=torch.float32,
                                 device=R0.device)
        isz = R0.element_size()
        if cfg.fast_warp > 0 and cfg.fi_level_fused and \
                walk_fits(cfg.winsize) and fits(lh, lw, isz):
            # this level and every next one under the gate: one walk a
            # MAX_LEVELS of them
            j = i + 1
            while j < n and fits(Rs_a[j].shape[1], Rs_a[j].shape[2], isz):
                j += 1
            flow_p = flow_levels(Rs_a[i:j], Rs_b[i:j], flow_p, cfg.winsize,
                                 cfg.fast_warp, cfg.iterations,
                                 cfg.gaussian_win, cfg.pyr_scale)
            i = j
            continue
        if cfg.fast_warp <= 0:
            for _ in range(cfg.iterations):
                flow_p = flow_update(R0, R1, flow_p, cfg.winsize,
                                     cfg.gaussian_win)
        elif cfg.fi_pipeline and cfg.iterations >= 2:
            flow_p = flow_iters_pipelined(R0, R1, flow_p, cfg.winsize,
                                          cfg.fast_warp, cfg.iterations,
                                          cfg.gaussian_win)
        else:
            for _ in range(cfg.iterations):
                flow_p = flow_iter(R0, R1, flow_p, cfg.winsize,
                                   cfg.fast_warp, cfg.gaussian_win)
        i += 1
    return flow_p.movedim(0, -1)


def farneback(prev: torch.Tensor, nxt: torch.Tensor, cfg: FlowConfig,
              flow0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense flow prev -> next of two (H, W) f32 gray frames, (H, W, 2)
    f32, channel 0 = x."""
    return farneback_from_pyramids(polyexp_pyramid(prev, cfg),
                                   polyexp_pyramid(nxt, cfg), cfg, flow0)


def polyexp_pyramid_batch(grays: torch.Tensor,
                          cfg: FlowConfig) -> Tuple[torch.Tensor, ...]:
    """(N, H, W) f32 frames -> per-level (N, 5, lh, lw) planes, coarsest
    first; per frame the same values as `polyexp_pyramid`, which it runs
    frame by frame at pe_fused=False (as the reference does)."""
    if not cfg.pe_fused:
        pyrs = [polyexp_pyramid(g, cfg) for g in grays]
        return tuple(torch.stack(lv) for lv in zip(*pyrs))
    dt = _plane_dtype(cfg)
    coarse = coarse_polyexp_fused_batch(grays, cfg.levels, cfg.pyr_scale,
                                        cfg.poly_n, cfg.poly_sigma,
                                        out_dtype=dt)
    img0 = gaussian_blur_level(grays, cfg, k=0)
    return tuple(coarse) + (poly_expansion_planar_batch(
        img0, cfg.poly_n, cfg.poly_sigma, out_dtype=dt),)


def farneback_pairs_from_pyramids(Rs_all, cfg: FlowConfig,
                                  clip_len: int = 0) -> torch.Tensor:
    """Cold flow for every frame pair of batched pyramids -> (B, H, W, 2).

    Rs_all: per level (N, 5, lh, lw). Pair b reads frames p and p + 1,
    p = b, or p = b + b // (clip_len - 1) when clip_len = T chains clips
    of T frames (N = C T, B = C (T - 1)). At fast_warp > 0 per pair the
    same values as `farneback_from_pyramids` at fi_level_fused=False and
    fi_pipeline=False (the reference's pair path has no whole-level or
    pipelined kernel). At fast_warp = 0 each iteration is one K8-pairs
    launch (the exact gather in the kernel), M rounded to bf16 with bf16
    planes as the reference's update_matrices_p stores it."""
    B = pair_count(Rs_all[0].shape[0], clip_len)
    flow_b = None
    for Rl in Rs_all:
        lh, lw = Rl.shape[2], Rl.shape[3]
        if flow_b is None:
            flow_b = torch.zeros((B, 2, lh, lw), dtype=torch.float32,
                                 device=Rl.device)
        else:
            flow_b = resize_linear(flow_b, lh, lw) * (1.0 / cfg.pyr_scale)
        if cfg.fast_warp <= 0:
            for _ in range(cfg.iterations):
                flow_b = flow_update_pairs(Rl, flow_b, cfg.winsize,
                                           cfg.gaussian_win, clip_len,
                                           round_m=Rl.dtype == torch.bfloat16)
            continue
        for _ in range(cfg.iterations):
            flow_b = flow_iter_pairs(Rl, flow_b, cfg.winsize, cfg.fast_warp,
                                     cfg.gaussian_win, clip_len)
    return flow_b.movedim(1, -1)
