"""Dense Farneback optical flow from polyexp pyramids (port of the
impl="pallas", fast_warp > 0 branches of kalman_hydra_tpu/ops/farneback.py).

Per frame: `polyexp_pyramid` expands every level (coarse levels through
K4, the full-res level through K3 after its 3-tap blur); per frame pair:
`farneback_from_pyramids` runs `iterations` K2 iterations per level,
coarsest first, upsampling the flow by 1/pyr_scale between levels. Flow
is carried planar, (2, lh, lw); the public result is (H, W, 2).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import FlowConfig
from ..kernels.flow_iter import flow_iter
from ..kernels.level_image import coarse_polyexp_fused
from ..kernels.polyexp import poly_expansion_planar
from .pyramid import gaussian_blur_level, resize_linear


def polyexp_pyramid(img: torch.Tensor,
                    cfg: FlowConfig) -> Tuple[torch.Tensor, ...]:
    """(H, W) f32 frame -> per-level (5, lh, lw) planes, coarsest first,
    in bf16 when cfg.bf16_poly."""
    dt = torch.bfloat16 if cfg.bf16_poly else torch.float32
    coarse = coarse_polyexp_fused(img, cfg.levels, cfg.pyr_scale,
                                  cfg.poly_n, cfg.poly_sigma, out_dtype=dt)
    img0 = gaussian_blur_level(img, cfg, k=0)
    return tuple(coarse) + (poly_expansion_planar(img0, cfg.poly_n,
                                                  cfg.poly_sigma,
                                                  out_dtype=dt),)


def farneback_from_pyramids(Rs_a, Rs_b, cfg: FlowConfig) -> torch.Tensor:
    """Flow prev -> next, (H, W, 2) f32, from two polyexp pyramids."""
    flow_p = None
    for R0, R1 in zip(Rs_a, Rs_b):
        lh, lw = R0.shape[1], R0.shape[2]
        if flow_p is None:
            flow_p = torch.zeros((2, lh, lw), dtype=torch.float32,
                                 device=R0.device)
        else:
            flow_p = resize_linear(flow_p, lh, lw) * (1.0 / cfg.pyr_scale)
        for _ in range(cfg.iterations):
            flow_p = flow_iter(R0, R1, flow_p, cfg.winsize, cfg.fast_warp,
                               cfg.gaussian_win)
    return flow_p.movedim(0, -1)
