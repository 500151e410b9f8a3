"""Hand-written Hopper kernels of the port, one wrapper each.

| wrapper | CUDA source | replaces (kalman_hydra_tpu/kernels/) |
|---|---|---|
| ekf.ekf_fused_step (K1) | csrc/ekf.cu | ekf_pallas.py::ekf_fused_step |
| flow_iter.flow_iter (K2) | csrc/flow_iter.cu | flow_iter_pallas.py::flow_iter |
| flow_iter.flow_iter with row0 (K2's band mode; counts in flow_iter.band) | csrc/flow_iter.cu | flow_iter_pallas.py::flow_iter with row0/img_h |
| polyexp.poly_expansion_planar (K3) | csrc/polyexp.cu | polyexp_pallas.py::poly_expansion_planar |
| level_image.coarse_polyexp_fused (K4) | csrc/level_image.cu | level_image_pallas.py::coarse_polyexp_fused |
| flow_level.flow_levels (K5) | csrc/flow_level.cu | flow_level_pallas.py::flow_level (once per gated level) and the resize between the gated levels (ops/farneback.py) |
| flow_iter.flow_iter_pairs (K6) | csrc/flow_iter.cu | flow_iter_pallas.py::flow_iter_pairs |
| polyexp.poly_expansion_planar_batch (K7a) | csrc/polyexp.cu | polyexp_pallas.py::poly_expansion_planar_batch |
| level_image.coarse_polyexp_fused_batch (K7b) | csrc/level_image.cu | level_image_pallas.py::coarse_polyexp_fused_batch |
| flow_update.flow_update (K8) | csrc/flow_update.cu | flow_update_pallas.py::flow_update and the exact gather before it, ops/farneback.py::_warp_poly_planar (:525-528), now in the kernel |
| pyramid.pyr_down_levels (K9) | csrc/pyramid.cu | pyramid_pallas.py::pyr_down (once per level) |
| scharr.scharr_gradients_levels (K10) | csrc/scharr.cu | scharr_pallas.py::scharr_gradients (once per level) |
| level_image.coarse_level_images (K11) | csrc/level_image.cu | level_image_pallas.py::farneback_images_pallas |
| lk.lk_sparse_levels (K12) | csrc/lk.cu | lk_pallas.py::lk_sparse (_lk_level and its level loop, one launch a frame step) |
| flow_iter.flow_iters_pipelined (K13) | csrc/flow_iters_pipe.cu | flow_iter_pallas.py::flow_iters_pipelined |
| flow_update.flow_update_pairs (K8-pairs) | csrc/flow_update.cu | no Pallas kernel: the pair-batched exact warp's plain XLA, gather included (ops/farneback.py:633-640) |
| K3/K7a past POLY_N_MAX (counts in polyexp.mem_route) | csrc/polyexp.cu (kh_polyexp_mem) | polyexp_pallas.py::poly_expansion_planar(_batch) at any odd poly_n |
| K4/K7b past POLY_N_MAX (counts in level_image.mem_route) | csrc/level_image.cu (K11's kernel over the frames), csrc/polyexp.cu (kh_polyexp_mem over the levels) | level_image_pallas.py::coarse_polyexp_fused(_batch) at any odd poly_n |
| lifecycle.lifecycle_tail | csrc/lifecycle.cu | no Pallas kernel: the reference's XLA glue models/lifecycle.py (gate, kill_lost, reseed), one launch a frame step |

Each wrapper dispatches by device: a CPU tensor takes the plain PyTorch
version beside it, a CUDA tensor launches the kernel or raises. Each
carries a plain-int `launches` counter, bumped once per call that launched
its kernel (K2's band mode bumps `flow_iter.band.launches` instead, and
the device-memory polyexp route past POLY_N_MAX `polyexp.mem_route` or
`level_image.mem_route`).
`pyramid.pyr_down`, `scharr.scharr_gradients`, `lk.lk_level` and
`flow_level.flow_level` are the one-level calls of K9's, K10's, K12's
and K5's wrappers and count there.
"""

from __future__ import annotations

from .ekf import ekf_fused_step
from .flow_iter import flow_iter, flow_iter_pairs, flow_iters_pipelined
from .flow_level import flow_level, flow_levels
from .flow_update import flow_update, flow_update_pairs
from . import level_image, polyexp
from .level_image import (coarse_level_images, coarse_polyexp_fused,
                          coarse_polyexp_fused_batch)
from .lifecycle import lifecycle_tail
from .lk import lk_level, lk_sparse_levels
from .polyexp import poly_expansion_planar, poly_expansion_planar_batch
from .pyramid import pyr_down, pyr_down_levels
from .scharr import scharr_gradients, scharr_gradients_levels

WRAPPERS = {
    "ekf_fused_step": ekf_fused_step,
    "flow_iter": flow_iter,
    "poly_expansion_planar": poly_expansion_planar,
    "coarse_polyexp_fused": coarse_polyexp_fused,
    "flow_levels": flow_levels,
    "flow_iter_pairs": flow_iter_pairs,
    "poly_expansion_planar_batch": poly_expansion_planar_batch,
    "coarse_polyexp_fused_batch": coarse_polyexp_fused_batch,
    "flow_update": flow_update,
    "coarse_level_images": coarse_level_images,
    "pyr_down_levels": pyr_down_levels,
    "scharr_gradients_levels": scharr_gradients_levels,
    "lk_sparse_levels": lk_sparse_levels,
    "flow_iters_pipelined": flow_iters_pipelined,
    "flow_update_pairs": flow_update_pairs,
    "flow_iter_band": flow_iter.band,
    "polyexp_mem": polyexp.mem_route,
    "level_polyexp_mem": level_image.mem_route,
    "lifecycle_tail": lifecycle_tail,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
