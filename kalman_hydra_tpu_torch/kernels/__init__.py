"""Hand-written Hopper kernels of the port, one wrapper each.

| wrapper | CUDA source | replaces (kalman_hydra_tpu/kernels/) |
|---|---|---|
| ekf.ekf_fused_step | csrc/ekf.cu | ekf_pallas.py::ekf_fused_step |
| flow_iter.flow_iter | csrc/flow_iter.cu | flow_iter_pallas.py::flow_iter |
| polyexp.poly_expansion_planar | csrc/polyexp.cu | polyexp_pallas.py::poly_expansion_planar |
| level_image.coarse_polyexp_fused | csrc/level_image.cu | level_image_pallas.py::coarse_polyexp_fused |

Each wrapper dispatches by device: a CPU tensor takes the plain PyTorch
version beside it, a CUDA tensor launches the kernel or raises. Each
carries a plain-int `launches` counter, bumped once per call that launched
its kernel.
"""

from __future__ import annotations

from .ekf import ekf_fused_step
from .flow_iter import flow_iter
from .level_image import coarse_polyexp_fused
from .polyexp import poly_expansion_planar

WRAPPERS = {
    "ekf_fused_step": ekf_fused_step,
    "flow_iter": flow_iter,
    "poly_expansion_planar": poly_expansion_planar,
    "coarse_polyexp_fused": coarse_polyexp_fused,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
