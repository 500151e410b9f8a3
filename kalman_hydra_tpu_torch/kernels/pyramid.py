"""K9 wrapper: cv2.pyrDown of one f32 image (csrc/pyramid.cu).

Replaces kalman_hydra_tpu/kernels/pyramid_pallas.py::pyr_down: (H, W) f32
-> ((H + 1) // 2, (W + 1) // 2) f32, the [1, 4, 6, 4, 1] / 16 separable
blur with a REFLECT_101 border kept at the even rows and columns. The
kernel computes the reflected indices itself; nothing is pre-padded.

CPU tensors take `pyr_down_plain` (ops.filters.sep_filter2d, then every
other row and column, as ops/pyramid.py::pyr_down in the reference); CUDA
tensors launch the kernel, or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ..ops.filters import sep_filter2d

PYR_TAPS = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def pyr_down_plain(img: torch.Tensor) -> torch.Tensor:
    return sep_filter2d(img, PYR_TAPS, PYR_TAPS,
                        border="reflect101")[..., ::2, ::2]


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    if img.device.type == "cpu":
        return pyr_down_plain(img)
    _build.require(img, "img", (torch.float32,), 2)
    h, w = img.shape
    out = torch.empty(((h + 1) // 2, (w + 1) // 2), dtype=torch.float32,
                      device=img.device)
    fn = _build.function("kh_pyr_down", _build.P, _build.I, _build.I,
                         _build.P, _build.P)
    rc = fn(img.data_ptr(), h, w, out.data_ptr(), _build.stream(img))
    _build.check(rc, "kh_pyr_down")
    pyr_down.launches += 1
    return out


pyr_down.launches = 0
