"""K10 wrapper: the pyrLK Scharr derivatives gx, gy of one f32 image in
one pass (csrc/scharr.cu).

Replaces kalman_hydra_tpu/kernels/scharr_pallas.py::scharr_gradients:
(H, W) f32 -> (gx, gy), each (H, W) f32, with gx = smooth_y(edge_x f),
gy = edge_y(smooth_x f), edge [-1, 0, 1], smooth [3, 10, 3] / 32 and a
replicate border (cv2's pyrLK derivative convention).

CPU tensors take `scharr_gradients_plain` (two correlate1d passes per
gradient, as ops/lk.py::scharr_gradients in the reference); CUDA tensors
launch the kernel, or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ..ops.filters import correlate1d

SCHARR_EDGE = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
SCHARR_SMOOTH = np.array([3.0, 10.0, 3.0], dtype=np.float32) / 32.0


def scharr_gradients_plain(img: torch.Tensor):
    gx = correlate1d(correlate1d(img, SCHARR_EDGE, dim=-1,
                                 border="replicate"),
                     SCHARR_SMOOTH, dim=-2, border="replicate")
    gy = correlate1d(correlate1d(img, SCHARR_EDGE, dim=-2,
                                 border="replicate"),
                     SCHARR_SMOOTH, dim=-1, border="replicate")
    return gx, gy


def scharr_gradients(img: torch.Tensor):
    if img.device.type == "cpu":
        return scharr_gradients_plain(img)
    _build.require(img, "img", (torch.float32,), 2)
    h, w = img.shape
    out = torch.empty((2, h, w), dtype=torch.float32, device=img.device)
    fn = _build.function("kh_scharr", _build.P, _build.I, _build.I,
                         _build.P, _build.P, _build.P)
    rc = fn(img.data_ptr(), h, w, out[0].data_ptr(), out[1].data_ptr(),
            _build.stream(img))
    _build.check(rc, "kh_scharr")
    scharr_gradients.launches += 1
    return out[0], out[1]


scharr_gradients.launches = 0
