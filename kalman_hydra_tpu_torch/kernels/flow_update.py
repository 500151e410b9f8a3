"""K8 wrapper: one exact-warp Farneback iteration after the gather
(csrc/flow_update.cu).

Replaces kalman_hydra_tpu/kernels/flow_update_pallas.py::flow_update:
R0 and the already-warped R1w (5, h, w) f32, the prior flow (2, h, w) f32
-> the new absolute flow (2, h, w) f32. Averaged normal equations with
OpenCV's border taper, the winsize window over M with a replicate border,
2x2 solve. The window is K8's own: float32(1/n) taps for the box (the
TPU kernel does not factor it, unlike K2's `window_weights`), the cv2
Gaussian otherwise, and no post-scale. f32 only, as the TPU kernel is: a
caller with bf16 planes upcasts (ops/farneback.py does).

CPU tensors take `flow_update_plain`; CUDA tensors launch the kernel, or
raise.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build
from .flow_iter import solve_warped
from ..ops.filters import gaussian_kernel


@lru_cache(maxsize=16)
def update_weights(winsize: int, gaussian: bool) -> np.ndarray:
    """K8's window taps (f32): the cv2 Gaussian with sigma =
    (winsize//2) * 0.3, or a box of float32(1/n) taps."""
    bw = winsize // 2
    n = 2 * bw + 1
    if gaussian:
        return gaussian_kernel(n, bw * 0.3)
    return np.full(n, 1.0 / n, np.float64).astype(np.float32)


def flow_update_plain(R0, R1w, flow, winsize: int,
                      gaussian: bool = False) -> torch.Tensor:
    return solve_warped(R0, R1w, flow, update_weights(winsize,
                                                      bool(gaussian)), 1.0)


_device_weights: dict = {}


def _weights_on(device, winsize: int, gaussian: bool) -> torch.Tensor:
    key = (str(device), winsize, bool(gaussian))
    if key not in _device_weights:
        _device_weights[key] = torch.as_tensor(
            update_weights(winsize, bool(gaussian)), device=device)
    return _device_weights[key]


def flow_update(R0, R1w, flow, winsize: int,
                gaussian: bool = False) -> torch.Tensor:
    """Fused M + window + solve: (5,h,w) f32 x2 + (2,h,w) -> (2,h,w)."""
    if any(t.dtype != torch.float32 for t in (R0, R1w, flow)):
        raise TypeError("flow_update takes f32 planes and flow (upcast "
                        f"first): got {R0.dtype}, {R1w.dtype}, {flow.dtype}")
    if R0.device.type == "cpu":
        return flow_update_plain(R0, R1w, flow, winsize, gaussian)
    for t, name in ((R0, "R0"), (R1w, "R1w"), (flow, "flow")):
        _build.require(t, name, (torch.float32,), 3)
    _, h, w = R0.shape
    if R0.shape[0] != 5 or R1w.shape != R0.shape or flow.shape != (2, h, w):
        raise ValueError(f"flow_update: R0 {tuple(R0.shape)}, R1w "
                         f"{tuple(R1w.shape)}, flow {tuple(flow.shape)}")
    wts = _weights_on(R0.device, winsize, gaussian)
    M = torch.empty((5, h, w), dtype=torch.float32, device=R0.device)
    Mv = torch.empty_like(M)
    out = torch.empty((2, h, w), dtype=torch.float32, device=R0.device)
    P, I = _build.P, _build.I
    fn = _build.function("kh_flow_update", P, P, P, I, I, P, I, P, P, P, P)
    rc = fn(R0.data_ptr(), R1w.data_ptr(), flow.data_ptr(), h, w,
            wts.data_ptr(), wts.shape[0], M.data_ptr(), Mv.data_ptr(),
            out.data_ptr(), _build.stream(R0))
    _build.check(rc, "kh_flow_update")
    flow_update.launches += 1
    return out


flow_update.launches = 0
