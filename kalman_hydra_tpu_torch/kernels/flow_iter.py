"""K2 wrapper: one fine-level Farneback iteration (csrc/flow_iter.cu).

Replaces kalman_hydra_tpu/kernels/flow_iter_pallas.py::flow_iter:
R0, R1 (5, h, w) unwarped polyexp planes (bf16 or f32), flow (2, h, w)
f32 prior -> (2, h, w) f32 new absolute flow. Select-sum warp clamped to
+-max_disp (FlowConfig.fast_warp), averaged normal equations with the
OpenCV border taper, winsize window with a replicate border on M, 2x2
solve. Follows the TPU kernel's precision (flow and M in f32), not the
XLA twin's bf16 rounding of both.

CPU tensors take `flow_iter_plain`; CUDA tensors launch the kernel, or
raise.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build
from ..ops.filters import gaussian_kernel, pad1d

# OpenCV's FarnebackUpdateMatrices border taper (ops/farneback.py in the
# reference), indexed by the distance to the nearest edge
_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472],
                         dtype=np.float32)


@lru_cache(maxsize=16)
def window_weights(winsize: int, gaussian: bool):
    """(taps f32, post_scale): the cv2 Gaussian window
    (sigma = (winsize//2) * 0.3); a 3-divisible uniform box as unit taps
    with (1/n)^2 applied after both passes (the TPU kernel's factored box);
    otherwise explicit 1/n taps."""
    n = 2 * (winsize // 2) + 1
    if gaussian:
        return gaussian_kernel(n, (winsize // 2) * 0.3), 1.0
    if n % 3 == 0:
        inv = 1.0 / n
        return np.ones(n, np.float32), float(np.float32(inv * inv))
    return np.full(n, np.float32(1.0 / n), np.float32), 1.0


def _damp(n: int, device) -> torch.Tensor:
    i = np.arange(n)
    d = np.minimum(i, n - 1 - i)
    s = np.where(d < len(_BORDER_SCALE),
                 _BORDER_SCALE[np.minimum(d, len(_BORDER_SCALE) - 1)],
                 np.float32(1.0)).astype(np.float32)
    return torch.as_tensor(s, device=device)


def flow_iter_plain(R0, R1, flow, winsize: int, max_disp: int,
                    gaussian: bool = False) -> torch.Tensor:
    _, h, w = R0.shape
    D = float(max_disp)
    dev = R0.device
    R0 = R0.to(torch.float32)
    R1 = R1.to(torch.float32)
    dx, dy = flow[0], flow[1]
    dxc = torch.clamp(dx, -D, D)
    dyc = torch.clamp(dy, -D, D)
    xf, yf = torch.floor(dxc), torch.floor(dyc)
    ax, ay = dxc - xf, dyc - yf
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    ra = torch.clamp(rows + yf.to(torch.int64), 0, h - 1)
    rb = torch.clamp(rows + yf.to(torch.int64) + 1, 0, h - 1)
    v = ((1 - ay) * R1.gather(1, ra.expand(5, h, w))
         + ay * R1.gather(1, rb.expand(5, h, w)))
    ca = torch.clamp(cols + xf.to(torch.int64), 0, w - 1)
    cb = torch.clamp(cols + xf.to(torch.int64) + 1, 0, w - 1)
    R1w = ((1 - ax) * v.gather(2, ca.expand(5, h, w))
           + ax * v.gather(2, cb.expand(5, h, w)))

    a_xx = (R0[2] + R1w[2]) * 0.5
    a_yy = (R0[3] + R1w[3]) * 0.5
    axy = (R0[4] + R1w[4]) * 0.25
    db_x = (R0[0] - R1w[0]) * 0.5 + a_xx * dx + axy * dy
    db_y = (R0[1] - R1w[1]) * 0.5 + axy * dx + a_yy * dy
    damp = _damp(h, dev)[:, None] * _damp(w, dev)[None, :]
    a_xx, a_yy, axy, db_x, db_y = (t * damp
                                   for t in (a_xx, a_yy, axy, db_x, db_y))
    M = torch.stack([a_xx * a_xx + axy * axy, (a_xx + a_yy) * axy,
                     a_yy * a_yy + axy * axy, a_xx * db_x + axy * db_y,
                     axy * db_x + a_yy * db_y])

    wts, post = window_weights(winsize, bool(gaussian))
    bw = len(wts) // 2
    Mp = pad1d(M, bw, bw, 1, "replicate")
    Mv = sum(float(wk) * Mp[:, k:k + h, :] for k, wk in enumerate(wts))
    Mp = pad1d(Mv, bw, bw, 2, "replicate")
    g = sum(float(wk) * Mp[:, :, k:k + w] for k, wk in enumerate(wts))
    g11, g12, g22, h1, h2 = (g * post) if post != 1.0 else g
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g22 * h1 - g12 * h2) * idet,
                        (g11 * h2 - g12 * h1) * idet])


_device_weights: dict = {}


def flow_iter(R0, R1, flow, winsize: int, max_disp: int,
              gaussian: bool = False) -> torch.Tensor:
    """One fused Farneback iteration: (5,h,w) x2 + (2,h,w) -> (2,h,w)."""
    if R0.device.type == "cpu":
        return flow_iter_plain(R0, R1, flow, winsize, max_disp, gaussian)
    planes = (torch.float32, torch.bfloat16)
    _build.require(R0, "R0", planes, 3)
    _build.require(R1, "R1", (R0.dtype,), 3)
    _build.require(flow, "flow", (torch.float32,), 3)
    _, h, w = R0.shape
    if R0.shape[0] != 5 or R1.shape != R0.shape or flow.shape != (2, h, w):
        raise ValueError(f"flow_iter: R0 {tuple(R0.shape)}, R1 "
                         f"{tuple(R1.shape)}, flow {tuple(flow.shape)}")
    key = (str(R0.device), winsize, bool(gaussian))
    if key not in _device_weights:
        wts, post = window_weights(winsize, bool(gaussian))
        _device_weights[key] = (torch.as_tensor(wts, device=R0.device),
                                post)
    wts, post = _device_weights[key]
    M = torch.empty((5, h, w), dtype=torch.float32, device=R0.device)
    Mv = torch.empty_like(M)
    out = torch.empty((2, h, w), dtype=torch.float32, device=R0.device)
    P, I = _build.P, _build.I
    fn = _build.function("kh_flow_iter", P, P, I, P, I, I, I, P, I,
                         _build.F, P, P, P, P)
    rc = fn(R0.data_ptr(), R1.data_ptr(), int(R0.dtype == torch.bfloat16),
            flow.data_ptr(), h, w, int(max_disp), wts.data_ptr(),
            wts.shape[0], post, M.data_ptr(), Mv.data_ptr(), out.data_ptr(),
            _build.stream(R0))
    _build.check(rc, "kh_flow_iter")
    flow_iter.launches += 1
    return out


flow_iter.launches = 0
