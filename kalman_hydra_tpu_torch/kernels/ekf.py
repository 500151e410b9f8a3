"""K1 wrapper: fused EKF predict + position update (csrc/ekf.cu).

Replaces kalman_hydra_tpu/kernels/ekf_pallas.py::ekf_fused_step. Same
contract: x (K, n), P (K, n, n), y (K, 2) residual vs the PREDICTED state,
H (2, n) or (K, 2, n), F/Q (n, n) numpy constants, r the measurement noise
variance (R = r I). Returns (x_post, P_post, nis).

CPU tensors take `ekf_fused_step_plain` (models.ekf predict + update);
CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ..models.ekf import predict, update


def ekf_fused_step_plain(x, P, y, H, F, Q, r: float):
    F_t = torch.as_tensor(np.asarray(F, np.float32), device=x.device)
    Q_t = torch.as_tensor(np.asarray(Q, np.float32), device=x.device)
    R = r * torch.eye(2, dtype=torch.float32, device=x.device)
    x_pred, P_pred = predict(x, P, F_t, Q_t)
    return update(x_pred, P_pred, y, H.to(torch.float32), R)


def ekf_fused_step(x, P, y, H, F, Q, r: float):
    if x.device.type == "cpu":
        return ekf_fused_step_plain(x, P, y, H, F, Q, r)
    K, n = x.shape
    if n not in (4, 6):
        raise ValueError(f"ekf_fused_step: state_dim {n} not in (4, 6)")
    f32 = (torch.float32,)
    _build.require(x, "x", f32, 2)
    _build.require(P, "P", f32, 3)
    _build.require(y, "y", f32, 2)
    _build.require(H, "H", f32, H.ndim)
    if P.shape != (K, n, n) or y.shape != (K, 2):
        raise ValueError(f"ekf_fused_step: P {tuple(P.shape)} / y "
                         f"{tuple(y.shape)} do not match x {(K, n)}")
    if H.shape not in ((2, n), (K, 2, n)):
        raise ValueError(f"ekf_fused_step: H {tuple(H.shape)} is neither "
                         f"(2, {n}) nor ({K}, 2, {n})")
    xo = torch.empty_like(x)
    Po = torch.empty_like(P)
    nis = torch.empty(K, dtype=torch.float32, device=x.device)
    if K == 0:
        return xo, Po, nis
    F_h = np.ascontiguousarray(F, dtype=np.float32)
    Q_h = np.ascontiguousarray(Q, dtype=np.float32)
    fn = _build.function("kh_ekf_step", *[_build.P] * 4, _build.I,
                         _build.P, _build.P, _build.F, _build.I, _build.I,
                         *[_build.P] * 4)
    rc = fn(x.data_ptr(), P.data_ptr(), y.data_ptr(), H.data_ptr(),
            int(H.ndim == 3), F_h.ctypes.data, Q_h.ctypes.data, float(r),
            n, K, xo.data_ptr(), Po.data_ptr(), nis.data_ptr(),
            _build.stream(x))
    _build.check(rc, "kh_ekf_step")
    ekf_fused_step.launches += 1
    return xo, Po, nis


ekf_fused_step.launches = 0
