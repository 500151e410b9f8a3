"""K1 wrapper: fused EKF predict + position update (csrc/ekf.cu).

Replaces kalman_hydra_tpu/kernels/ekf_pallas.py::ekf_fused_step. Same
contract: x (K, n), P (K, n, n), y (K, 2) residual vs the PREDICTED state,
H (2, n) or (K, 2, n), F/Q (n, n) numpy constants, r the measurement noise
variance (R = r I). Returns (x_post, P_post, nis).

`ekf_predict_update` is the frame loop's call of the same kernel: it takes
the measurement z instead of y (the kernel forms y = z - H x_pred) and
also returns the prediction, so that the caller runs no predict of its
own: (x_pred, P_pred, x_post, P_post, nis). Both count in
`ekf_fused_step.launches`.

CPU tensors take the plain versions (models.ekf predict + update); CUDA
tensors launch the kernel, or raise. F and Q are packed for the kernel
once per pair of arrays (the frame loop passes the same arrays each
step).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ..models.ekf import predict, update


def _consts(F, Q, device):
    F_t = torch.as_tensor(np.asarray(F, np.float32), device=device)
    Q_t = torch.as_tensor(np.asarray(Q, np.float32), device=device)
    return F_t, Q_t


def ekf_fused_step_plain(x, P, y, H, F, Q, r: float):
    F_t, Q_t = _consts(F, Q, x.device)
    R = r * torch.eye(2, dtype=torch.float32, device=x.device)
    x_pred, P_pred = predict(x, P, F_t, Q_t)
    return update(x_pred, P_pred, y, H.to(torch.float32), R)


def ekf_predict_update_plain(x, P, z, H, F, Q, r: float):
    F_t, Q_t = _consts(F, Q, x.device)
    R = r * torch.eye(2, dtype=torch.float32, device=x.device)
    x_pred, P_pred = predict(x, P, F_t, Q_t)
    H = H.to(torch.float32)
    Hx = (torch.einsum("ij,kj->ki", H, x_pred) if H.ndim == 2
          else torch.einsum("kij,kj->ki", H, x_pred))
    return (x_pred, P_pred) + tuple(update(x_pred, P_pred, z - Hx, H, R))


_packed: dict = {}


def _packed_consts(F, Q):
    """The host addresses of (F, Q) as contiguous f32 arrays, kept per
    pair of arrays (the arrays and their packed copies are kept too, so
    the ids and the addresses stay theirs)."""
    key = (id(F), id(Q))
    hit = _packed.get(key)
    if hit is None or hit[0] is not F or hit[1] is not Q:
        if len(_packed) > 64:
            _packed.clear()
        Fp = np.ascontiguousarray(F, np.float32)
        Qp = np.ascontiguousarray(Q, np.float32)
        hit = _packed[key] = (F, Q, Fp, Qp, Fp.ctypes.data, Qp.ctypes.data)
    return hit[4], hit[5]


_F32 = torch.float32


def _check(t, name: str) -> None:
    """The kernel's needs of one tensor (on the card, f32, contiguous):
    three attribute reads on the frame loop's path, the detailed message
    otherwise."""
    if not (t.is_cuda and t.dtype is _F32 and t.is_contiguous()):
        _build.require(t, name, (_F32,), t.ndim)


def _launch(x, P, y, H, F, Q, r: float, z_mode: bool, pred: bool):
    K, n = x.shape
    if n not in (4, 6):
        raise ValueError(f"ekf_fused_step: state_dim {n} not in (4, 6)")
    for t, name in ((x, "x"), (P, "P"), (y, "y"), (H, "H")):
        _check(t, name)
    if P.shape != (K, n, n) or y.shape != (K, 2):
        raise ValueError(f"ekf_fused_step: P {tuple(P.shape)} / y "
                         f"{tuple(y.shape)} do not match x {(K, n)}")
    per_track = H.ndim == 3
    if H.shape != ((K, 2, n) if per_track else (2, n)):
        raise ValueError(f"ekf_fused_step: H {tuple(H.shape)} is neither "
                         f"(2, {n}) nor ({K}, 2, {n})")
    # one allocation, its parts as views (on the card's host one
    # torch.empty costs ~3-4 us, a view about half that): x_post, P_post,
    # nis, then x_pred, P_pred
    nn = n * n
    buf = torch.empty(K * (n + nn + 1 + (n + nn if pred else 0)),
                      dtype=_F32, device=x.device)
    xo = buf.as_strided((K, n), (n, 1), 0)
    Po = buf.as_strided((K, n, n), (nn, n, 1), K * n)
    nis = buf.as_strided((K,), (1,), K * (n + nn))
    if pred:
        xp = buf.as_strided((K, n), (n, 1), K * (n + nn + 1))
        Pp = buf.as_strided((K, n, n), (nn, n, 1), K * (2 * n + nn + 1))
    if K == 0:
        return (xp, Pp, xo, Po, nis) if pred else (xo, Po, nis)
    F_h, Q_h = _packed_consts(F, Q)
    rc = _kernel()(x.data_ptr(), P.data_ptr(), y.data_ptr(), H.data_ptr(),
                   int(per_track), int(z_mode), F_h, Q_h, float(r), n, K,
                   xo.data_ptr(),
                   Po.data_ptr(), nis.data_ptr(),
                   xp.data_ptr() if pred else None,
                   Pp.data_ptr() if pred else None, _build.stream(x))
    if rc:
        _build.check(rc, "kh_ekf_step")
    ekf_fused_step.launches += 1
    return (xp, Pp, xo, Po, nis) if pred else (xo, Po, nis)


def _kernel():
    """kh_ekf_step, bound once (a frame loop calls it every step)."""
    global _fn
    if _fn is None:
        P_, I_ = _build.P, _build.I
        _fn = _build.function("kh_ekf_step", P_, P_, P_, P_, I_, I_, P_, P_,
                              _build.F, I_, I_, P_, P_, P_, P_, P_, P_)
    return _fn


_fn = None


def ekf_fused_step(x, P, y, H, F, Q, r: float):
    if x.device.type == "cpu":
        return ekf_fused_step_plain(x, P, y, H, F, Q, r)
    return _launch(x, P, y, H, F, Q, r, False, False)


ekf_fused_step.launches = 0


def ekf_predict_update(x, P, z, H, F, Q, r: float):
    """K1 from the measurement z (K, 2): (x_pred, P_pred, x_post, P_post,
    nis), y = z - H x_pred formed in the kernel."""
    if x.device.type == "cpu":
        return ekf_predict_update_plain(x, P, z, H, F, Q, r)
    return _launch(x, P, z, H, F, Q, r, True, True)
