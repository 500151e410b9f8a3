"""The lifecycle tail of a frame step in one launch (csrc/lifecycle.cu):
the NIS gate, kill_lost and, given a corner pool, the re-seeding of the
dead slots.

Replaces no Pallas kernel: the reference runs models/lifecycle.py's
gate, kill_lost and reseed as XLA glue. `lifecycle_tail_plain` is that
chain of the port's models/lifecycle.py (reseed only when `pool` is
given); the kernel gives the same TrackState bit for bit: x, P, alive,
misses, track_id and q_scale.

lifecycle_tail(state, x_pred, P_pred, nis, pool, P0, ekf_cfg, trk_cfg,
h, w): `state` the TrackState after the measurement update, x_pred
(K, n), P_pred (K, n, n) and nis (K,) its prediction and NIS, pool
(pts (P, 2), score (P,)) or None, P0 (n, n) the initial covariance on
the state's device (`models.ekf.initial_covariance_on`; the twin's
reseed builds its own), the frame's h and w. CPU tensors take the plain
version; CUDA tensors launch the kernel, or raise. The outputs are new
tensors; without a pool track_id and q_scale are the state's own, as
the twin leaves them.
"""

from __future__ import annotations

import torch

from . import _build
from ..models import lifecycle

SMEM_MAX = 232448 - 1024   # dynamic shared memory a block may take, bytes
GRID_CELLS = 65 * 65       # csrc/lifecycle.cu kCells


def smem_bytes(K: int, P: int, pool: bool) -> int:
    """The launch's dynamic shared memory (csrc/lifecycle.cu smem_bytes):
    8 B a candidate (P rounded up to a power of two), 12 B a slot and the
    grid with a pool; 4 B a slot without one."""
    if not pool:
        return 4 * K
    return 8 * (1 << max(P - 1, 0).bit_length()) + 12 * K \
        + 4 * (GRID_CELLS + 1)


def lifecycle_tail_plain(state, x_pred, P_pred, nis, pool, P0, ekf_cfg,
                         trk_cfg, h: int, w: int):
    state = lifecycle.gate(state, x_pred, P_pred, nis, ekf_cfg)
    state = lifecycle.kill_lost(state, ekf_cfg, h, w)
    if pool is not None:
        state = lifecycle.reseed(state, *pool, ekf_cfg, trk_cfg)
    return state


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def _arg(t, name: str, dtype):
    """One tensor as the kernel takes it: on the card, of its dtype (else
    the detailed error), contiguous (a strided one is copied). Three
    attribute reads on the frame loop's path."""
    if t.is_cuda and t.dtype is dtype and t.is_contiguous():
        return t
    if t.is_cuda and t.dtype is dtype:
        return t.contiguous()
    _build.require(t, name, (dtype,), t.ndim)


def _kernel():
    """kh_lifecycle_tail, bound once (a frame loop calls it every
    step)."""
    global _fn
    if _fn is None:
        P_, I_, F_ = _build.P, _build.I, _build.F
        _fn = _build.function("kh_lifecycle_tail", *(P_,) * 12, I_, I_, I_,
                              F_, I_, F_, F_, F_, *(P_,) * 7)
    return _fn


_fn = None


def _launch(state, x_pred, P_pred, nis, pool, P0, ekf_cfg, trk_cfg, h, w):
    x, P = _arg(state.x, "x", _F32), _arg(state.P, "P", _F32)
    x_pred, P_pred = _arg(x_pred, "x_pred", _F32), _arg(P_pred, "P_pred",
                                                         _F32)
    nis, alive = _arg(nis, "nis", _F32), _arg(state.alive, "alive", _BOOL)
    misses = _arg(state.misses, "misses", _I32)
    tid = _arg(state.track_id, "track_id", _I32)
    qs = state.q_scale
    if qs is not None:
        qs = _arg(qs, "q_scale", _F32)
    K, n = x.shape
    if (P.shape != (K, n, n) or x_pred.shape != (K, n)
            or P_pred.shape != (K, n, n) or nis.shape != (K,)):
        raise ValueError(f"lifecycle_tail: P {tuple(P.shape)}, x_pred "
                         f"{tuple(x_pred.shape)}, P_pred "
                         f"{tuple(P_pred.shape)}, nis {tuple(nis.shape)} do "
                         f"not match x {(K, n)}")
    Pn = 0
    if pool is not None:
        pts, score = (_arg(pool[0], "corner pts", _F32),
                      _arg(pool[1], "corner score", _F32))
        P0 = _arg(P0, "P0", _F32)
        Pn = score.shape[0]
        if pts.shape != (Pn, 2) or P0.shape != (n, n):
            raise ValueError(f"lifecycle_tail: pts {tuple(pts.shape)} / P0 "
                             f"{tuple(P0.shape)} are not ({Pn}, 2) / "
                             f"({n}, {n})")
    smem = smem_bytes(K, Pn, pool is not None)
    if smem > SMEM_MAX:
        raise ValueError(
            f"lifecycle_tail: {K} tracks and a pool of {Pn} need {smem} B "
            f"of shared memory, over the {SMEM_MAX} B one block takes "
            f"(num_tracks and corner_pool up to 8192 each fit)")
    # (one torch.empty an output: on the host a view of a shared buffer
    # costs more than an allocation)
    dev = x.device
    reseed = pool is not None
    fq = reseed and qs is not None
    xo = torch.empty((K, n), dtype=_F32, device=dev)
    Po = torch.empty((K, n, n), dtype=_F32, device=dev)
    alive_o = torch.empty(K, dtype=_BOOL, device=dev)
    mo = torch.empty(K, dtype=_I32, device=dev)
    to = torch.empty(K, dtype=_I32, device=dev) if reseed else tid
    qo = torch.empty(K, dtype=_F32, device=dev) if fq else qs
    if K == 0:
        return state._replace(x=xo, P=Po, alive=alive_o, misses=mo,
                              track_id=to, q_scale=qo)
    rc = _kernel()(
        x.data_ptr(), P.data_ptr(), x_pred.data_ptr(), P_pred.data_ptr(),
        nis.data_ptr(), alive.data_ptr(), misses.data_ptr(), tid.data_ptr(),
        qs.data_ptr() if qs is not None else None,
        pts.data_ptr() if reseed else None,
        score.data_ptr() if reseed else None,
        P0.data_ptr() if reseed else None, K, n, Pn, ekf_cfg.gate_chi2,
        ekf_cfg.max_misses, w - 1, h - 1, trk_cfg.min_distance ** 2,
        xo.data_ptr(), Po.data_ptr(), alive_o.data_ptr(), mo.data_ptr(),
        to.data_ptr() if reseed else None,
        qo.data_ptr() if fq else None, _build.stream(x))
    if rc:
        _build.check(rc, "kh_lifecycle_tail")
    lifecycle_tail.launches += 1
    return state._replace(x=xo, P=Po, alive=alive_o, misses=mo,
                          track_id=to, q_scale=qo)


def lifecycle_tail(state, x_pred, P_pred, nis, pool, P0, ekf_cfg, trk_cfg,
                   h: int, w: int):
    if state.x.device.type == "cpu":
        return lifecycle_tail_plain(state, x_pred, P_pred, nis, pool, P0,
                                    ekf_cfg, trk_cfg, h, w)
    return _launch(state, x_pred, P_pred, nis, pool, P0, ekf_cfg, trk_cfg,
                   h, w)


lifecycle_tail.launches = 0
