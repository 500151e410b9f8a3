"""Batched Kalman filter core (port of kalman_hydra_tpu/models/ekf.py).

predict x = Fx, P = FPF^T + Q (Q scaled per track with adaptive_q);
update y = z - h(x), S = HPH^T + R, K = PH^T S^-1 through the
closed-form 2x2 Cholesky, x += Ky, Joseph-form P. Measurement models:
"position" (z = p_prev + flow(p_prev), H = [I2 0]) and "implicit_flow"
(the EKF linearized at the prediction, residual y = p_prev + flow(p-) -
p-, H = (I2 - J_flow(p-)) [I2 0]; iekf_iters > 1 re-linearizes at the
update, the IEKF), or the unscented update (filter_type="ukf",
models/ukf.py). TrackState is a fixed-capacity pool: lifecycle is
masking, never a shape change.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import EkfConfig
from . import dynamics
from ..ops.warp import sample_flow, sample_flow_with_grad


class TrackState(NamedTuple):
    x: torch.Tensor         # (K, n) state mean
    P: torch.Tensor         # (K, n, n) state covariance
    alive: torch.Tensor     # (K,) bool
    misses: torch.Tensor    # (K,) int32 consecutive gated frames
    track_id: torch.Tensor  # (K,) int32 generation id (bumped on re-seed)
    q_scale: Optional[torch.Tensor] = None  # (K,) f32 per-track Q scale,
    #                                         only with adaptive_q > 0


def init_tracks(cfg: EkfConfig, seeds: torch.Tensor,
                valid: torch.Tensor = None) -> TrackState:
    """Seed a track pool from (K, 2) positions."""
    k, n, dev = seeds.shape[0], cfg.state_dim, seeds.device
    x = torch.zeros((k, n), dtype=torch.float32, device=dev)
    x[:, 0:2] = seeds
    P0 = torch.as_tensor(dynamics.initial_covariance(cfg), device=dev)
    alive = (torch.ones(k, dtype=torch.bool, device=dev) if valid is None
             else valid)
    return TrackState(x=x, P=P0.expand(k, n, n).clone(), alive=alive,
                      misses=torch.zeros(k, dtype=torch.int32, device=dev),
                      track_id=torch.zeros(k, dtype=torch.int32, device=dev),
                      q_scale=(torch.ones(k, dtype=torch.float32, device=dev)
                               if cfg.adaptive_q > 0 else None))


def predict(x: torch.Tensor, P: torch.Tensor, F: torch.Tensor,
            Q: torch.Tensor, q_scale: Optional[torch.Tensor] = None):
    """Batched x <- Fx, P <- FPF^T + Q for (n, n) constants F, Q; q_scale
    (K,) scales Q per track."""
    x_p = torch.einsum("ij,kj->ki", F, x)
    FP = torch.einsum("ij,kjl->kil", F, P)
    Qk = Q if q_scale is None else q_scale[:, None, None] * Q
    return x_p, torch.einsum("kil,jl->kij", FP, F) + Qk


def adapt_q(q_scale: torch.Tensor, nis: torch.Tensor, mask: torch.Tensor,
            cfg: EkfConfig) -> torch.Tensor:
    """Innovation-based process-noise adaptation (Mehra): E[NIS] = 2 for a
    consistent 2-dof filter, so Q inflates when the NIS runs hot and
    relaxes when cold, bounded to [0.1, 10] x the configured Q, on the
    tracks `mask` selects."""
    qs = q_scale * (1.0 + cfg.adaptive_q * (nis * 0.5 - 1.0))
    return torch.where(mask, torch.clamp(qs, 0.1, 10.0), q_scale)


def _chol2x2(S: torch.Tensor):
    """Batched 2x2 Cholesky factors (l11, l21, l22) of (K, 2, 2) S."""
    l11 = torch.sqrt(torch.clamp(S[:, 0, 0], min=1e-12))
    l21 = S[:, 1, 0] / l11
    l22 = torch.sqrt(torch.clamp(S[:, 1, 1] - l21 * l21, min=1e-12))
    return l11, l21, l22


def _solve2x2_chol(l11, l21, l22, b: torch.Tensor) -> torch.Tensor:
    """Solve S z = b for batched 2-vectors given the Cholesky of S."""
    w1 = b[:, 0] / l11
    w2 = (b[:, 1] - l21 * w1) / l22
    z2 = w2 / l22
    z1 = (w1 - l21 * z2) / l11
    return torch.stack([z1, z2], dim=-1)


def update(x: torch.Tensor, P: torch.Tensor, y: torch.Tensor,
           H: torch.Tensor, R: torch.Tensor):
    """Measurement update from the residual y = z - h(x). H (2, n) or
    (K, 2, n), R (2, 2) or per track (K, 2, 2) (the photometric
    channel's Gauss-Newton covariance). Returns (x_post, P_post, nis)."""
    if H.ndim == 2:
        H = H.expand(x.shape[0], *H.shape)
    PHt = torch.einsum("kij,kmj->kim", P, H)                 # (K, n, 2)
    S = torch.einsum("kli,kim->klm", H, PHt) + R             # (K, 2, 2)
    l11, l21, l22 = _chol2x2(S)
    nis = torch.sum(y * _solve2x2_chol(l11, l21, l22, y), dim=-1)
    Kg = torch.stack([_solve2x2_chol(l11, l21, l22, PHt[:, i, :])
                      for i in range(PHt.shape[1])], dim=1)  # (K, n, 2)
    x_post = x + torch.einsum("kim,km->ki", Kg, y)
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    IKH = eye - torch.einsum("kim,kmj->kij", Kg, H)
    KRKt = (torch.einsum("kim,kmn,kjn->kij", Kg, R, Kg) if R.ndim == 3
            else torch.einsum("kim,mn,kjn->kij", Kg, R, Kg))
    P_post = torch.einsum("kij,kjl,kml->kim", IKH, P, IKH) + KRKt
    return x_post, P_post, nis


def measurement_noise(cfg: EkfConfig, device) -> torch.Tensor:
    """R = r I (2 x 2) of the flow-driven measurements."""
    return cfg.r * torch.eye(2, dtype=torch.float32, device=device)


def measure_position(flow: torch.Tensor, x_prev: torch.Tensor,
                     x_pred: torch.Tensor, cfg: EkfConfig):
    """Linear measurement z = p_prev + flow(p_prev); returns (y, H) with
    y = z - H x_pred."""
    z, H = position_z(flow, x_prev, cfg)
    return z - x_pred[:, 0:2], H


def position_z(flow: torch.Tensor, x_prev: torch.Tensor, cfg: EkfConfig):
    """The position measurement z = p_prev + flow(p_prev) and its H."""
    p_prev = x_prev[:, 0:2]
    return p_prev + sample_flow(flow, p_prev), position_H_on(cfg,
                                                              flow.device)


_H_on: dict = {}


def position_H_on(cfg: EkfConfig, device) -> torch.Tensor:
    """dynamics.position_H on `device`, uploaded once per (config,
    device)."""
    key = (cfg, str(device))
    H = _H_on.get(key)
    if H is None:
        H = _H_on[key] = torch.as_tensor(dynamics.position_H(cfg),
                                         device=device)
    return H


_P0_on: dict = {}


def initial_covariance_on(cfg: EkfConfig, device) -> torch.Tensor:
    """dynamics.initial_covariance on `device`, uploaded once per
    (config, device): the lifecycle tail's P0."""
    key = (cfg, str(device))
    P0 = _P0_on.get(key)
    if P0 is None:
        P0 = _P0_on[key] = torch.as_tensor(
            dynamics.initial_covariance(cfg), device=device)
    return P0


@lru_cache(maxsize=32)
def transition_noise(cfg: EkfConfig):
    """(dynamics.transition, dynamics.process_noise) of a config, built
    once: the K1 launch's constants."""
    return dynamics.transition(cfg), dynamics.process_noise(cfg)


def measure_implicit_flow(flow: torch.Tensor, x_prev: torch.Tensor,
                          x_lin: torch.Tensor, cfg: EkfConfig):
    """EKF measurement linearized at x_lin (the prediction or an IEKF
    iterate): residual y = p_prev + flow(p_lin) - p_lin, Jacobian
    H = (I2 - J_flow(p_lin)) [I2 | 0]."""
    p_prev, p_lin = x_prev[:, 0:2], x_lin[:, 0:2]
    disp, jac = sample_flow_with_grad(flow, p_lin)
    A = torch.eye(2, dtype=torch.float32, device=flow.device) - jac
    Hpos = position_H_on(cfg, flow.device)
    return p_prev + disp - p_lin, torch.einsum("kij,jn->kin", A, Hpos)


def ekf_step(state: TrackState, flow: torch.Tensor, cfg: EkfConfig,
             F: torch.Tensor, Q: torch.Tensor):
    """One frame: predict + update of all K tracks against a dense flow.

    The position measurement with a shared Q is one K1 launch
    (`ekf_predict_update`): from the PRE-predict state and the
    measurement z it forms the prediction (which the commit and the
    gate's aux outputs take), the residual and the update. A per-track Q
    (adaptive_q), the implicit-flow
    (I)EKF and the UKF take the plain update, on the card too: that is
    the reference's own route (its K1 takes only the linear update with a
    shared Q), not a fallback."""
    from ..kernels.ekf import ekf_predict_update
    x_prev = state.x
    if cfg.measurement == "position" and state.q_scale is None:
        z, H = position_z(flow, x_prev, cfg)
        x_pred, P_pred, x_new, P_new, nis = ekf_predict_update(
            state.x, state.P, z, H, *transition_noise(cfg), cfg.r)
        return commit_update(state, x_pred, P_pred, x_new, P_new, nis, cfg)
    x_pred, P_pred = predict(state.x, state.P, F, Q, state.q_scale)
    if cfg.measurement == "position":
        y, H = measure_position(flow, x_prev, x_pred, cfg)
        x_new, P_new, nis = update(x_pred, P_pred, y, H,
                                   measurement_noise(cfg, flow.device))
    elif cfg.filter_type == "ukf":
        from .ukf import ukf_update
        x_new, P_new, nis = ukf_update(x_pred, P_pred, flow,
                                       x_prev[:, 0:2], cfg.r, cfg)
    else:
        R = measurement_noise(cfg, flow.device)
        x_lin = x_pred
        for _ in range(max(cfg.iekf_iters, 1)):
            y, H = measure_implicit_flow(flow, x_prev, x_lin, cfg)
            # relinearized about x_lin: the residual carries the
            # (x_pred - x_lin) pushforward
            y_adj = y + torch.einsum("kin,kn->ki", H, x_lin - x_pred)
            x_new, P_new, nis = update(x_pred, P_pred, y_adj, H, R)
            x_lin = x_new
    return commit_update(state, x_pred, P_pred, x_new, P_new, nis, cfg)


def commit_update(state: TrackState, x_pred, P_pred, x_new, P_new, nis,
                  cfg: EkfConfig, valid=None):
    """Masked commit: live (alive & valid) tracks take the update, the rest
    keep the prediction. A live track with an invalid measurement reports
    nis = gate_chi2 + 1 (a miss); dead slots report 0. With adaptive_q
    the live tracks' Q scales adapt to their NIS."""
    live = state.alive if valid is None else (state.alive & valid)
    miss_nis = torch.full_like(nis, np.float32(cfg.gate_chi2) + 1.0)
    nis = torch.where(live, nis,
                      torch.where(state.alive, miss_nis,
                                  torch.zeros_like(nis)))
    new_state = state._replace(
        x=torch.where(live[:, None], x_new, x_pred),
        P=torch.where(live[:, None, None], P_new, P_pred))
    if cfg.adaptive_q > 0 and state.q_scale is not None:
        new_state = new_state._replace(
            q_scale=adapt_q(state.q_scale, nis, live, cfg))
    return new_state, {"x_pred": x_pred, "P_pred": P_pred, "nis": nis}
