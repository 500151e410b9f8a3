"""Batched Kalman filter core (port of kalman_hydra_tpu/models/ekf.py,
position measurement only).

predict x = Fx, P = FPF^T + Q; update y = z - Hx, S = HPH^T + R,
K = PH^T S^-1 through the closed-form 2x2 Cholesky, x += Ky, Joseph-form
P. TrackState is a fixed-capacity pool: lifecycle is masking, never a
shape change.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import EkfConfig
from . import dynamics
from ..ops.warp import sample_flow


class TrackState(NamedTuple):
    x: torch.Tensor         # (K, n) state mean
    P: torch.Tensor         # (K, n, n) state covariance
    alive: torch.Tensor     # (K,) bool
    misses: torch.Tensor    # (K,) int32 consecutive gated frames
    track_id: torch.Tensor  # (K,) int32 generation id (bumped on re-seed)


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
                      track_id=torch.zeros(k, dtype=torch.int32, device=dev))


def predict(x: torch.Tensor, P: torch.Tensor, F: torch.Tensor,
            Q: torch.Tensor):
    """Batched x <- Fx, P <- FPF^T + Q for (n, n) constants F, Q."""
    x_p = torch.einsum("ij,kj->ki", F, x)
    FP = torch.einsum("ij,kjl->kil", F, P)
    return x_p, torch.einsum("kil,jl->kij", FP, F) + Q


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
    """Measurement update from the residual y = z - Hx. H (2, n) or
    (K, 2, n), R (2, 2). Returns (x_post, P_post, nis)."""
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
    KRKt = torch.einsum("kim,mn,kjn->kij", Kg, R, Kg)
    P_post = torch.einsum("kij,kjl,kml->kim", IKH, P, IKH) + KRKt
    return x_post, P_post, nis


def measure_position(flow: torch.Tensor, x_prev: torch.Tensor,
                     x_pred: torch.Tensor, cfg: EkfConfig):
    """Linear measurement z = p_prev + flow(p_prev); returns (y, H) with
    y = z - H x_pred."""
    p_prev = x_prev[:, 0:2]
    z = p_prev + sample_flow(flow, p_prev)
    H = torch.as_tensor(dynamics.position_H(cfg), device=flow.device)
    return z - x_pred[:, 0:2], H


def ekf_step(state: TrackState, flow: torch.Tensor, cfg: EkfConfig,
             F: torch.Tensor, Q: torch.Tensor):
    """One frame: predict + position update for all K tracks.

    The update goes through the K1 wrapper with the PRE-predict state and
    the residual vs the prediction (its contract); the separate predict
    here only feeds the residual and the gate's aux outputs."""
    from ..kernels.ekf import ekf_fused_step
    if cfg.measurement != "position":
        raise NotImplementedError(
            f"ekf.measurement={cfg.measurement!r}: only 'position' is "
            "ported (ROADMAP P11)")
    x_pred, P_pred = predict(state.x, state.P, F, Q)
    y, H = measure_position(flow, state.x, x_pred, cfg)
    x_new, P_new, nis = ekf_fused_step(
        state.x, state.P, y, H, dynamics.transition(cfg),
        dynamics.process_noise(cfg), cfg.r)
    return commit_update(state, x_pred, P_pred, x_new, P_new, nis, cfg)


def commit_update(state: TrackState, x_pred, P_pred, x_new, P_new, nis,
                  cfg: EkfConfig, valid=None):
    """Masked commit: live (alive & valid) tracks take the update, the rest
    keep the prediction. A live track with an invalid measurement reports
    nis = gate_chi2 + 1 (a miss); dead slots report 0."""
    live = state.alive if valid is None else (state.alive & valid)
    miss_nis = torch.full_like(nis, np.float32(cfg.gate_chi2) + 1.0)
    nis = torch.where(live, nis,
                      torch.where(state.alive, miss_nis,
                                  torch.zeros_like(nis)))
    new_state = state._replace(
        x=torch.where(live[:, None], x_new, x_pred),
        P=torch.where(live[:, None, None], P_new, P_pred))
    return new_state, {"x_pred": x_pred, "P_pred": P_pred, "nis": nis}
