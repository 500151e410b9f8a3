"""Track lifecycle: NIS gating, loss, corner-pool re-seeding (port of
kalman_hydra_tpu/models/lifecycle.py). Fixed-capacity pool + masks."""

from __future__ import annotations

import torch

from ..config import EkfConfig, TrackConfig
from . import dynamics
from .ekf import TrackState


def gate(state: TrackState, x_pred, P_pred, nis,
         cfg: EkfConfig) -> TrackState:
    """Gated tracks (NIS > chi^2) keep the prediction and count a miss;
    passing live tracks reset the counter."""
    missed = state.alive & (nis > cfg.gate_chi2)
    x = torch.where(missed[:, None], x_pred, state.x)
    P = torch.where(missed[:, None, None], P_pred, state.P)
    misses = torch.where(missed, state.misses + 1,
                         torch.where(state.alive,
                                     torch.zeros_like(state.misses),
                                     state.misses))
    return state._replace(x=x, P=P, misses=misses)


def kill_lost(state: TrackState, cfg: EkfConfig, height: int,
              width: int) -> TrackState:
    """Kill tracks that exceeded max_misses or left the frame."""
    pos = state.x[:, 0:2]
    inb = ((pos[:, 0] >= 0) & (pos[:, 0] <= width - 1)
           & (pos[:, 1] >= 0) & (pos[:, 1] <= height - 1))
    return state._replace(
        alive=state.alive & (state.misses < cfg.max_misses) & inb)


def reseed(state: TrackState, corner_pts: torch.Tensor,
           corner_score: torch.Tensor, ekf_cfg: EkfConfig,
           trk_cfg: TrackConfig) -> TrackState:
    """Fill dead slots, in index order, with the best corner candidates not
    within min_distance of a living track (score order, ties by index)."""
    K = state.x.shape[0]
    dev = state.x.device
    pos = state.x[:, 0:2]
    d2 = torch.sum((corner_pts[:, None, :] - pos[None, :, :]) ** 2, dim=-1)
    near_live = torch.any((d2 < trk_cfg.min_distance ** 2)
                          & state.alive[None, :], dim=1)
    cand_score = torch.where((corner_score > 0) & ~near_live, corner_score,
                             torch.full_like(corner_score, -float("inf")))
    dead = ~state.alive
    P_pool = cand_score.shape[0]
    order = torch.argsort(-cand_score, stable=True)        # best first
    dead_rank = torch.cumsum(dead.to(torch.int32), 0) - 1  # (K,)
    cand_idx = order[torch.clamp(dead_rank, 0, P_pool - 1)]
    new_pos = corner_pts[cand_idx]
    finite = torch.isfinite(cand_score)
    ok = dead & (dead_rank < finite.sum()) & finite[cand_idx]

    n = ekf_cfg.state_dim
    x_seed = torch.zeros((K, n), dtype=torch.float32, device=dev)
    x_seed[:, 0:2] = new_pos
    P0 = torch.as_tensor(dynamics.initial_covariance(ekf_cfg), device=dev)
    return state._replace(
        x=torch.where(ok[:, None], x_seed, state.x),
        P=torch.where(ok[:, None, None], P0[None], state.P),
        alive=state.alive | ok,
        misses=torch.where(ok, torch.zeros_like(state.misses),
                           state.misses),
        track_id=torch.where(ok, state.track_id + 1, state.track_id))
