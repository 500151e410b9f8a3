"""State-space dynamics for point tracks (port of
kalman_hydra_tpu/models/dynamics.py).

Constant-velocity (4-state [x, y, vx, vy]), constant-acceleration (6-state
[x, y, vx, vy, ax, ay]) and coordinated-turn (4-state, config-fixed turn
rate) models with continuous white-noise discretized process covariance.
Config-static, so they are built host-side in NumPy.
"""

from __future__ import annotations

import numpy as np

from ..config import EkfConfig


def transition(cfg: EkfConfig) -> np.ndarray:
    dt = cfg.dt
    n = cfg.state_dim
    if cfg.dynamics == "ct":
        w = cfg.turn_rate
        s, c = np.sin(w * dt), np.cos(w * dt)
        sw = s / w
        cw = (1.0 - c) / w
        return np.array([[1, 0, sw, -cw],
                         [0, 1, cw, sw],
                         [0, 0, c, -s],
                         [0, 0, s, c]], dtype=np.float32)
    F = np.eye(n, dtype=np.float32)
    F[0, 2] = dt
    F[1, 3] = dt
    if n == 6:
        F[2, 4] = dt
        F[3, 5] = dt
        F[0, 4] = 0.5 * dt * dt
        F[1, 5] = 0.5 * dt * dt
    return F


def process_noise(cfg: EkfConfig) -> np.ndarray:
    dt, q = cfg.dt, cfg.q
    if cfg.state_dim == 4:
        q11, q12, q22 = dt ** 3 / 3.0, dt ** 2 / 2.0, dt
        Q = np.zeros((4, 4), dtype=np.float32)
        for (i, j) in [(0, 2), (1, 3)]:
            Q[i, i] = q11
            Q[i, j] = Q[j, i] = q12
            Q[j, j] = q22
        return (q * Q).astype(np.float32)
    d5, d4, d3, d2 = dt ** 5 / 20, dt ** 4 / 8, dt ** 3 / 6, dt ** 2 / 2
    blk = np.array([[d5, d4, d3],
                    [d4, dt ** 3 / 3, d2],
                    [d3, d2, dt]], dtype=np.float32)
    Q = np.zeros((6, 6), dtype=np.float32)
    for axis in range(2):
        idx = [0 + axis, 2 + axis, 4 + axis]
        for a in range(3):
            for b in range(3):
                Q[idx[a], idx[b]] = blk[a, b]
    return (q * Q).astype(np.float32)


def position_H(cfg: EkfConfig) -> np.ndarray:
    """Linear position-measurement matrix [I2 | 0]."""
    H = np.zeros((2, cfg.state_dim), dtype=np.float32)
    H[0, 0] = H[1, 1] = 1.0
    return H


def initial_covariance(cfg: EkfConfig) -> np.ndarray:
    d = [cfg.p0_pos, cfg.p0_pos, cfg.p0_vel, cfg.p0_vel]
    if cfg.state_dim == 6:
        d += [cfg.p0_acc, cfg.p0_acc]
    return np.diag(d).astype(np.float32)
