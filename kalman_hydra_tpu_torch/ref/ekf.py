"""NumPy oracle: estimation half (KF / EKF / RTS).

Plain-NumPy implementation of the filter math contract (SURVEY.md §2.3,
BASELINE.json:5): predict x=Fx, P=FPF^T+Q; update y=z-h(x), S=HPH^T+R,
K=PH^T S^-1 (Cholesky), Joseph-form covariance; RTS backward pass. It is the
unit-test twin of the filter models and is intentionally written the
boring, obviously-correct way. The port's copy of
`kalman_hydra_tpu/ref/ekf.py`: NumPy only.
"""

from __future__ import annotations

import numpy as np

from ..config import EkfConfig


# ---------------------------------------------------------------- dynamics

def transition(cfg: EkfConfig) -> np.ndarray:
    """Constant-velocity (4) or constant-acceleration (6) transition matrix.

    State layout: [x, y, vx, vy] or [x, y, vx, vy, ax, ay].
    """
    dt = cfg.dt
    n = cfg.state_dim
    F = np.eye(n, dtype=np.float64)
    F[0, 2] = dt
    F[1, 3] = dt
    if n == 6:
        F[2, 4] = dt
        F[3, 5] = dt
        F[0, 4] = 0.5 * dt * dt
        F[1, 5] = 0.5 * dt * dt
    return F


def process_noise(cfg: EkfConfig) -> np.ndarray:
    """White-noise acceleration (4-state) / jerk (6-state) discretization."""
    dt = cfg.dt
    q = cfg.q
    if cfg.state_dim == 4:
        # continuous white acceleration, per axis blocks over [pos, vel]
        q11 = dt ** 3 / 3.0
        q12 = dt ** 2 / 2.0
        q22 = dt
        Q = np.zeros((4, 4))
        for a, (i, j) in enumerate([(0, 2), (1, 3)]):
            Q[i, i] = q11
            Q[i, j] = Q[j, i] = q12
            Q[j, j] = q22
        return q * Q
    # 6-state: continuous white jerk over [pos, vel, acc]
    d5, d4, d3, d2 = dt ** 5 / 20, dt ** 4 / 8, dt ** 3 / 6, dt ** 2 / 2
    blk = np.array([[d5, d4, d3],
                    [d4, dt ** 3 / 3, d2],
                    [d3, d2, dt]])
    Q = np.zeros((6, 6))
    for axis in range(2):
        idx = [0 + axis, 2 + axis, 4 + axis]
        for a in range(3):
            for b in range(3):
                Q[idx[a], idx[b]] = blk[a, b]
    return q * Q


def init_state(cfg: EkfConfig, positions: np.ndarray):
    """(K, 2) seed positions -> (x (K, n), P (K, n, n))."""
    k = positions.shape[0]
    n = cfg.state_dim
    x = np.zeros((k, n))
    x[:, 0:2] = positions
    d = [cfg.p0_pos, cfg.p0_pos, cfg.p0_vel, cfg.p0_vel]
    if n == 6:
        d += [cfg.p0_acc, cfg.p0_acc]
    P = np.broadcast_to(np.diag(d), (k, n, n)).copy()
    return x, P


# ------------------------------------------------------------------ filter

def predict(x, P, F, Q):
    """x (n,), P (n, n) -> predicted pair."""
    return F @ x, F @ P @ F.T + Q


def update(x, P, z, H, R):
    """Measurement update with Cholesky solve + Joseph covariance.

    Returns (x_post, P_post, nis)."""
    y = z - H @ x
    S = H @ P @ H.T + R
    L = np.linalg.cholesky(S)
    # K = P H^T S^-1 via two triangular solves
    PHt = P @ H.T
    K = np.linalg.solve(L.T, np.linalg.solve(L, PHt.T)).T
    x_post = x + K @ y
    I_KH = np.eye(P.shape[0]) - K @ H
    P_post = I_KH @ P @ I_KH.T + K @ R @ K.T
    alpha = np.linalg.solve(L, y)
    nis = float(alpha @ alpha)
    return x_post, P_post, nis


def filter_tracks(cfg: EkfConfig, z_seq: np.ndarray, x0: np.ndarray,
                  P0: np.ndarray):
    """Run a linear position-measurement KF over a whole clip (oracle path).

    z_seq : (T, K, 2) position measurements
    Returns dict with filtered/predicted means+covs and NIS, all stacked
    over time — the inputs the RTS oracle needs.
    """
    F = transition(cfg)
    Q = process_noise(cfg)
    H = np.zeros((2, cfg.state_dim))
    H[0, 0] = H[1, 1] = 1.0
    R = cfg.r * np.eye(2)

    T, K = z_seq.shape[:2]
    n = cfg.state_dim
    out = {k: np.zeros((T, K) + s) for k, s in
           [("x_filt", (n,)), ("P_filt", (n, n)),
            ("x_pred", (n,)), ("P_pred", (n, n)), ("nis", ())]}

    x, P = x0.copy(), P0.copy()
    for t in range(T):
        for k in range(K):
            xp, Pp = predict(x[k], P[k], F, Q)
            out["x_pred"][t, k] = xp
            out["P_pred"][t, k] = Pp
            xf, Pf, nis = update(xp, Pp, z_seq[t, k], H, R)
            out["x_filt"][t, k] = xf
            out["P_filt"][t, k] = Pf
            out["nis"][t, k] = nis
            x[k], P[k] = xf, Pf
    return out


def rts_smooth(cfg: EkfConfig, x_filt, P_filt, x_pred, P_pred):
    """Rauch-Tung-Striebel backward pass (SURVEY.md §3.4, BASELINE.json:11).

    All inputs (T, K, ...) stacked filter outputs; x_pred[t] is the predicted
    state *for* step t (prior to the update at t). Returns smoothed (T, K, n).
    """
    F = transition(cfg)
    T, K, n = x_filt.shape
    xs = x_filt.copy()
    Ps = P_filt.copy()
    for t in range(T - 2, -1, -1):
        for k in range(K):
            C = P_filt[t, k] @ F.T @ np.linalg.inv(P_pred[t + 1, k])
            xs[t, k] = x_filt[t, k] + C @ (xs[t + 1, k] - x_pred[t + 1, k])
            Ps[t, k] = P_filt[t, k] + C @ (Ps[t + 1, k] - P_pred[t + 1, k]) @ C.T
    return xs, Ps
