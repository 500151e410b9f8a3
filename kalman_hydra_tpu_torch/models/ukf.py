"""Unscented Kalman update of the flow measurement channel (port of
kalman_hydra_tpu/models/ukf.py).

EkfConfig.filter_type = "ukf" with a nonlinear flow measurement: instead
of linearizing h(x) = pos(x) - flow(pos(x)) with the flow's Jacobian,
2n + 1 sigma points per track go through the bilinear flow sampler
itself. Plain torch: the reference has no Pallas kernel here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import EkfConfig
from ..ops.warp import sample_flow
from .ekf import _chol2x2, _solve2x2_chol


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of batched (K, n, n) A, column by column in
    elementwise torch ops (n <= 6): the values of the reference's
    jnp.linalg.cholesky on the CPU, bit for bit, and the same on the
    card; a matrix that is not positive definite gets NaN, as there."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[:, j, j]
        for k in range(j):
            s = s - L[:, j, k] * L[:, j, k]
        L[:, j, j] = torch.sqrt(s)
        for i in range(j + 1, n):
            t = A[:, i, j]
            for k in range(j):
                t = t - L[:, i, k] * L[:, j, k]
            L[:, i, j] = t / L[:, j, j]
    return L


def _sigma_points(x: torch.Tensor, P: torch.Tensor, lam: float):
    """Batched sigma points (K, 2n+1, n) and their mean weights (2n+1,),
    from the Cholesky factor of (n + lam) P."""
    K, n = x.shape
    cols = _cholesky((n + lam) * P).transpose(1, 2)  # rows = scaled cols
    chi = torch.cat([x[:, None, :], x[:, None, :] + cols,
                     x[:, None, :] - cols], dim=1)
    wm = torch.full((2 * n + 1,), 1.0 / (2.0 * (n + lam)),
                    dtype=torch.float32, device=x.device)
    wm[0] = lam / (n + lam)
    return chi, wm


def _weighted_mean(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """sum_s w[s] X[:, s] of (K, S, d) sigma-point values, summed as the
    reference's XLA dot on the CPU sums it: point after point, each a
    fused multiply-add (one rounding to f32 per point; the product and
    the sum are exact in f64 before it). Bit for bit the reference's
    mean, and the same on the card: a mean that cancels to exactly the
    previous position gives a zero innovation in both, so a track on the
    frame's last column stays inside it in both."""
    acc = torch.zeros((X.shape[0], X.shape[2]), dtype=torch.float64,
                      device=X.device)
    for s in range(X.shape[1]):
        acc = (acc + w[s].double() * X[:, s].double()).float().double()
    return acc.float()


def ukf_update(x_pred: torch.Tensor, P_pred: torch.Tensor,
               flow: torch.Tensor, p_prev: torch.Tensor, r: float,
               cfg: EkfConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unscented update of (K, n) states against the (H, W, 2) flow:
    h(x) = pos(x) - flow(pos(x)), observed z = p_prev. Returns
    (x_post, P_post, nis)."""
    K, n = x_pred.shape
    lam = cfg.ukf_alpha ** 2 * (n + cfg.ukf_kappa) - n
    chi, wm = _sigma_points(x_pred, P_pred, lam)
    wc = wm.clone()
    wc[0] += 1.0 - cfg.ukf_alpha ** 2 + cfg.ukf_beta

    fl = sample_flow(flow, chi[..., 0:2].reshape(-1, 2)).reshape(K, -1, 2)
    Z = chi[..., 0:2] - fl                       # (K, 2n+1, 2)
    z_mean = _weighted_mean(wm, Z)
    dZ = Z - z_mean[:, None, :]
    dX = chi - _weighted_mean(wm, chi)[:, None, :]
    S = (torch.einsum("s,ksi,ksj->kij", wc, dZ, dZ)
         + r * torch.eye(2, dtype=torch.float32, device=x_pred.device))
    C = torch.einsum("s,ksn,ksm->knm", wc, dX, dZ)

    l11, l21, l22 = _chol2x2(S)
    y = p_prev - z_mean                          # innovation
    nis = torch.sum(y * _solve2x2_chol(l11, l21, l22, y), dim=-1)
    Kg = torch.stack([_solve2x2_chol(l11, l21, l22, C[:, i, :])
                      for i in range(n)], dim=1)  # (K, n, 2)
    x_post = x_pred + torch.einsum("knm,km->kn", Kg, y)
    KS = torch.einsum("knm,kml->knl", Kg, S)
    P_post = P_pred - torch.einsum("knl,kjl->knj", KS, Kg)
    return x_post, 0.5 * (P_post + P_post.transpose(1, 2)), nis
