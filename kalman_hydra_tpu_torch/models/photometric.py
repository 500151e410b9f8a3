"""Photometric measurement channel (port of
kalman_hydra_tpu/models/photometric.py).

Each track's template is the (W x W) patch around its previous position
in the previous frame; Gauss-Newton on the residual
r(p) = I_next(p + u) - T(u), started at the predicted position, gives the
measured position z, with the Gauss-Newton covariance
R_k = sigma_I^2 G^-1 (G = sum grad I grad I^T) as its per-track
measurement noise and a texture/drift gate as its validity. It reads the
frames, not a dense flow. measurement="photometric" uses it as THE
measurement (`photometric_step`); "flow_photometric" applies it as a
second update after the flow channel's (`photometric_refine`). Plain
torch, as the reference has no Pallas kernel here; the per-track R_k
means the plain update, never K1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import EkfConfig
from ..ops.warp import bilinear_sample, bilinear_sample_rows
from . import dynamics
from .ekf import commit_update, predict, update


def _patch_coords(pts: torch.Tensor, win: int):
    """(K, 2) centres -> (K, W*W) x and y sample coords around each."""
    r = win // 2
    off = torch.arange(-r, r + 1, dtype=torch.float32, device=pts.device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    return pts[:, 0:1] + ox.reshape(1, -1), pts[:, 1:2] + oy.reshape(1, -1)


def _image_gradients(img: torch.Tensor):
    """Central-difference gradients of the full image, borders zeroed."""
    gx = (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1)) * 0.5
    gy = (torch.roll(img, -1, dims=0) - torch.roll(img, 1, dims=0)) * 0.5
    gx[:, 0] = 0
    gx[:, -1] = 0
    gy[0, :] = 0
    gy[-1, :] = 0
    return gx, gy


def photometric_measure(prev_gray: torch.Tensor, gray: torch.Tensor,
                        p_prev: torch.Tensor, p_pred: torch.Tensor,
                        cfg: EkfConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched photometric position measurement from (H, W) f32 frames:
    templates at p_prev (K, 2), Gauss-Newton from p_pred (K, 2). Returns
    (z (K, 2), Rk (K, 2, 2), valid (K,) bool)."""
    win = cfg.photo_win
    tx, ty = _patch_coords(p_prev, win)
    T = bilinear_sample(prev_gray, tx, ty)              # (K, W*W)
    gx, gy = _image_gradients(gray)
    h, w = gray.shape
    planes = torch.stack([gray, gx, gy], dim=-1).reshape(h * w, 3)

    p, G = p_pred, None
    for _ in range(max(cfg.photo_iters, 1)):
        px, py = _patch_coords(p, win)
        s = bilinear_sample_rows(planes, h, w, px, py)
        I, gxp, gyp = s[..., 0], s[..., 1], s[..., 2]
        e = T - I
        Gxx = torch.sum(gxp * gxp, dim=-1)
        Gxy = torch.sum(gxp * gyp, dim=-1)
        Gyy = torch.sum(gyp * gyp, dim=-1)
        bx = torch.sum(gxp * e, dim=-1)
        by = torch.sum(gyp * e, dim=-1)
        det = Gxx * Gyy - Gxy * Gxy
        idet = 1.0 / torch.clamp(det, min=1e-6)
        d = torch.stack([(Gyy * bx - Gxy * by) * idet,
                         (Gxx * by - Gxy * bx) * idet], dim=-1)
        # a degenerate structure tensor takes no step
        d = torch.where((det > 1e-6)[:, None], d, torch.zeros_like(d))
        p = p + torch.clamp(d, -cfg.photo_clip, cfg.photo_clip)
        G = (Gxx, Gxy, Gyy)
    Gxx, Gxy, Gyy = G

    idet = 1.0 / torch.clamp(Gxx * Gyy - Gxy * Gxy, min=1e-6)
    Rk = cfg.photo_r * idet[:, None, None] * torch.stack(
        [torch.stack([Gyy, -Gxy], dim=-1),
         torch.stack([-Gxy, Gxx], dim=-1)], dim=-2)
    # texture gate: the min eigenvalue of G per window pixel
    tr = Gxx + Gyy
    disc = torch.sqrt(torch.clamp((Gxx - Gyy) ** 2 + 4.0 * Gxy * Gxy,
                                  min=0.0))
    emin = 0.5 * (tr - disc) / float(win * win)
    drift = torch.linalg.vector_norm(p - p_pred, dim=-1)
    valid = (emin > cfg.photo_min_eig) & (
        drift < cfg.photo_clip * max(cfg.photo_iters, 1))
    return p, Rk, valid


def photometric_step(state, prev_gray: torch.Tensor, gray: torch.Tensor,
                     cfg: EkfConfig, F: torch.Tensor, Q: torch.Tensor):
    """Predict + photometric update (measurement="photometric"), with
    ekf_step's (state', aux) contract; an invalid measurement counts as a
    miss through the shared commit."""
    x_prev = state.x
    x_pred, P_pred = predict(state.x, state.P, F, Q, state.q_scale)
    z, Rk, valid = photometric_measure(prev_gray, gray, x_prev[:, 0:2],
                                       x_pred[:, 0:2], cfg)
    Hm = torch.as_tensor(dynamics.position_H(cfg), device=gray.device)
    x_new, P_new, nis = update(x_pred, P_pred, z - x_pred[:, 0:2], Hm, Rk)
    return commit_update(state, x_pred, P_pred, x_new, P_new, nis, cfg,
                         valid=valid)


def photometric_refine(state, aux, prev_gray: torch.Tensor,
                       gray: torch.Tensor, p_prev: torch.Tensor,
                       cfg: EkfConfig):
    """The second, photometric update of measurement="flow_photometric",
    linearized at the flow-updated state; aux (the flow channel's NIS
    among it) passes through unchanged."""
    z, Rk, valid = photometric_measure(prev_gray, gray, p_prev,
                                       state.x[:, 0:2], cfg)
    Hm = torch.as_tensor(dynamics.position_H(cfg), device=gray.device)
    x_new, P_new, _ = update(state.x, state.P, z - state.x[:, 0:2], Hm, Rk)
    live = state.alive & valid
    return state._replace(
        x=torch.where(live[:, None], x_new, state.x),
        P=torch.where(live[:, None, None], P_new, state.P)), aux
