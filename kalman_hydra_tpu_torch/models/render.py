"""Mesh-render observation channel (port of
kalman_hydra_tpu/models/render.py).

The observed frame is pulled back to the rest (template) frame through
the piecewise-affine mesh warp:

    q(p; V) = sum_m bary_m(p) * v_{tri(p), m}      (rest pixel p -> image)
    I_w(p)  = I_obs(q(p; V))                        (one bilinear gather)
    r(p)    = T(p) - I_w(p)                         (render residual)

The pixel -> triangle assignment and the barycentric weights are
rasterized once, on the host, when the template is built
(`make_template`); a frame then costs a (P,)-point gather and per-vertex
sums over the template pixels. `render_measure` is the lumped
Gauss-Newton of the reference: per-vertex normal equations whose row-sum
lumped matrix G_k = sum_p w_k grad I grad I^T recovers a uniform
displacement in one step, the converged vertex positions the measurement
and sigma^2 G_k^-1 its covariance. `render_jtz` is J^T r by
torch.autograd through the differentiable warp.

The per-vertex sums are deterministic on every device: the template
keeps its 3P (pixel, corner) incidences sorted by vertex (a stable sort,
so each vertex's run keeps the incidences' own order) and each sum is a
`torch.segment_reduce` over those runs, each run added in order. On the
CPU that is the reference's `jax.ops.segment_sum`, bit for bit; on the
card it gives the same bits run after run (no atomics). Plain torch: the
reference has no Pallas kernel here.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import EkfConfig
from ..ops.warp import bilinear_sample, bilinear_sample_rows
from .ekf import commit_update, position_H_on, predict, update
from .photometric import _image_gradients


class RenderTemplate(NamedTuple):
    """Rest-frame rasterization of a BodyMesh, as tensors on one device.

    tri     (P, 3) int64   vertex ids of each template pixel's triangle
    bary    (P, 3) float32 barycentric weights of the pixel in its triangle
    tvals   (P,)   float32 template intensities (frame-0 gray at the pixel)
    rest    (V, 2) float32 rest vertex positions (mesh.vertices)
    pix     (P, 2) float32 template pixel centres (x, y); q(pix; rest) == pix
    order   (3P,)  int64   the (pixel, corner) incidences, flattened
                           row-major, stably sorted by vertex
    lengths (V,)   int64   each vertex's run of incidences in `order`
    """

    tri: torch.Tensor
    bary: torch.Tensor
    tvals: torch.Tensor
    rest: torch.Tensor
    pix: torch.Tensor
    order: torch.Tensor
    lengths: torch.Tensor

    def to(self, device) -> "RenderTemplate":
        return RenderTemplate(*(t.to(device) for t in self))


def make_template(gray0, mesh, max_pixels: int = 0, eps: float = 1e-6, *,
                  device="cuda") -> RenderTemplate:
    """Rasterize the rest mesh over frame 0 on the host, then move the
    template to `device` (the card unless the caller asks for "cpu").

    Every pixel whose centre lies inside a mesh triangle becomes a
    template sample; a pixel on a shared edge goes to the first triangle
    that claims it. `max_pixels > 0` subsamples the template with a
    uniform stride. `gray0` is an (H, W) array or tensor."""
    if isinstance(gray0, torch.Tensor):
        gray0 = gray0.detach().cpu().numpy()
    gray0 = np.asarray(gray0, np.float32)
    h, w = gray0.shape
    verts = np.asarray(mesh.vertices, np.float64)
    tris = np.asarray(mesh.triangles, np.int32)
    tri_id = np.full((h, w), -1, np.int32)
    bar = np.zeros((h, w, 3), np.float32)
    for t, (ia, ib, ic) in enumerate(tris):
        a, b, c = verts[ia], verts[ib], verts[ic]
        x0 = max(int(np.floor(min(a[0], b[0], c[0]))), 0)
        x1 = min(int(np.ceil(max(a[0], b[0], c[0]))) + 1, w)
        y0 = max(int(np.floor(min(a[1], b[1], c[1]))), 0)
        y1 = min(int(np.ceil(max(a[1], b[1], c[1]))) + 1, h)
        if x0 >= x1 or y0 >= y1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        dx = xx - a[0]
        dy = yy - a[1]
        m00, m01 = b[0] - a[0], c[0] - a[0]
        m10, m11 = b[1] - a[1], c[1] - a[1]
        det = m00 * m11 - m01 * m10
        if abs(det) < 1e-9:
            continue
        u = (m11 * dx - m01 * dy) / det
        v = (-m10 * dx + m00 * dy) / det
        inside = (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
        sub = tri_id[y0:y1, x0:x1]
        put = inside & (sub < 0)
        sub[put] = t
        bw = np.stack([1.0 - u - v, u, v], axis=-1).astype(np.float32)
        bar[y0:y1, x0:x1][put] = bw[put]
    ys, xs = np.nonzero(tri_id >= 0)
    if len(xs) == 0:
        raise ValueError("mesh covers no pixels — cannot build a render "
                         "template")
    if max_pixels > 0 and len(xs) > max_pixels:
        stride = int(np.ceil(len(xs) / max_pixels))
        ys, xs = ys[::stride], xs[::stride]
    return template_from_arrays(
        tris[tri_id[ys, xs]], bar[ys, xs], gray0[ys, xs],
        verts.astype(np.float32),
        np.stack([xs, ys], axis=-1).astype(np.float32), device=device)


def template_from_arrays(tri, bary, tvals, rest, pix, *,
                         device="cuda") -> RenderTemplate:
    """A RenderTemplate on `device` from the five host arrays of a
    rasterization (make_template's, or the fields of the reference's
    RenderTemplate): the indices become int64 and the incidences' order
    by vertex is computed here."""
    tri = np.asarray(tri).astype(np.int64)
    ids = tri.reshape(-1)
    rest = np.asarray(rest, np.float32)
    host = (tri, np.asarray(bary, np.float32), np.asarray(tvals, np.float32),
            rest, np.asarray(pix, np.float32),
            np.argsort(ids, kind="stable"),
            np.bincount(ids, minlength=len(rest)).astype(np.int64))
    dev = resolve_device(device)
    return RenderTemplate(*(torch.from_numpy(np.array(a)).to(dev)
                            for a in host))


def segment_sum(vals: torch.Tensor, tmpl: RenderTemplate) -> torch.Tensor:
    """Per-vertex sums of (3P, C) values given per (pixel, corner)
    incidence, flattened row-major -> (V, C): each vertex's incidences
    added in their own order (see the module docstring)."""
    return torch.segment_reduce(vals[tmpl.order], "sum",
                                lengths=tmpl.lengths, axis=0)


def _rest_to_image(bary: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """q = sum_m bary[:, m] vt[:, m] for (P, 3) weights and (P, 3, 2)
    corners, summed in corner order (no matmul, so no TF32)."""
    return (bary[:, 0:1] * vt[:, 0] + bary[:, 1:2] * vt[:, 1]
            + bary[:, 2:3] * vt[:, 2])


# ------------------------------------------------------------- warp core

def warp_to_rest(gray: torch.Tensor, verts: torch.Tensor,
                 tmpl: RenderTemplate) -> torch.Tensor:
    """Pull the observed (H, W) frame back to the rest frame: I_w (P,).
    Differentiable in `verts`."""
    q = _rest_to_image(tmpl.bary, verts[tmpl.tri])
    return bilinear_sample(gray, q[:, 0], q[:, 1])


def render_residual(gray: torch.Tensor, verts: torch.Tensor,
                    tmpl: RenderTemplate) -> torch.Tensor:
    """r = T - I_w(verts): the render residual over the template pixels."""
    return tmpl.tvals - warp_to_rest(gray, verts, tmpl)


def render_loss(gray: torch.Tensor, verts: torch.Tensor,
                tmpl: RenderTemplate) -> torch.Tensor:
    """0.5 * ||r||^2, the photometric energy of the mesh configuration."""
    r = render_residual(gray, verts, tmpl)
    return 0.5 * torch.sum(r * r)


def render_jtz(gray: torch.Tensor, verts: torch.Tensor,
               tmpl: RenderTemplate) -> torch.Tensor:
    """Matrix-free J^T r, J = dI_w/dverts: -grad(render_loss) by
    torch.autograd (one backward pass through the warp). Where a sample
    point lies on the image border, the clamp splits the gradient as
    jax.grad does (`ops.warp.bilinear_sample`)."""
    v = verts.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(render_loss(gray, v, tmpl), v)
    return -g


# -------------------------------------------------- Gauss-Newton channel

def render_measure(gray: torch.Tensor, tmpl: RenderTemplate,
                   v_pred: torch.Tensor, cfg: EkfConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-vertex position measurement from the render residual.

    Block-diagonal Gauss-Newton on 0.5 ||T - I_w(V)||^2 from the
    predicted vertex positions, with the row-sum lumped normal matrix
    G_k = sum_p w_k grad I grad I^T (the weights are a partition of
    unity). [gray, gx, gy] are sampled by one row gather a sweep and the
    five normal-equation sums are one (3P, 5) segment sum. The noise
    scale is estimated from the converged residuals, floored at
    cfg.render_r. Returns (z (V, 2), Rk (V, 2, 2), valid (V,))."""
    h, w = gray.shape
    gx, gy = _image_gradients(gray)
    w1 = tmpl.bary                                         # (P, 3)
    planes = torch.stack([gray, gx, gy], dim=-1).reshape(h * w, 3)
    clip = cfg.render_clip
    iters = max(cfg.render_iters, 1)

    v, G, r = v_pred, None, None
    for _ in range(iters):
        q = _rest_to_image(w1, v[tmpl.tri])
        s = bilinear_sample_rows(planes, h, w, q[:, 0], q[:, 1])
        I, gxp, gyp = s[:, 0], s[:, 1], s[:, 2]
        r = tmpl.tvals - I
        data = torch.stack([gxp * gxp, gxp * gyp, gyp * gyp,
                            gxp * r, gyp * r], dim=-1)     # (P, 5)
        sums = segment_sum((w1[:, :, None] * data[:, None, :])
                           .reshape(-1, 5), tmpl)          # (V, 5)
        Gxx, Gxy, Gyy, bx, by = sums.unbind(-1)
        det = Gxx * Gyy - Gxy * Gxy
        idet = 1.0 / torch.clamp(det, min=1e-6)
        d = torch.stack([(Gyy * bx - Gxy * by) * idet,
                         (Gxx * by - Gxy * bx) * idet], dim=-1)
        d = torch.where((det > 1e-6)[:, None], d, torch.zeros_like(d))
        v = v + torch.clamp(d, -clip, clip)
        G = (Gxx, Gxy, Gyy)
    Gxx, Gxy, Gyy = G

    # support (sum of each vertex's weights) and sum w r^2, in one sum
    support, wr2 = segment_sum(torch.stack(
        [w1, w1 * (r * r)[:, None]], dim=-1).reshape(-1, 2), tmpl).unbind(-1)
    sig2 = torch.clamp(wr2 / torch.clamp(support, min=1e-6),
                       min=cfg.render_r)
    idet = 1.0 / torch.clamp(Gxx * Gyy - Gxy * Gxy, min=1e-6)
    Rk = (sig2 * idet)[:, None, None] * torch.stack(
        [torch.stack([Gyy, -Gxy], dim=-1),
         torch.stack([-Gxy, Gxx], dim=-1)], dim=-2)
    # texture gate: the min eigenvalue of G per unit support
    tr = Gxx + Gyy
    disc = torch.sqrt(torch.clamp((Gxx - Gyy) ** 2 + 4.0 * Gxy * Gxy,
                                  min=0.0))
    emin = 0.5 * (tr - disc) / torch.clamp(support, min=1e-6)
    drift = torch.linalg.vector_norm(v - v_pred, dim=-1)
    valid = (emin > cfg.render_min_eig) & (drift < clip * iters) & (
        support > 0.5)
    return v, Rk, valid


def render_step(state, gray: torch.Tensor, cfg: EkfConfig,
                F: torch.Tensor, Q: torch.Tensor, tmpl: RenderTemplate):
    """Predict + render update (measurement="render"): the deformed-mesh
    appearance is the measurement, no flow. ekf_step's (state', aux)
    contract; the track slots are the mesh vertices. The plain predict
    and update, as in the reference (K1 takes only the flow channel's
    shared-R update)."""
    x_pred, P_pred = predict(state.x, state.P, F, Q, state.q_scale)
    z, Rk, valid = render_measure(gray, tmpl, x_pred[:, 0:2], cfg)
    H = position_H_on(cfg, gray.device)
    x_new, P_new, nis = update(x_pred, P_pred, z - x_pred[:, 0:2], H, Rk)
    return commit_update(state, x_pred, P_pred, x_new, P_new, nis, cfg,
                         valid=valid)


def render_refine(state, aux, gray: torch.Tensor, cfg: EkfConfig,
                  tmpl: RenderTemplate):
    """The second, render update of measurement="flow_render",
    linearized at the flow-updated state; aux (the flow channel's NIS
    among it) passes through unchanged."""
    z, Rk, valid = render_measure(gray, tmpl, state.x[:, 0:2], cfg)
    H = position_H_on(cfg, gray.device)
    x_new, P_new, _ = update(state.x, state.P, z - state.x[:, 0:2], H, Rk)
    live = state.alive & valid
    return state._replace(
        x=torch.where(live[:, None], x_new, state.x),
        P=torch.where(live[:, None, None], P_new, state.P)), aux
