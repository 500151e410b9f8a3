"""Bilinear sampling and warping (port of kalman_hydra_tpu/ops/warp.py,
and of the fast warp's contract, ops/farneback.py::_warp_poly_selectsum,
and the exact warp, ::_warp_poly_planar): sample_flow (and with its
Jacobian, for the implicit-flow EKF), the row-stacked plane sampler of
the photometric channel, dense warps, and the plain versions of the
select-sum warp (K2's) and the exact gather of the polyexp planes
(K8's).

Coordinate convention: (x, y) with x = column, matching OpenCV. Samples
outside the image clamp to the border pixel.
"""

from __future__ import annotations

import torch


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clamp(x, lo, hi). Under autograd a point on a bound passes half
    of its gradient, as jnp.clip's does under jax.grad (torch.clamp
    passes all of it): torch.maximum/minimum split a tie's gradient."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    def bound(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample (..., H, W) images at float coords x, y of one query shape;
    returns (..., *query_shape). Border: clamp."""
    h, w = img.shape[-2], img.shape[-1]
    x = _clip(x, 0.0, w - 1.0)
    y = _clip(y, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x), 0, w - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, h - 2).to(torch.int64)
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    i00 = img[..., y0, x0]
    i01 = img[..., y0, x0 + 1]
    i10 = img[..., y0 + 1, x0]
    i11 = img[..., y0 + 1, x0 + 1]
    return (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
            + i10 * (1 - fx) * fy + i11 * fx * fy)


def warp_image(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp an (H, W) image by an (H, W, 2) flow:
    out(p) = img(p + flow(p))."""
    h, w = img.shape[-2], img.shape[-1]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    return bilinear_sample(img, xs + flow[..., 0], ys + flow[..., 1])


def warp_selectsum(planes: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                   max_disp: int, frac_dtype=None) -> torch.Tensor:
    """The fast warp (FlowConfig.fast_warp > 0) of (C, h, w) planes by an
    (h, w) flow (dx, dy): the displacement clamped to +-max_disp, a
    vertical lerp at each pixel's own column, then a horizontal lerp of
    that vertically warped plane at the shifted columns (so a pixel's
    horizontal neighbours bring their own vertical shift), edges
    replicated. What the reference's select-sum over shifted copies
    computes, as two indexed loads. frac_dtype rounds the lerp fractions
    to that type first, as the reference's planar select-sum does with
    the planes' type."""
    C, h, w = planes.shape
    D = float(max_disp)
    dev = planes.device
    dxc = torch.clamp(dx, -D, D)
    dyc = torch.clamp(dy, -D, D)
    xf, yf = torch.floor(dxc), torch.floor(dyc)
    ax, ay = dxc - xf, dyc - yf
    if frac_dtype is not None:
        ax, ay = ax.to(frac_dtype).to(ax.dtype), ay.to(frac_dtype).to(ay.dtype)
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    ra = torch.clamp(rows + yf.to(torch.int64), 0, h - 1)
    rb = torch.clamp(rows + yf.to(torch.int64) + 1, 0, h - 1)
    v = ((1 - ay) * planes.gather(1, ra.expand(C, h, w))
         + ay * planes.gather(1, rb.expand(C, h, w)))
    ca = torch.clamp(cols + xf.to(torch.int64), 0, w - 1)
    cb = torch.clamp(cols + xf.to(torch.int64) + 1, 0, w - 1)
    return ((1 - ax) * v.gather(2, ca.expand(C, h, w))
            + ax * v.gather(2, cb.expand(C, h, w)))


def sample_flow(flow: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample (H, W, 2) flow at (K, 2) (x, y) points -> (K, 2). Queries are
    clipped just inside the last pixel (w - 1.001), as the oracle does."""
    h, w = flow.shape[0], flow.shape[1]
    x = torch.clamp(pts[:, 0], 0.0, w - 1.001)
    y = torch.clamp(pts[:, 1], 0.0, h - 1.001)
    return bilinear_sample(flow.movedim(-1, 0), x, y).T


def sample_flow_with_grad(flow: torch.Tensor, pts: torch.Tensor):
    """Flow samples at (K, 2) points and the flow's spatial Jacobian
    there, jac[:, i, j] = d flow_i / d p_j: central differences of the
    (H, W, 2) field (borders zeroed where the roll wraps), bilinearly
    sampled like the flow itself. Returns (vals (K, 2), jac (K, 2, 2))."""
    h, w = flow.shape[0], flow.shape[1]
    f = flow.movedim(-1, 0)
    dx = (torch.roll(f, -1, dims=2) - torch.roll(f, 1, dims=2)) * 0.5
    dy = (torch.roll(f, -1, dims=1) - torch.roll(f, 1, dims=1)) * 0.5
    dx[:, :, 0] = 0
    dx[:, :, -1] = 0
    dy[:, 0, :] = 0
    dy[:, -1, :] = 0
    x = torch.clamp(pts[:, 0], 0.0, w - 1.001)
    y = torch.clamp(pts[:, 1], 0.0, h - 1.001)
    vals = bilinear_sample(f, x, y).T
    jac = torch.stack([bilinear_sample(dx, x, y).T,
                       bilinear_sample(dy, x, y).T], dim=-1)
    return vals, jac


def bilinear_sample_rows(planes: torch.Tensor, h: int, w: int,
                         x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of C row-stacked planes, `planes` (H*W, C) (each
    plane flattened row-major, stacked on the last axis), at float coords
    x, y of one query shape -> (*query_shape, C). Border: clamp."""
    c = planes.shape[-1]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x), 0, w - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, h - 2).to(torch.int64)
    fx = (x - x0.to(torch.float32))[..., None]
    fy = (y - y0.to(torch.float32))[..., None]
    base = y0 * w + x0

    def g(i):
        return planes[i.reshape(-1)].reshape(i.shape + (c,))

    return (g(base) * (1 - fx) * (1 - fy) + g(base + 1) * fx * (1 - fy)
            + g(base + w) * (1 - fx) * fy + g(base + w + 1) * fx * fy)


def warp_poly_planar(R1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Exact bilinear warp of (..., 5, h, w) planes by a (..., 2, h, w)
    flow (one leading pair dimension or none): the sample point is
    clamped to the image, its top-left corner to [0, w - 2] x [0, h - 2]
    (so the last column lerps with ax = 1). bf16 planes are promoted to
    f32 by the f32 weights."""
    h, w = R1.shape[-2], R1.shape[-1]
    dev = R1.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    fx = torch.clamp(xs + flow[..., 0, :, :], 0.0, w - 1.0)
    fy = torch.clamp(ys + flow[..., 1, :, :], 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(fx), 0, w - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(fy), 0, h - 2).to(torch.int64)
    ax = (fx - x0.to(torch.float32)).unsqueeze(-3)
    ay = (fy - y0.to(torch.float32)).unsqueeze(-3)
    flat = R1.flatten(-2)
    base = (y0 * w + x0).flatten(-2).unsqueeze(-2).expand(flat.shape)

    def corner(offset):
        i = base if offset == 0 else base + offset
        return flat.gather(-1, i).unflatten(-1, (h, w))

    return (corner(0) * (1 - ax) * (1 - ay) + corner(1) * ax * (1 - ay)
            + corner(w) * (1 - ax) * ay + corner(w + 1) * ax * ay)
