"""Plain PyTorch reference of the tracked flow: grayscale, the Farneback
level images and polynomial-expansion pyramid, and Farneback's levels
and iterations with the select-sum warp (FlowConfig.fast_warp > 0).

The arithmetic is that of kalman_hydra_tpu_torch's plain versions (the
ones its CPU tests hold to the JAX package), copied here so that the
benchmark's yardstick does not move when the program does. It imports
nothing of the program. Every function takes `ct`, the dtype it
computes in: float32 for the reference, bfloat16 for the control (the
flow layer one precision below what the configuration states).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

F32 = torch.float32

# OpenCV getGaussianKernel's fixed small kernels for sigma <= 0
_SMALL_GAUSSIAN = {
    1: np.array([1.0], np.float64),
    3: np.array([0.25, 0.5, 0.25], np.float64),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float64),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125], np.float64),
}
# OpenCV's FarnebackUpdateMatrices border taper, by distance to the edge
_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)


def cv_round(x: float) -> int:
    return int(np.rint(x))


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel (float64 inside, float32 out)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].astype(np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    g = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def border_index(n: int, lo: int, hi: int, border: str) -> np.ndarray:
    """Source indices of the padded axis [-lo, n + hi)."""
    i = np.arange(-lo, n + hi)
    if border == "replicate":
        return np.clip(i, 0, n - 1)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n - 2                      # reflect101
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def pad1d(x: torch.Tensor, lo: int, hi: int, dim: int,
          border: str) -> torch.Tensor:
    dim = dim % x.ndim
    idx = torch.as_tensor(border_index(x.shape[dim], lo, hi, border),
                          device=x.device)
    return x.index_select(dim, idx)


def correlate1d(x: torch.Tensor, kernel, dim: int,
                border: str = "reflect101") -> torch.Tensor:
    """out[i] = sum_k kernel[k] * x[i + k - r], shifted adds."""
    kernel = np.asarray(kernel, dtype=np.float32)
    dim = dim % x.ndim
    r = len(kernel) // 2
    n = x.shape[dim]
    xp = pad1d(x, r, r, dim, border)
    out = None
    for k, wk in enumerate(kernel):
        term = float(wk) * xp.narrow(dim, k, n)
        out = term if out is None else out + term
    return out


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur, reflect101, separable."""
    k = gaussian_kernel(ksize, sigma)
    return correlate1d(correlate1d(x, k, -2), k, -1)


def box_filter(x: torch.Tensor, size: int, dim: int, border: str,
               normalize: bool = True) -> torch.Tensor:
    """Odd-size box along one dim: for size = 3a >= 9 a 3-tap sum, then a
    of those at stride 3; otherwise tap after tap."""
    dim = dim % x.ndim
    r = size // 2
    n = x.shape[dim]
    xp = pad1d(x, r, r, dim, border)
    if size >= 9 and size % 3 == 0:
        m = n + size - 3
        xp = xp.narrow(dim, 0, m) + xp.narrow(dim, 1, m) \
            + xp.narrow(dim, 2, m)
        taps = [xp.narrow(dim, 3 * j, n) for j in range(size // 3)]
    else:
        taps = [xp.narrow(dim, k, n) for k in range(size)]
    out = taps[0]
    for t in taps[1:]:
        out = out + t
    return out / size if normalize else out


def grayscale_u8(frame: torch.Tensor, ct=F32) -> torch.Tensor:
    """(..., H, W, 3) uint8 BGR -> (..., H, W) exact uint8 gray values
    (OpenCV's 15-bit fixed-point BT.601 weights)."""
    f = frame.to(torch.int32)
    y = (f[..., 0] * 3735 + f[..., 1] * 19235 + f[..., 2] * 9798
         + (1 << 14)) >> 15
    return y.to(ct)


# ------------------------------------------------------------ level images

def resize_coeffs(n_out: int, n_in: int):
    """cv2 INTER_LINEAR's half-pixel-centre clamped coefficients."""
    s = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.clip(np.floor(s), 0, n_in - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, np.clip(s - i0, 0.0, 1.0)


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(INTER_LINEAR) on the last two dims, in img's dtype."""
    h, w = img.shape[-2], img.shape[-1]
    dev, ct = img.device, img.dtype

    def coeffs(n_out, n_in):
        i0, i1, f = resize_coeffs(n_out, n_in)
        return (torch.as_tensor(i0.astype(np.int32), device=dev),
                torch.as_tensor(i1.astype(np.int32), device=dev),
                torch.as_tensor(f.astype(np.float32), device=dev).to(ct))

    y0, y1, fy = coeffs(out_h, h)
    x0, x1, fx = coeffs(out_w, w)
    fy = fy[:, None]
    rows = (img.index_select(-2, y0) * (1 - fy)
            + img.index_select(-2, y1) * fy)
    return (rows.index_select(-1, x0) * (1 - fx)
            + rows.index_select(-1, x1) * fx)


def farneback_levels(h: int, w: int, levels: int, pyr_scale: float):
    """cv2.calcOpticalFlowFarneback's level plan, coarsest first:
    [(k, lh, lw, sigma, ksize)] with its min_size 32 clamp."""
    k, scale = 0, 1.0
    while k < levels:
        scale *= pyr_scale
        if w * scale < 32 or h * scale < 32:
            break
        k += 1
    plan = []
    for k in range(k, -1, -1):
        scale = pyr_scale ** k
        sigma = (1.0 / scale - 1.0) * 0.5
        ksize = max(cv_round(sigma * 5) | 1, 3)
        plan.append((k, cv_round(h * scale), cv_round(w * scale), sigma,
                     ksize))
    return plan


# ------------------------------------------------- polynomial expansion

@lru_cache(maxsize=8)
def poly_taps(n: int, sigma: float):
    """(g, xg, xxg) taps (2n+1 each) and (ig11, ig03, ig33, ig55), the
    inverse Gram of {1, x, y, x^2, y^2, xy} under the separable Gaussian
    applicability (OpenCV FarnebackPrepareGaussian), as float32."""
    i = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(i * i) / (2.0 * sigma * sigma))
    g /= g.sum()
    G = np.zeros((6, 6), dtype=np.float64)
    for yk, wy in zip(i, g):
        for xk, wx in zip(i, g):
            w = wx * wy
            G[0, 0] += w
            G[1, 1] += w * xk * xk
            G[2, 2] += w * yk * yk
            G[3, 3] += w * xk ** 4
            G[4, 4] += w * yk ** 4
            G[5, 5] += w * xk * xk * yk * yk
            G[0, 3] += w * xk * xk
            G[0, 4] += w * yk * yk
            G[3, 4] += w * xk * xk * yk * yk
    G[3, 0], G[4, 0], G[4, 3] = G[0, 3], G[0, 4], G[3, 4]
    invG = np.linalg.inv(G)
    g32 = g.astype(np.float32)
    i32 = i.astype(np.float32)
    taps = (g32.tolist(), (i32 * g32).tolist(), (i32 * i32 * g32).tolist())
    inv = tuple(float(np.float32(invG[a, b]))
                for a, b in ((1, 1), (0, 3), (3, 3), (5, 5)))
    return taps, inv


def polyexp_valid(src: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(h + 2n, w + 2n) padded image -> (5, h, w) planes [b_x, b_y, a_xx,
    a_yy, a_xy], in src's dtype."""
    (g, xg, xxg), (ig11, ig03, ig33, ig55) = poly_taps(n, float(sigma))
    t = 2 * n + 1
    h, w = src.shape[-2] - 2 * n, src.shape[-1] - 2 * n
    v0 = v1 = v2 = None
    for k in range(t):
        row = src[..., k:k + h, :]
        v0 = g[k] * row if v0 is None else v0 + g[k] * row
        v1 = xg[k] * row if v1 is None else v1 + xg[k] * row
        v2 = xxg[k] * row if v2 is None else v2 + xxg[k] * row
    m = None
    for k in range(t):
        c0, c1, c2 = v0[..., k:k + w], v1[..., k:k + w], v2[..., k:k + w]
        terms = (g[k] * c0, xg[k] * c0, xxg[k] * c0, g[k] * c1,
                 xg[k] * c1, g[k] * c2)
        m = terms if m is None else tuple(a + b for a, b in zip(m, terms))
    m00, m10, m20, m01, m11, m02 = m
    return torch.stack([m10 * ig11, m01 * ig11, m00 * ig03 + m20 * ig33,
                        m00 * ig03 + m02 * ig33, m11 * ig55], dim=-3)


def polyexp_pyramid(gray: torch.Tensor, flow_cfg, plane_dtype,
                    ct=F32) -> list:
    """(H, W) gray -> per-level (5, lh, lw) planes, coarsest first: each
    coarse level GaussianBlur(original, reflect101) then resized, level 0
    the 3-tap blur; replicate-padded by n and expanded; stored in
    plane_dtype."""
    n, s = flow_cfg["poly_n"], flow_cfg["poly_sigma"]
    h, w = gray.shape
    img = gray.to(ct)
    out = []
    for (k, lh, lw, sigma, ksize) in farneback_levels(
            h, w, flow_cfg["levels"], flow_cfg["pyr_scale"]):
        lvl = gaussian_blur(img, ksize, sigma)
        if k > 0:
            lvl = resize_linear(lvl, lh, lw)
        lvl = pad1d(pad1d(lvl, n, n, -2, "replicate"), n, n, -1, "replicate")
        out.append(polyexp_valid(lvl, n, s).to(plane_dtype))
    return out


# ---------------------------------------------------------- flow levels

def warp_selectsum(planes: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                   max_disp: int) -> torch.Tensor:
    """The fast warp of (C, h, w) planes: displacement clamped to
    +-max_disp, a vertical lerp at each pixel's column, then a horizontal
    lerp of that at the shifted columns; edges replicated."""
    C, h, w = planes.shape
    D = float(max_disp)
    dev = planes.device
    dxc = torch.clamp(dx, -D, D)
    dyc = torch.clamp(dy, -D, D)
    xf, yf = torch.floor(dxc), torch.floor(dyc)
    ax, ay = dxc - xf, dyc - yf
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


def border_damp(h: int, w: int, device, ct=F32) -> torch.Tensor:
    def axis(n):
        i = np.arange(n)
        d = np.minimum(i, n - 1 - i)
        s = np.where(d < len(_BORDER_SCALE),
                     _BORDER_SCALE[np.minimum(d, len(_BORDER_SCALE) - 1)],
                     np.float32(1.0)).astype(np.float32)
        return torch.as_tensor(s, device=device)
    return (axis(h)[:, None] * axis(w)[None, :]).to(ct)


def window_weights(winsize: int, gaussian: bool):
    """(taps, post scale): the cv2 Gaussian window (sigma (winsize//2)
    0.3); a 3-divisible box as unit taps with (1/n)^2 after both passes;
    otherwise 1/n taps."""
    n = 2 * (winsize // 2) + 1
    if gaussian:
        return gaussian_kernel(n, (winsize // 2) * 0.3), 1.0
    if n % 3 == 0:
        inv = 1.0 / n
        return np.ones(n, np.float32), float(np.float32(inv * inv))
    return np.full(n, np.float32(1.0 / n), np.float32), 1.0


def flow_iter(R0, R1, flow, winsize: int, max_disp: int, gaussian: bool,
              ct=F32) -> torch.Tensor:
    """One Farneback iteration at one level: R1 warped by the prior flow,
    the damped normal equations M = (G11, G12, G22, h1, h2), the window
    over M with a replicate border, the 2x2 solve -> new (2, h, w) flow."""
    R0, R1 = R0.to(ct), R1.to(ct)
    _, h, w = R0.shape
    R1w = warp_selectsum(R1, flow[0], flow[1], max_disp)
    damp = border_damp(h, w, R0.device, ct)
    dx, dy = flow[0], flow[1]
    a_xx = (R0[2] + R1w[2]) * 0.5
    a_yy = (R0[3] + R1w[3]) * 0.5
    axy = (R0[4] + R1w[4]) * 0.25
    db_x = (R0[0] - R1w[0]) * 0.5 + a_xx * dx + axy * dy
    db_y = (R0[1] - R1w[1]) * 0.5 + axy * dx + a_yy * dy
    a_xx, a_yy, axy, db_x, db_y = (t * damp
                                   for t in (a_xx, a_yy, axy, db_x, db_y))
    M = torch.stack([a_xx * a_xx + axy * axy, (a_xx + a_yy) * axy,
                     a_yy * a_yy + axy * axy, a_xx * db_x + axy * db_y,
                     axy * db_x + a_yy * db_y])
    wts, post = window_weights(winsize, gaussian)
    bw = len(wts) // 2
    Mp = pad1d(M, bw, bw, 1, "replicate")
    Mv = sum(float(wk) * Mp[:, k:k + h, :] for k, wk in enumerate(wts))
    Mp = pad1d(Mv, bw, bw, 2, "replicate")
    g = sum(float(wk) * Mp[:, :, k:k + w] for k, wk in enumerate(wts))
    g11, g12, g22, h1, h2 = (g * post) if post != 1.0 else g
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g22 * h1 - g12 * h2) * idet,
                        (g11 * h2 - g12 * h1) * idet])


def farneback(pyr_a: list, pyr_b: list, flow_cfg, ct=F32) -> torch.Tensor:
    """Cold flow prev -> next from two polyexp pyramids, coarsest level
    first, the flow resized by 1/pyr_scale between levels -> (H, W, 2)
    float32."""
    if flow_cfg["fast_warp"] <= 0:
        raise ValueError("the reference covers fast_warp > 0 only")
    flow = None
    for R0, R1 in zip(pyr_a, pyr_b):
        lh, lw = R0.shape[1], R0.shape[2]
        if flow is None:
            flow = torch.zeros((2, lh, lw), dtype=ct, device=R0.device)
        else:
            flow = resize_linear(flow, lh, lw) * (1.0 / flow_cfg["pyr_scale"])
        for _ in range(flow_cfg["iterations"]):
            flow = flow_iter(R0, R1, flow, flow_cfg["winsize"],
                             flow_cfg["fast_warp"], flow_cfg["gaussian_win"],
                             ct)
    return flow.to(F32).movedim(0, -1)
