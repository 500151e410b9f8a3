"""K2, K6 and K13 wrappers: one fine-level Farneback iteration for one
frame pair (K2) or for B pairs of one frame stack (K6), csrc/flow_iter.cu;
all iterations of one level in one launch (K13), csrc/flow_iters_pipe.cu.

K2 replaces kalman_hydra_tpu/kernels/flow_iter_pallas.py::flow_iter:
R0, R1 (5, h, w) unwarped polyexp planes (bf16 or f32), flow (2, h, w)
f32 prior -> (2, h, w) f32 new absolute flow. Select-sum warp clamped to
+-max_disp (FlowConfig.fast_warp), averaged normal equations with the
OpenCV border taper, winsize window with a replicate border on M, 2x2
solve. Follows the TPU kernel's precision (flow and M in f32), not the
XLA twin's bf16 rounding of both.

K6 replaces flow_iter_pallas.py::flow_iter_pairs: Rall (N, 5, h, w),
flow_b (B, 2, h, w) -> (B, 2, h, w); pair b reads frames p and p + 1 of
Rall (`pair_frames`). Both wrappers launch the same CUDA kernels, so K6
equals per-pair K2 bit for bit. The planes go in unpadded: the kernels
clamp their indices where the TPU kernels read edge-padded slabs.

CPU tensors take `flow_iter_plain` / `flow_iter_pairs_plain` /
`flow_iters_pipelined_plain`; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build
from ..ops.filters import gaussian_kernel, pad1d
from ..ops.warp import warp_selectsum

PLANE_DTYPES = (torch.float32, torch.bfloat16)

# OpenCV's FarnebackUpdateMatrices border taper (ops/farneback.py in the
# reference), indexed by the distance to the nearest edge
_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472],
                         dtype=np.float32)


@lru_cache(maxsize=16)
def window_weights(winsize: int, gaussian: bool):
    """(taps f32, post_scale): the cv2 Gaussian window
    (sigma = (winsize//2) * 0.3); a 3-divisible uniform box as unit taps
    with (1/n)^2 applied after both passes (the TPU kernel's factored box);
    otherwise explicit 1/n taps."""
    n = 2 * (winsize // 2) + 1
    if gaussian:
        return gaussian_kernel(n, (winsize // 2) * 0.3), 1.0
    if n % 3 == 0:
        inv = 1.0 / n
        return np.ones(n, np.float32), float(np.float32(inv * inv))
    return np.full(n, np.float32(1.0 / n), np.float32), 1.0


def border_damp(h: int, w: int, device) -> torch.Tensor:
    """(h, w) f32 multiplicative taper of the normal equations."""
    def axis(n):
        i = np.arange(n)
        d = np.minimum(i, n - 1 - i)
        s = np.where(d < len(_BORDER_SCALE),
                     _BORDER_SCALE[np.minimum(d, len(_BORDER_SCALE) - 1)],
                     np.float32(1.0)).astype(np.float32)
        return torch.as_tensor(s, device=device)
    return axis(h)[:, None] * axis(w)[None, :]


def flow_iter_plain(R0, R1, flow, winsize: int, max_disp: int,
                    gaussian: bool = False) -> torch.Tensor:
    R1w = warp_selectsum(R1.to(torch.float32), flow[0], flow[1], max_disp)
    return solve_warped(R0.to(torch.float32), R1w, flow,
                        *window_weights(winsize, bool(gaussian)))


def solve_warped(R0, R1w, flow, wts, post: float,
                 round_m: bool = False) -> torch.Tensor:
    """Steps 2-4 of an iteration, given R1 already warped: the damped
    normal equations (rounded to bf16 with round_m, K8-pairs' bf16
    store), the window `wts` (then `post`) over M with a replicate
    border, the 2x2 solve. The plain arithmetic of K2 and K8."""
    _, h, w = R0.shape
    dx, dy = flow[0], flow[1]
    a_xx = (R0[2] + R1w[2]) * 0.5
    a_yy = (R0[3] + R1w[3]) * 0.5
    axy = (R0[4] + R1w[4]) * 0.25
    db_x = (R0[0] - R1w[0]) * 0.5 + a_xx * dx + axy * dy
    db_y = (R0[1] - R1w[1]) * 0.5 + axy * dx + a_yy * dy
    damp = border_damp(h, w, R0.device)
    a_xx, a_yy, axy, db_x, db_y = (t * damp
                                   for t in (a_xx, a_yy, axy, db_x, db_y))
    M = torch.stack([a_xx * a_xx + axy * axy, (a_xx + a_yy) * axy,
                     a_yy * a_yy + axy * axy, a_xx * db_x + axy * db_y,
                     axy * db_x + a_yy * db_y])
    if round_m:
        M = M.to(torch.bfloat16).to(torch.float32)
    bw = len(wts) // 2
    Mp = pad1d(M, bw, bw, 1, "replicate")
    Mv = sum(float(wk) * Mp[:, k:k + h, :] for k, wk in enumerate(wts))
    Mp = pad1d(Mv, bw, bw, 2, "replicate")
    g = sum(float(wk) * Mp[:, :, k:k + w] for k, wk in enumerate(wts))
    g11, g12, g22, h1, h2 = (g * post) if post != 1.0 else g
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g22 * h1 - g12 * h2) * idet,
                        (g11 * h2 - g12 * h1) * idet])


def pair_count(n_frames: int, clip_len: int = 0) -> int:
    """Frame pairs of an N-frame stack: N - 1, or (N // T) * (T - 1) when
    clip_len = T chains clips of T frames end to end."""
    if clip_len:
        return (n_frames // clip_len) * (clip_len - 1)
    return n_frames - 1


def pair_frames(pairs: int, clip_len: int = 0) -> list:
    """First frame p of each pair b: p = b + b // (T - 1) with
    clip_len = T, else p = b, so no pair straddles two clips."""
    if clip_len:
        return [b + b // (clip_len - 1) for b in range(pairs)]
    return list(range(pairs))


def check_pairs(n_frames: int, pairs: int, clip_len: int) -> None:
    """Refuse a pair count that does not match the stack, as the
    reference's flow_iter_pairs does."""
    if clip_len == 1 or clip_len < 0:
        raise ValueError(f"clip_len={clip_len}: must be 0 or >= 2")
    want = pair_count(n_frames, clip_len)
    if pairs != want:
        raise ValueError(f"clip_len={clip_len}: {n_frames} frames give "
                         f"{want} pairs, got {pairs}")


def flow_iter_pairs_plain(Rall, flow_b, winsize: int, max_disp: int,
                          gaussian: bool = False,
                          clip_len: int = 0) -> torch.Tensor:
    check_pairs(Rall.shape[0], flow_b.shape[0], clip_len)
    return torch.stack([
        flow_iter_plain(Rall[p], Rall[p + 1], flow_b[b], winsize, max_disp,
                        gaussian)
        for b, p in enumerate(pair_frames(flow_b.shape[0], clip_len))])


_device_weights: dict = {}


def device_window(device, winsize: int, gaussian: bool):
    """(window taps on `device`, post_scale), cached per device."""
    key = (str(device), winsize, bool(gaussian))
    if key not in _device_weights:
        wts, post = window_weights(winsize, bool(gaussian))
        _device_weights[key] = (torch.as_tensor(wts, device=device), post)
    return _device_weights[key]


def _launch(R0, R1, flow_b, ppc: int, winsize: int, max_disp: int,
            gaussian: bool) -> torch.Tensor:
    """kh_flow_iter over the pairs of flow_b (B, 2, h, w); pair b reads
    R0 and R1 offset by its first frame (see csrc/flow_iter.cu)."""
    B, _, h, w = flow_b.shape
    wts, post = device_window(R0.device, winsize, gaussian)
    M = torch.empty((B, 5, h, w), dtype=torch.float32, device=R0.device)
    Mv = torch.empty_like(M)
    out = torch.empty((B, 2, h, w), dtype=torch.float32, device=R0.device)
    P, I = _build.P, _build.I
    fn = _build.function("kh_flow_iter", P, P, I, I, I, P, I, I, I, P, I,
                         _build.F, P, P, P, P)
    rc = fn(R0.data_ptr(), R1.data_ptr(), int(R0.dtype == torch.bfloat16),
            B, ppc, flow_b.data_ptr(), h, w, int(max_disp), wts.data_ptr(),
            wts.shape[0], post, M.data_ptr(), Mv.data_ptr(), out.data_ptr(),
            _build.stream(R0))
    _build.check(rc, "kh_flow_iter")
    return out


def flow_iter(R0, R1, flow, winsize: int, max_disp: int,
              gaussian: bool = False) -> torch.Tensor:
    """One fused Farneback iteration: (5,h,w) x2 + (2,h,w) -> (2,h,w)."""
    if R0.device.type == "cpu":
        return flow_iter_plain(R0, R1, flow, winsize, max_disp, gaussian)
    _build.require(R0, "R0", PLANE_DTYPES, 3)
    _build.require(R1, "R1", (R0.dtype,), 3)
    _build.require(flow, "flow", (torch.float32,), 3)
    _, h, w = R0.shape
    if R0.shape[0] != 5 or R1.shape != R0.shape or flow.shape != (2, h, w):
        raise ValueError(f"flow_iter: R0 {tuple(R0.shape)}, R1 "
                         f"{tuple(R1.shape)}, flow {tuple(flow.shape)}")
    out = _launch(R0, R1, flow[None], 0, winsize, max_disp, gaussian)[0]
    flow_iter.launches += 1
    return out


flow_iter.launches = 0


def flow_iter_pairs(Rall, flow_b, winsize: int, max_disp: int,
                    gaussian: bool = False,
                    clip_len: int = 0) -> torch.Tensor:
    """One fused Farneback iteration for every pair of an (N, 5, h, w)
    plane stack: flow_b (B, 2, h, w) -> (B, 2, h, w)."""
    if Rall.device.type == "cpu":
        return flow_iter_pairs_plain(Rall, flow_b, winsize, max_disp,
                                     gaussian, clip_len)
    _build.require(Rall, "Rall", PLANE_DTYPES, 4)
    _build.require(flow_b, "flow_b", (torch.float32,), 4)
    N, _, h, w = Rall.shape
    if Rall.shape[1] != 5 or flow_b.shape[1:] != (2, h, w):
        raise ValueError(f"flow_iter_pairs: Rall {tuple(Rall.shape)}, "
                         f"flow_b {tuple(flow_b.shape)}")
    check_pairs(N, flow_b.shape[0], clip_len)
    out = _launch(Rall, Rall[1], flow_b, max(clip_len - 1, 0), winsize,
                  max_disp, gaussian)
    flow_iter_pairs.launches += 1
    return out


flow_iter_pairs.launches = 0


def band_rows(winsize: int) -> int:
    """K13's band height: 8 rows (the fastest of 7-32 at 1080p and
    540x960 on an H100, PERF.md), and never fewer than the window's half
    width (a band's M halo must lie in its two neighbours)."""
    return max(8, winsize // 2)


def flow_iters_pipelined_plain(R0, R1, flow, winsize: int, max_disp: int,
                               n_iters: int,
                               gaussian: bool = False) -> torch.Tensor:
    for _ in range(n_iters):
        flow = flow_iter_plain(R0, R1, flow, winsize, max_disp, gaussian)
    return flow


def flow_iters_pipelined(R0, R1, flow, winsize: int, max_disp: int,
                         n_iters: int,
                         gaussian: bool = False) -> torch.Tensor:
    """K13: all `n_iters` (>= 2) iterations of one level in one launch,
    (5,h,w) x2 + (2,h,w) -> (2,h,w); the same values as n_iters K2
    launches (csrc/flow_iters_pipe.cu)."""
    if n_iters < 2:
        raise ValueError("flow_iters_pipelined needs n_iters >= 2 "
                         "(use flow_iter for a single iteration)")
    if R0.device.type == "cpu":
        return flow_iters_pipelined_plain(R0, R1, flow, winsize, max_disp,
                                          n_iters, gaussian)
    _build.require(R0, "R0", PLANE_DTYPES, 3)
    _build.require(R1, "R1", (R0.dtype,), 3)
    _build.require(flow, "flow", (torch.float32,), 3)
    _, h, w = R0.shape
    if R0.shape[0] != 5 or R1.shape != R0.shape or flow.shape != (2, h, w):
        raise ValueError(f"flow_iters_pipelined: R0 {tuple(R0.shape)}, R1 "
                         f"{tuple(R1.shape)}, flow {tuple(flow.shape)}")
    wts, post = device_window(R0.device, winsize, gaussian)
    th = band_rows(winsize)
    dev = R0.device
    M = torch.empty((3, 5, h, w), dtype=torch.float32, device=dev)
    Mv = torch.empty((5, h, w), dtype=torch.float32, device=dev)
    inter = torch.empty((n_iters - 1, 2, h, w), dtype=torch.float32,
                        device=dev)
    out = torch.empty((2, h, w), dtype=torch.float32, device=dev)
    counters = torch.empty(-(-h // th) + 1, dtype=torch.int32, device=dev)
    P, I = _build.P, _build.I
    fn = _build.function("kh_flow_iters_pipe", P, P, I, P, I, I, I, P, I,
                         _build.F, I, I, P, P, P, P, P, P)
    rc = fn(R0.data_ptr(), R1.data_ptr(), int(R0.dtype == torch.bfloat16),
            flow.data_ptr(), h, w, int(max_disp), wts.data_ptr(),
            wts.shape[0], post, int(n_iters), th, M.data_ptr(),
            Mv.data_ptr(), inter.data_ptr(), out.data_ptr(),
            counters.data_ptr(), _build.stream(R0))
    _build.check(rc, "kh_flow_iters_pipe")
    flow_iters_pipelined.launches += 1
    return out


flow_iters_pipelined.launches = 0
