"""K8 wrapper: one exact-warp Farneback iteration after the gather
(csrc/flow_update.cu).

Replaces kalman_hydra_tpu/kernels/flow_update_pallas.py::flow_update:
R0 and the already-warped R1w (5, h, w) f32, the prior flow (2, h, w) f32
-> the new absolute flow (2, h, w) f32. Averaged normal equations with
OpenCV's border taper, the winsize window over M with a replicate border,
2x2 solve. The window is K8's own: float32(1/n) taps for the box (the
TPU kernel does not factor it, unlike K2's `window_weights`), the cv2
Gaussian otherwise, and no post-scale. f32 only, as the TPU kernel is: a
caller with bf16 planes upcasts (ops/farneback.py does).

K8-pairs (`flow_update_pairs`) is the port's own pair variant: K8 over
B frame pairs in one launch (the pair index in blockIdx.z, as K6 is
K2's), for the pair-batched exact warp, which the reference computes in
plain XLA (ops/farneback.py:633-640, update_matrices_p/update_flow_p
vmapped over the pairs; no Pallas kernel). Pair b reads R0 at its first
frame of the (N, 5, h, w) plane stack (`pair_frames`), in bf16 or f32,
and its own warped R1w. With round_m M is rounded to bf16 where the
reference's update_matrices_p stores it in the bf16 plane dtype.

CPU tensors take `flow_update_plain` / `flow_update_pairs_plain`; CUDA
tensors launch the kernel, or raise.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build
from .flow_iter import (PLANE_DTYPES, check_pairs, pair_frames,
                        solve_warped)
from ..ops.filters import gaussian_kernel


@lru_cache(maxsize=16)
def update_weights(winsize: int, gaussian: bool) -> np.ndarray:
    """K8's window taps (f32): the cv2 Gaussian with sigma =
    (winsize//2) * 0.3, or a box of float32(1/n) taps."""
    bw = winsize // 2
    n = 2 * bw + 1
    if gaussian:
        return gaussian_kernel(n, bw * 0.3)
    return np.full(n, 1.0 / n, np.float64).astype(np.float32)


def flow_update_plain(R0, R1w, flow, winsize: int,
                      gaussian: bool = False) -> torch.Tensor:
    return solve_warped(R0, R1w, flow, update_weights(winsize,
                                                      bool(gaussian)), 1.0)


_device_weights: dict = {}


def _weights_on(device, winsize: int, gaussian: bool) -> torch.Tensor:
    key = (str(device), winsize, bool(gaussian))
    if key not in _device_weights:
        _device_weights[key] = torch.as_tensor(
            update_weights(winsize, bool(gaussian)), device=device)
    return _device_weights[key]


def flow_update(R0, R1w, flow, winsize: int,
                gaussian: bool = False) -> torch.Tensor:
    """Fused M + window + solve: (5,h,w) f32 x2 + (2,h,w) -> (2,h,w)."""
    if any(t.dtype != torch.float32 for t in (R0, R1w, flow)):
        raise TypeError("flow_update takes f32 planes and flow (upcast "
                        f"first): got {R0.dtype}, {R1w.dtype}, {flow.dtype}")
    if R0.device.type == "cpu":
        return flow_update_plain(R0, R1w, flow, winsize, gaussian)
    for t, name in ((R0, "R0"), (R1w, "R1w"), (flow, "flow")):
        _build.require(t, name, (torch.float32,), 3)
    _, h, w = R0.shape
    if R0.shape[0] != 5 or R1w.shape != R0.shape or flow.shape != (2, h, w):
        raise ValueError(f"flow_update: R0 {tuple(R0.shape)}, R1w "
                         f"{tuple(R1w.shape)}, flow {tuple(flow.shape)}")
    wts = _weights_on(R0.device, winsize, gaussian)
    M = torch.empty((5, h, w), dtype=torch.float32, device=R0.device)
    Mv = torch.empty_like(M)
    out = torch.empty((2, h, w), dtype=torch.float32, device=R0.device)
    P, I = _build.P, _build.I
    fn = _build.function("kh_flow_update", P, P, P, I, I, P, I, P, P, P, P)
    rc = fn(R0.data_ptr(), R1w.data_ptr(), flow.data_ptr(), h, w,
            wts.data_ptr(), wts.shape[0], M.data_ptr(), Mv.data_ptr(),
            out.data_ptr(), _build.stream(R0))
    _build.check(rc, "kh_flow_update")
    flow_update.launches += 1
    return out


flow_update.launches = 0


def flow_update_pairs_plain(Rall, R1w_b, flow_b, winsize: int,
                            gaussian: bool = False, clip_len: int = 0,
                            round_m: bool = False) -> torch.Tensor:
    check_pairs(Rall.shape[0], flow_b.shape[0], clip_len)
    wts = update_weights(winsize, bool(gaussian))
    return torch.stack([
        solve_warped(Rall[p].to(torch.float32), R1w_b[b], flow_b[b], wts,
                     1.0, round_m)
        for b, p in enumerate(pair_frames(flow_b.shape[0], clip_len))])


def flow_update_pairs(Rall, R1w_b, flow_b, winsize: int,
                      gaussian: bool = False, clip_len: int = 0,
                      round_m: bool = False) -> torch.Tensor:
    """K8 for every pair of an (N, 5, h, w) plane stack: R1w_b
    (B, 5, h, w) and flow_b (B, 2, h, w) f32 -> (B, 2, h, w)."""
    if Rall.device.type == "cpu":
        return flow_update_pairs_plain(Rall, R1w_b, flow_b, winsize,
                                       gaussian, clip_len, round_m)
    _build.require(Rall, "Rall", PLANE_DTYPES, 4)
    _build.require(R1w_b, "R1w_b", (torch.float32,), 4)
    _build.require(flow_b, "flow_b", (torch.float32,), 4)
    N, _, h, w = Rall.shape
    B = flow_b.shape[0]
    if (Rall.shape[1] != 5 or R1w_b.shape != (B, 5, h, w)
            or flow_b.shape != (B, 2, h, w)):
        raise ValueError(f"flow_update_pairs: Rall {tuple(Rall.shape)}, "
                         f"R1w_b {tuple(R1w_b.shape)}, flow_b "
                         f"{tuple(flow_b.shape)}")
    check_pairs(N, B, clip_len)
    wts = _weights_on(Rall.device, winsize, gaussian)
    M = torch.empty((B, 5, h, w), dtype=torch.float32, device=Rall.device)
    Mv = torch.empty_like(M)
    out = torch.empty((B, 2, h, w), dtype=torch.float32, device=Rall.device)
    P, I = _build.P, _build.I
    fn = _build.function("kh_flow_update_pairs", P, I, I, I, P, P, I, I, P,
                         I, I, P, P, P, P)
    rc = fn(Rall.data_ptr(), int(Rall.dtype == torch.bfloat16), B,
            max(clip_len - 1, 0), R1w_b.data_ptr(), flow_b.data_ptr(), h, w,
            wts.data_ptr(), wts.shape[0], int(round_m), M.data_ptr(),
            Mv.data_ptr(), out.data_ptr(), _build.stream(Rall))
    _build.check(rc, "kh_flow_update_pairs")
    flow_update_pairs.launches += 1
    return out


flow_update_pairs.launches = 0
