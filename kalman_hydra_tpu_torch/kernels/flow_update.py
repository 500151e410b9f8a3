"""K8 wrapper: one exact-warp Farneback iteration, the bilinear gather
included (csrc/flow_update.cu).

Replaces the reference's `_warp_poly_planar` + Pallas `flow_update` pair
(kalman_hydra_tpu/ops/farneback.py:525-528;
kalman_hydra_tpu/kernels/flow_update_pallas.py::flow_update takes R1
already warped, the gather left to XLA): R0 and the UNWARPED R1
(5, h, w), both bf16 or both f32, the prior flow (2, h, w) f32 -> the new
absolute flow (2, h, w) f32. The kernel gathers R1 at (r + dy, c + dx),
clamped to the image, then runs the averaged normal equations with
OpenCV's border taper, the winsize window over M with a replicate border
and the 2x2 solve, in one launch. The window is K8's own: float32(1/n)
taps for the box (the TPU kernel does not factor it, unlike K2's
`window_weights`), the cv2 Gaussian otherwise, and no post-scale.

K8-pairs (`flow_update_pairs`) is the port's own pair variant: K8 over
B frame pairs of an (N, 5, h, w) plane stack in one launch (the pair
index in blockIdx.z, as K6 is K2's), for the pair-batched exact warp,
which the reference computes in plain XLA (ops/farneback.py:633-640,
update_matrices_p/update_flow_p vmapped over the pairs; no Pallas
kernel). Pair b reads frames p and p + 1 of the stack in place
(`pair_frames`), bf16 or f32. With round_m M is rounded to bf16 where
the reference's update_matrices_p stores it in the bf16 plane dtype.

The plain versions are the gather (`ops.warp.warp_poly_planar`) followed
by the plain iteration (`kernels.flow_iter.solve_warped`). CPU tensors
take them; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build
from .flow_iter import (PLANE_DTYPES, check_pairs, device_window,
                        mem_scratch, pair_frames, solve_warped, tile_plan)
from ..ops.filters import gaussian_kernel
from ..ops.warp import warp_poly_planar


@lru_cache(maxsize=16)
def update_weights(winsize: int, gaussian: bool) -> np.ndarray:
    """K8's window taps (f32): the cv2 Gaussian with sigma =
    (winsize//2) * 0.3, or a box of float32(1/n) taps."""
    bw = winsize // 2
    n = 2 * bw + 1
    if gaussian:
        return gaussian_kernel(n, bw * 0.3)
    return np.full(n, 1.0 / n, np.float64).astype(np.float32)


def flow_update_plain(R0, R1, flow, winsize: int,
                      gaussian: bool = False) -> torch.Tensor:
    return solve_warped(R0.to(torch.float32), warp_poly_planar(R1, flow),
                        flow, update_weights(winsize, bool(gaussian)), 1.0)


def _check(name: str, planes, flow, shapes_ok: bool) -> None:
    """Refuse, on either device, planes of mixed or other dtypes than
    bf16/f32, a flow that is not f32, shapes that do not match
    (`shapes_ok`, the caller's test) and a level under 2x2; on the card
    also tensors elsewhere or not contiguous."""
    dts = [t.dtype for t in planes]
    if dts[0] not in PLANE_DTYPES or any(d != dts[0] for d in dts) \
            or flow.dtype != torch.float32:
        raise TypeError(f"{name}: planes must be all bf16 or all f32 and "
                        f"the flow f32, got {dts} and {flow.dtype}")
    h, w = flow.shape[-2:]
    if not shapes_ok:
        shapes = [tuple(t.shape) for t in planes]
        raise ValueError(f"{name}: planes {shapes}, flow "
                         f"{tuple(flow.shape)}")
    if h < 2 or w < 2:
        raise ValueError(f"{name}: the exact gather needs a level of at "
                         f"least 2x2, got {h}x{w}")
    if flow.device.type != "cpu":
        for t in (*planes, flow):
            _build.require(t, name, (t.dtype,), t.ndim)


def _host_window(winsize: int, gaussian: bool, device=None):
    """(taps as a C float pointer, the taps' device copy as one past 61
    taps, else None, count): the kernel copies the taps into its launch
    parameters."""
    wts = update_weights(winsize, bool(gaussian))
    dw = device_window(wts, device)
    return (wts.ctypes.data, None if dw is None else dw.data_ptr(),
            wts.shape[0])


def _launch(R0, R1, flow, winsize: int, gaussian: bool) -> torch.Tensor:
    """kh_flow_update on one pair of checked planes, on tile_plan's tile
    or with M in device memory."""
    h, w = flow.shape[-2:]
    plan = tile_plan(h, w, winsize)
    wts, wts_dev, taps = _host_window(winsize, gaussian, R0.device)
    out = torch.empty((2, h, w), dtype=torch.float32, device=R0.device)
    scratch = mem_scratch(plan, 1, h, w, R0.device)
    P, I = _build.P, _build.I
    fn = _build.function("kh_flow_update", P, P, I, P, I, I, P, P, I, I, I,
                         P, P, P)
    rc = fn(R0.data_ptr(), R1.data_ptr(), int(R0.dtype == torch.bfloat16),
            flow.data_ptr(), h, w, wts, wts_dev, taps, plan.shape, plan.smem,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            _build.stream(R0))
    _build.check(rc, "kh_flow_update")
    return out


def flow_update(R0, R1, flow, winsize: int,
                gaussian: bool = False) -> torch.Tensor:
    """Gather + M + window + solve: (5,h,w) x2 + (2,h,w) -> (2,h,w)."""
    h, w = flow.shape[-2:]
    _check("flow_update", (R0, R1), flow,
           flow.shape == (2, h, w) and R0.shape == R1.shape == (5, h, w))
    if R0.device.type == "cpu":
        return flow_update_plain(R0, R1, flow, winsize, gaussian)
    out = _launch(R0, R1, flow, winsize, gaussian)
    flow_update.launches += 1
    return out


flow_update.launches = 0


def flow_update_pairs_plain(Rall, flow_b, winsize: int,
                            gaussian: bool = False, clip_len: int = 0,
                            round_m: bool = False) -> torch.Tensor:
    check_pairs(Rall.shape[0], flow_b.shape[0], clip_len)
    wts = update_weights(winsize, bool(gaussian))
    return torch.stack([
        solve_warped(Rall[p].to(torch.float32),
                     warp_poly_planar(Rall[p + 1], flow_b[b]), flow_b[b],
                     wts, 1.0, round_m)
        for b, p in enumerate(pair_frames(flow_b.shape[0], clip_len))])


def _launch_pairs(Rall, flow_b, winsize: int, gaussian: bool,
                  clip_len: int, round_m: bool) -> torch.Tensor:
    """kh_flow_update_pairs on a checked stack and its pairs' flows."""
    B, _, h, w = flow_b.shape
    plan = tile_plan(h, w, winsize)
    wts, wts_dev, taps = _host_window(winsize, gaussian, Rall.device)
    out = torch.empty((B, 2, h, w), dtype=torch.float32, device=Rall.device)
    scratch = mem_scratch(plan, B, h, w, Rall.device)
    P, I = _build.P, _build.I
    fn = _build.function("kh_flow_update_pairs", P, I, I, I, P, I, I, P, P,
                         I, I, I, I, P, P, P)
    rc = fn(Rall.data_ptr(), int(Rall.dtype == torch.bfloat16), B,
            max(clip_len - 1, 0), flow_b.data_ptr(), h, w, wts, wts_dev, taps,
            int(round_m), plan.shape, plan.smem,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            _build.stream(Rall))
    _build.check(rc, "kh_flow_update_pairs")
    return out


def flow_update_pairs(Rall, flow_b, winsize: int, gaussian: bool = False,
                      clip_len: int = 0,
                      round_m: bool = False) -> torch.Tensor:
    """K8 for every pair of an (N, 5, h, w) plane stack: flow_b
    (B, 2, h, w) f32 -> (B, 2, h, w)."""
    h, w = flow_b.shape[-2:]
    _check("flow_update_pairs", (Rall,), flow_b,
           flow_b.ndim == 4 and flow_b.shape[1] == 2 and Rall.ndim == 4
           and Rall.shape[1:] == (5, h, w))
    if Rall.device.type == "cpu":
        return flow_update_pairs_plain(Rall, flow_b, winsize, gaussian,
                                       clip_len, round_m)
    check_pairs(Rall.shape[0], flow_b.shape[0], clip_len)
    out = _launch_pairs(Rall, flow_b, winsize, gaussian, clip_len, round_m)
    flow_update_pairs.launches += 1
    return out


flow_update_pairs.launches = 0
