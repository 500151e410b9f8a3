"""K5 wrappers: every Farneback iteration of every gated coarse level of a
frame pair in one launch, the flow's resize between them included
(csrc/flow_level.cu).

Replaces kalman_hydra_tpu/kernels/flow_level_pallas.py::flow_level, one
launch a level, and the resize glue between the gated levels
(ops/farneback.py). `flow_levels(R0s, R1s, flow, ...)`: per level (5, lh,
lw) unwarped polyexp planes (bf16 or f32), coarsest first, and the
coarsest level's (2, lh, lw) f32 prior -> the finest level's (2, lh, lw)
f32 flow, after `iters` K2 iterations a level with the flow resized
(cv2 INTER_LINEAR, ops/pyramid.py::resize_linear) and scaled by
1 / pyr_scale between levels: one launch for each MAX_LEVELS of them.
`flow_level` is its launch over one level and counts there.

`walk_fits(winsize)`: whether a walk's smallest tile holds the window
(winsize <= 99); a wider one runs K2's route on every level
(ops/farneback.py), which gives the same values.

`fits` is the port's gate, the counterpart of the reference's 12 MB VMEM
gate (`fits_vmem`): a level is admitted while the working set that the
first design (a cooperative grid with M in device memory) needed stayed
within half the H100's 50 MB L2. The gate and the dispatch that reads it
(ops/farneback.py) decide only where K5 runs, never what it computes:
above the gate the level runs `iters` K2 launches, which give the same
values.

`walk_plan` is the launch's plan (tiles, ticket ranges, reaches);
`walk_items` and `walk_waits` are the kernel's ticket order and wait set
in Python, for the tests.

CPU tensors take the plain versions (`iters` applications of
`flow_iter_plain` a level, `resize_linear` between); CUDA tensors launch
the kernel, or raise.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .flow_iter import (PLANE_DTYPES, SMEM_LIMIT, STATIC_SMEM,
                        _host_window, _sm_count, flow_iter_plain, pipe_items,
                        tile_smem)
from ..ops.pyramid import resize_coeffs, resize_coeffs_device, resize_linear

L2_BUDGET_BYTES = 25 * 2 ** 20
MAX_LEVELS = 8                # csrc/flow_level.cu::kMaxLevels
WALK_TILES = ((16, 32), (8, 16), (8, 8))   # csrc/flow_level.cu's shapes
BLOCKS_PER_SM = 3             # the kernel's __launch_bounds__


def working_set_bytes(lh: int, lw: int, itemsize: int) -> int:
    """Device bytes the first design touched per pass over a level: R0
    and R1 (5 planes each, plane dtype), the flow in, its ping-pong and
    out (2 f32 planes each), M and its vertical pass (5 f32 planes
    each). The gate's measure."""
    return lh * lw * (2 * 5 * itemsize + 3 * 2 * 4 + 2 * 5 * 4)


def fits(lh: int, lw: int, itemsize: int) -> bool:
    """True when a level of lh x lw with planes of `itemsize` bytes runs
    through K5 (4 of a 1080p frame's 6 levels, 34x60 to 270x480)."""
    return working_set_bytes(lh, lw, itemsize) <= L2_BUDGET_BYTES


class WalkLevel(NamedTuple):
    h: int
    w: int
    shape: int       # index into WALK_TILES
    th: int          # tile rows
    tw: int          # tile columns
    nb: int          # bands of tiles down the level
    nt: int          # tiles across it
    db: int          # bands on each side an item's flow reaches
    dt: int          # tiles on each side
    skew: int        # the level's ticket order (pipe_items)
    item0: int       # its first ticket
    prog0: int       # its first progress word


def _first_shape(winsize: int):
    """The largest WALK_TILES shape whose M fits one block, or None."""
    taps = 2 * (winsize // 2) + 1
    return next((i for i, (th, tw) in enumerate(WALK_TILES)
                 if tile_smem(th, tw, taps) + STATIC_SMEM <= SMEM_LIMIT),
                None)


def walk_fits(winsize: int) -> bool:
    """Whether the walk takes this window: some tile holds its M."""
    return _first_shape(winsize) is not None


def walk_plan(shapes: Sequence[Tuple[int, int]], winsize: int,
              max_disp: int, iters: int, sms: int = 132) -> List[WalkLevel]:
    """The walk's levels (shapes coarsest first): each cut into the
    smallest WALK_TILES shape of which one iteration's tiles fit the
    blocks `sms` SMs hold at once, the largest that fits one block's
    shared memory (16 x 32 up to winsize 81) where none does; an item of
    tile (b, t) reads the flow of bands b - db ... b + db (db = cdiv(bw,
    th)) and tiles t - dt ... t + dt (dt = cdiv(bw + max_disp + 1, tw));
    skew max(1, db, nb) orders a level's items iteration after iteration
    and keeps every wait on a smaller ticket. Tickets and progress words
    run level after level."""
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"walk over {len(shapes)} levels (1 ... "
                         f"{MAX_LEVELS})")
    taps = 2 * (winsize // 2) + 1
    first = _first_shape(winsize)
    if first is None or iters < 1 or max_disp < 0:
        raise ValueError(f"walk: winsize {winsize}, iters {iters}, "
                         f"max_disp {max_disp}")
    bw = taps // 2
    plan, item0, prog0 = [], 0, 0
    for h, w in shapes:
        if h < 1 or w < 1:
            raise ValueError(f"level {h}x{w} is empty")
        shape = next((i for i in range(len(WALK_TILES) - 1, first, -1)
                      if -(-h // WALK_TILES[i][0]) * -(-w // WALK_TILES[i][1])
                      <= BLOCKS_PER_SM * sms), first)
        th, tw = WALK_TILES[shape]
        nb, nt = -(-h // th), -(-w // tw)
        db = -(-bw // th)
        plan.append(WalkLevel(h, w, shape, th, tw, nb, nt, db,
                              -(-(bw + max_disp + 1) // tw), max(1, db, nb),
                              item0, prog0))
        item0 += iters * nb * nt
        prog0 += nb * nt
    return plan


def walk_smem(winsize: int) -> int:
    """Dynamic shared memory of one block (csrc/flow_level.cu): M on the
    largest WALK_TILES tile that fits (16 x 32 up to winsize 81) and its
    bw halo, 5 f32 planes at an odd row stride, as csrc/flow_tile.cuh
    lays them out."""
    th, tw = WALK_TILES[_first_shape(winsize)]
    return tile_smem(th, tw, 2 * (winsize // 2) + 1)


def walk_items(plan: Sequence[WalkLevel], iters: int) -> list:
    """The kernel's work items (l, j, b, t) in ticket order."""
    return [(l, j, b, t) for l, L in enumerate(plan)
            for (j, b, t) in pipe_items(iters, L.nb, L.nt, L.skew)]


def walk_waits(plan: Sequence[WalkLevel], l: int, j: int, b: int, t: int,
               iters: int, winsize: int, max_disp: int) -> list:
    """The items (l', j', b', t') item (l, j, b, t) waits for: iteration j
    - 1 on bands b - db ... b + db and tiles t - dt ... t + dt; at j = 0
    the last iteration of level l - 1 on the tiles the resize reads for
    the rows and columns of the tile's M (+- bw) and its warp (columns -
    max_disp ... + max_disp + 1)."""
    L = plan[l]
    if j > 0:
        return [(l, j - 1, bb, tt)
                for bb in range(max(0, b - L.db), min(L.nb - 1, b + L.db) + 1)
                for tt in range(max(0, t - L.dt), min(L.nt - 1, t + L.dt) + 1)]
    if l == 0:
        return []
    C, bw = plan[l - 1], winsize // 2
    y0, y1, _ = resize_coeffs(L.h, C.h)
    x0, x1, _ = resize_coeffs(L.w, C.w)
    r_lo, r_hi = max(0, b * L.th - bw), min(L.h - 1, b * L.th + L.th - 1 + bw)
    c_lo = max(0, t * L.tw - bw - max_disp)
    c_hi = min(L.w - 1, t * L.tw + L.tw + bw + max_disp)
    return [(l - 1, iters - 1, bb, tt)
            for bb in range(y0[r_lo] // C.th, y1[r_hi] // C.th + 1)
            for tt in range(x0[c_lo] // C.tw, x1[c_hi] // C.tw + 1)]


def flow_level_plain(R0, R1, flow, winsize: int, max_disp: int, iters: int,
                     gaussian: bool = False) -> torch.Tensor:
    for _ in range(iters):
        flow = flow_iter_plain(R0, R1, flow, winsize, max_disp, gaussian)
    return flow


def flow_levels_plain(R0s, R1s, flow, winsize: int, max_disp: int,
                      iters: int, gaussian: bool = False,
                      pyr_scale: float = 0.5) -> torch.Tensor:
    """The route K5's walk replaced: one level after another, the flow
    resized and scaled by 1 / pyr_scale between them."""
    for i, (R0, R1) in enumerate(zip(R0s, R1s)):
        if i:
            flow = resize_linear(flow, R0.shape[1], R0.shape[2]) * (
                1.0 / pyr_scale)
        flow = flow_level_plain(R0, R1, flow, winsize, max_disp, iters,
                                gaussian)
    return flow


def _check(R0s, R1s, flow, iters: int, what: str) -> None:
    if not R0s or len(R0s) != len(R1s):
        raise ValueError(f"{what}: {len(R0s)} R0 and {len(R1s)} R1 levels")
    for R0, R1 in zip(R0s, R1s):
        _build.require(R0, "R0", PLANE_DTYPES, 3)
        _build.require(R1, "R1", (R0s[0].dtype,), 3)
        if R0.dtype != R0s[0].dtype or R0.shape[0] != 5 or \
                R1.shape != R0.shape:
            raise ValueError(f"{what}: R0 {tuple(R0.shape)} {R0.dtype}, "
                             f"R1 {tuple(R1.shape)}")
    _build.require(flow, "flow", (torch.float32,), 3)
    if flow.shape != (2,) + tuple(R0s[0].shape[1:]):
        raise ValueError(f"{what}: flow {tuple(flow.shape)} for a "
                         f"{tuple(R0s[0].shape[1:])} level")
    if iters < 1:
        raise ValueError(f"{what}: iters={iters}")


def _launch(R0s, R1s, flow, winsize: int, max_disp: int, iters: int,
            gaussian: bool, pyr_scale: float) -> torch.Tensor:
    """kh_flow_levels over the levels, in walk_plan's order."""
    dev = R0s[0].device
    shapes = [tuple(R.shape[1:]) for R in R0s]
    plan = walk_plan(shapes, winsize, max_disp, iters, _sm_count(dev))
    wts, wts_dev, taps, post = _host_window(winsize, gaussian, dev)
    sizes = [2 * h * w for h, w in shapes]
    scratch = torch.empty(iters * sum(sizes) - sizes[-1],
                          dtype=torch.float32, device=dev)
    out = torch.empty((2,) + shapes[-1], dtype=torch.float32, device=dev)
    counters = torch.empty(1 + sum(L.nb * L.nt for L in plan),
                           dtype=torch.int32, device=dev)
    ptrs = np.zeros((len(plan), 9), np.uint64)
    dims = np.zeros((len(plan), 10), np.int32)
    off = 0
    for i, L in enumerate(plan):
        ptrs[i, :3] = (R0s[i].data_ptr(), R1s[i].data_ptr(),
                       scratch.data_ptr() + 4 * off)
        off += iters * sizes[i]
        if i:
            ptrs[i, 3:6] = [a.data_ptr() for a in resize_coeffs_device(
                L.h, plan[i - 1].h, dev)]
            ptrs[i, 6:] = [a.data_ptr() for a in resize_coeffs_device(
                L.w, plan[i - 1].w, dev)]
        dims[i] = (L.h, L.w, L.shape, L.nb, L.nt, L.db, L.dt, L.skew,
                   L.item0, L.prog0)
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.function("kh_flow_levels", I, P, P, I, P, I, P, P, I, F, I,
                         F, I, P, P, P)
    rc = fn(len(plan), ptrs.ctypes.data, dims.ctypes.data,
            int(R0s[0].dtype == torch.bfloat16), flow.data_ptr(),
            int(max_disp), wts, wts_dev, taps, post, int(iters),
            float(1.0 / pyr_scale), walk_smem(winsize), counters.data_ptr(),
            out.data_ptr(), _build.stream(R0s[0]))
    _build.check(rc, "kh_flow_levels")
    return out


def _walks(R0s, R1s, flow, winsize: int, max_disp: int, iters: int,
           gaussian: bool, pyr_scale: float) -> torch.Tensor:
    """One launch for each run of up to MAX_LEVELS levels (a pyr_scale
    near 1 gates more: 11 at 1080p and 0.8), the flow resized between
    runs as the kernel resizes it between its levels."""
    for i in range(0, len(R0s), MAX_LEVELS):
        if i:
            flow = resize_linear(flow, R0s[i].shape[1], R0s[i].shape[2]) * (
                1.0 / pyr_scale)
        flow = _launch(R0s[i:i + MAX_LEVELS], R1s[i:i + MAX_LEVELS], flow,
                       winsize, max_disp, iters, gaussian, pyr_scale)
        flow_levels.launches += 1
    return flow


def flow_levels(R0s, R1s, flow, winsize: int, max_disp: int, iters: int,
                gaussian: bool = False,
                pyr_scale: float = 0.5) -> torch.Tensor:
    """All `iters` iterations of every given level, coarsest first, the
    flow resized between them: (5, lh, lw) planes a level and the first
    level's (2, lh, lw) prior -> the last level's (2, lh, lw) flow."""
    if R0s[0].device.type == "cpu":
        return flow_levels_plain(R0s, R1s, flow, winsize, max_disp, iters,
                                 gaussian, pyr_scale)
    _check(R0s, R1s, flow, iters, "flow_levels")
    return _walks(R0s, R1s, flow, winsize, max_disp, iters, gaussian,
                  pyr_scale)


flow_levels.launches = 0


def flow_level(R0, R1, flow, winsize: int, max_disp: int, iters: int,
               gaussian: bool = False) -> torch.Tensor:
    """All `iters` iterations of one level, the walk's one-level launch:
    (5,h,w) x2 + (2,h,w) -> (2,h,w)."""
    if R0.device.type == "cpu":
        return flow_level_plain(R0, R1, flow, winsize, max_disp, iters,
                                gaussian)
    _check([R0], [R1], flow, iters, "flow_level")
    out = _launch([R0], [R1], flow, winsize, max_disp, iters, gaussian, 1.0)
    flow_level.launches += 1
    return out


flow_level.launches = 0
