"""K4 and K7b wrappers: coarse Farneback level images + polyexp of one
frame or of a frame stack, one launch for every coarse level; K11: the
level images alone (csrc/level_image.cu).

K4 replaces kalman_hydra_tpu/kernels/level_image_pallas.py::
coarse_polyexp_fused. For every coarse plan entry (k >= 1, coarsest
first) the level image is GaussianBlur(original, reflect101) composed
with the INTER_LINEAR resize, replicate-padded by n, and expanded into 5
polyexp planes. Returns a list of (5, lh, lw) arrays; level 0 is the
caller's business. K7b replaces ::coarse_polyexp_fused_batch: (N, H, W)
-> list of (N, 5, lh, lw), the same kernel with a frame index and one
set of tap tables for all frames, so it equals per-frame K4 bit for bit.

The composed weights are the reference's band matrices (_band_mats,
_band_mats_padded) stored sparsely: per output row (or column) the source
indices and float32 weights of its non-zeros, which the kernel reads as
(first index, count) runs (`first_count`). `fused_plan` chooses the
launch's tiles level by level, and for one frame splits the deepest
levels' tiles across the blocks of a cluster. CPU tensors take
`coarse_polyexp_fused_plain` (any leading dims, so it is K7b's plain
version too), which builds the level images stage by stage
(ops.pyramid.farneback_images: full-res blur, then resize) — an
independent route to the same values. CUDA tensors launch the kernel
once a call, or raise.

K11 (`coarse_level_images`) replaces ::farneback_images_pallas: the same
level images at padding 0 (the reference's unpadded _band_mats), with no
polyexp, each (lh, lw) f32, coarse levels only (level 0, the 3-tap blur,
stays plain torch as the reference leaves it to XLA): the same kernel,
planned at n = 0, storing its level tiles. Its plain version is
`coarse_level_images_plain`, the coarse entries of
ops.pyramid.farneback_images.

A launch takes at most MAX_LEVELS levels; a call with more (a pyr_scale
near 1: 15 coarse levels at 1080p, levels 16 and 0.8) makes one launch
for each run of MAX_LEVELS, and each wrapper counts every launch. Each
level is built from the source image alone, so the split changes no
byte. Any odd poly_n up to POLY_N_MAX runs in the one launch (n > 8 with
its taps in device memory and its tile rows widened to n). Past it, where
the level tile no longer fits half a block, K4/K7b take the
device-memory route (`level_route`, `_launch_mem`): K11's kernel builds
the level images of every frame, then K3/K7a's device-memory polyexp
(csrc/polyexp.cu::kh_polyexp_mem) expands every level in one call (two
kernel launches, the levels in a table); those launches count in
`mem_route`, not in the wrappers' own counters.
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _build
from . import polyexp
from .polyexp import (POLY_N_MAX, poly_taps, poly_taps_on,
                      polyexp_valid_plain)
from ..ops.filters import border_index, gaussian_kernel, pad1d
from ..ops.pyramid import farneback_images, farneback_levels, resize_coeffs


def _axis_matrix(n_out: int, n_in: int, ksize: int, sigma: float):
    """Dense (n_out, n_in) float64 blur(reflect101)+resize composition,
    built exactly as the reference's _band_mats.axis_mat."""
    g = gaussian_kernel(ksize, sigma).astype(np.float64)
    r = ksize // 2

    def blur_row(c: int) -> np.ndarray:
        row = np.zeros(n_in, np.float64)
        src = border_index(n_in, r, r, "reflect101")[c:c + ksize]
        np.add.at(row, src, g)
        return row

    M = np.zeros((n_out, n_in), np.float64)
    i0s, i1s, fs = resize_coeffs(n_out, n_in)
    for o in range(n_out):
        f = float(fs[o])
        M[o] += (1.0 - f) * blur_row(int(i0s[o]))
        if f > 0.0:
            M[o] += f * blur_row(int(i1s[o]))
    return M


def _tap_table(mat: np.ndarray):
    """Rows of a float32 band matrix -> (idx (rows, T) int32, wt (rows, T)
    f32) of its non-zeros, zero-weight padded to a common T."""
    nz = [np.flatnonzero(row) for row in mat]
    T = max(len(z) for z in nz)
    idx = np.zeros((mat.shape[0], T), np.int32)
    wt = np.zeros((mat.shape[0], T), np.float32)
    for o, z in enumerate(nz):
        idx[o, :len(z)] = z
        wt[o, :len(z)] = mat[o, z]
    return idx, wt


@lru_cache(maxsize=32)
def level_tables(h: int, w: int, levels: int, pyr_scale: float, n: int):
    """Per coarse plan entry (coarsest first): (lh, lw, iv, wv, ih, wh)
    where (iv, wv) map the n-padded level rows to image rows and (ih, wh)
    the n-padded level columns to image columns."""
    out = []
    for (k, lh, lw, sigma, ksize) in farneback_levels(h, w, levels,
                                                      pyr_scale):
        if k == 0:
            continue
        V = _axis_matrix(lh, h, ksize, sigma).astype(np.float32)
        Hm = _axis_matrix(lw, w, ksize, sigma).astype(np.float32)
        V = V[border_index(lh, n, n, "replicate")]
        Hm = Hm[border_index(lw, n, n, "replicate")]
        out.append((lh, lw, *_tap_table(V), *_tap_table(Hm)))
    return tuple(out)


def coarse_polyexp_fused_plain(img: torch.Tensor, levels: int,
                               pyr_scale: float, poly_n: int,
                               poly_sigma: float, out_dtype=torch.float32):
    n = poly_n
    outs = []
    for lvl in farneback_images(img, levels, pyr_scale)[:-1]:  # k >= 1
        lvl = pad1d(pad1d(lvl, n, n, -2, "replicate"), n, n, -1,
                    "replicate")
        outs.append(polyexp_valid_plain(lvl, n, poly_sigma).to(out_dtype))
    return outs


# The fused launch's geometry (csrc/level_image.cu::level_polyexp_kernel)
THREADS = 512          # threads a block
MAX_LEVELS = 12        # levels a launch (csrc/level_image.cu::kMaxLevels)
PE_TH = 16             # K3's tile body (polyexp.cuh): output rows a band
PE_N_BY_VALUE = 8      # kPeNMax: the taps and tile rows sized for n <= 8
TILE_H_MAX = 64          # output rows a tile, a multiple of PE_TH
TILE_W_MAX = 64          # output columns a tile (K3's body's width)
ROW_FLOATS = 4096        # the row buffers' budget
SLOTS = 132 * 2          # blocks running at once in the plan's model (the
#                          card holds three an SM; two plans one 1080p
#                          frame faster)
SMEM_MAX = 232448        # bytes of shared memory a block may take
SMEM_BUDGET = 72 * 1024  # a block's share when three fill an SM
GROUP_MIN = 2            # level rows a row-buffer pass takes at least
SPLIT_MAX = 8            # blocks that build one tile's rows (a cluster)


def pe_in_w(n: int) -> int:
    """The level tile's row stride in floats (polyexp.cuh::pe_in_w)."""
    return TILE_W_MAX + 2 * max(n, PE_N_BY_VALUE)


def pe_tap_stride(n: int) -> int:
    """The shared tap rows' stride (polyexp.cuh::pe_tap_stride)."""
    return 2 * max(n, PE_N_BY_VALUE) + 1


class FusedLevel(NamedTuple):
    """One coarse level of the fused launch: its sizes and table widths
    (tv, th taps), its tiles, the row-buffer group (level rows a pass),
    its shared memory in bytes, xs (each tile column's first source
    column and column span), split (the blocks that build one tile's
    level rows, each a share) and blocks (tiles x split, padded to whole
    clusters)."""
    lh: int
    lw: int
    ho: int
    wo: int
    tv: int
    th: int
    tile_h: int
    tile_w: int
    tiles_x: int
    tiles: int
    group: int
    smem: int
    xs: np.ndarray
    split: int
    blocks: int


class FusedPlan(NamedTuple):
    levels: Tuple[FusedLevel, ...]
    blocks: int       # blocks a frame, all levels
    smem: int         # bytes of dynamic shared memory a block
    cluster: int      # blocks a cluster: the largest split


def first_count(idx: np.ndarray, wt: np.ndarray):
    """A tap table's rows as (first index, count) of their non-zero taps,
    which must be contiguous (they are for every blur + resize band:
    the blur's reflected support and the resize's two neighbours join)."""
    cnt = (wt != 0).sum(1).astype(np.int32)
    first = idx[:, 0].astype(np.int32)
    for o, c in enumerate(cnt):
        if not np.array_equal(idx[o, :c], first[o] + np.arange(c)):
            raise ValueError(f"tap row {o} is not contiguous: {idx[o, :c]}")
    return np.stack([first, cnt], 1)


def _skew(x: int) -> int:
    return x + (x >> 5)


def _level_shape(lv, tile_h, tile_w, n):
    """(tiles_x, tiles, xs, group, smem bytes, the level rows' and the
    polyexp's multiply-adds a thread of one tile) of one level at one
    tile size."""
    lh, lw, fv, fh = lv["lh"], lv["lw"], lv["fv"], lv["fh"]
    ho, wo, tv, th = lh + 2 * n, lw + 2 * n, lv["tv"], lv["th"]
    tiles_x, tiles_y = -(-lw // tile_w), -(-lh // tile_h)
    xs = np.zeros((tiles_x, 2), np.int32)
    for tx in range(tiles_x):
        c0 = tx * tile_w
        f = fh[c0:min(c0 + tile_w + 2 * n, wo)]
        xs[tx] = (f[:, 0].min(), (f[:, 0] + f[:, 1]).max() - f[:, 0].min())
    span = int(xs[:, 1].max())
    stride = _skew(span - 1) + 1
    rows, cols = min(tile_h + 2 * n, ho), min(tile_w + 2 * n, wo)
    group = min(rows, max(GROUP_MIN, ROW_FLOATS // stride))
    in_w = pe_in_w(n)
    a = 2 * rows + 2 * cols + rows * tv + th * cols + group * stride
    b = 3 * PE_TH * in_w + 3 * pe_tap_stride(n)
    smem = 4 * ((tile_h + 2 * n) * in_w + max(a, b))
    rows_work = (rows * span * tv * 2 + rows * cols * th) / THREADS
    pe_work = (tile_h // PE_TH * (PE_TH * in_w * 3 + PE_TH * TILE_W_MAX
                                  * 6) * (2 * n + 1)) / THREADS
    return tiles_x, tiles_x * tiles_y, xs, group, smem, (rows_work, pe_work)


@lru_cache(maxsize=32)
def fused_plan(h: int, w: int, levels: int, pyr_scale: float, n: int,
               frames: int, split_max: int = 0) -> FusedPlan:
    """Tile sizes and splits of the fused launch, per coarse level (plan
    order, coarsest first). Each level starts at the largest tile
    (TILE_H_MAX rows, TILE_W_MAX columns, no more than the level needs)
    built by one block: the least work, since a tile recomputes its
    2n-row and 2n-column halo and its source columns' reach. While the
    longest block (the deepest levels' tiles read ~2.5 x 2^k source rows
    per level row) outlasts the call's whole work spread over SLOTS
    blocks, that level takes whichever shortens the estimate more: twice
    the blocks building each tile's rows (up to SPLIT_MAX, a cluster),
    or tiles halved, rows first. At one 1080p frame (K4) the deep levels
    split for latency; at 36 frames (K7b) they stay whole, one block a
    tile, for throughput. n = 0 plans K11's launch (the level images
    alone) with split_max IMG_SPLIT_MAX (else SPLIT_MAX). Raises where a
    level's smallest tile does not fit one block's shared memory
    (SMEM_MAX; the wrappers plan it only up to POLY_N_MAX, where no
    1080p or 720p level comes near it)."""
    split_max = split_max or SPLIT_MAX
    tabs = []
    for (lh, lw, iv, wv, ih, wh) in level_tables(h, w, levels,
                                                float(pyr_scale), n):
        tabs.append(dict(lh=lh, lw=lw, fv=first_count(iv, wv),
                         fh=first_count(ih, wh), tv=iv.shape[1],
                         th=ih.shape[1]))
    if not tabs:
        return FusedPlan((), 0, 0, 1)
    sizes = [[min(TILE_H_MAX, -(-t["lh"] // PE_TH) * PE_TH), TILE_W_MAX, 1]
             for t in tabs]

    def shape(i):
        return _level_shape(tabs[i], sizes[i][0], sizes[i][1], n)

    def longest(s, split):          # part 0: its rows' share, the polyexp
        rows_work, pe_work = s[5]
        return rows_work / split + pe_work

    def estimate(shapes):
        total = sum(frames * s[1] * sum(s[5]) for s in shapes)
        return max(total / SLOTS, max(longest(s, z[2])
                                      for s, z in zip(shapes, sizes)))

    for i in range(len(tabs)):     # every level within the smem budget
        while shape(i)[4] > SMEM_BUDGET and (sizes[i][0] > PE_TH
                                             or sizes[i][1] > 16):
            if sizes[i][0] > PE_TH:
                sizes[i][0] = max(PE_TH, sizes[i][0] // 2 // PE_TH * PE_TH)
            else:
                sizes[i][1] //= 2
    shapes = [shape(i) for i in range(len(tabs))]
    while True:
        est = estimate(shapes)
        i = max(range(len(shapes)),
                key=lambda j: longest(shapes[j], sizes[j][2]))
        th_, tw_, split = sizes[i]
        trials = []
        if split < split_max:
            trials.append([th_, tw_, split * 2])
        if th_ > PE_TH:
            trials.append([max(PE_TH, th_ // 2 // PE_TH * PE_TH), tw_, split])
        elif tw_ > 16:
            trials.append([th_, tw_ // 2, split])
        best = None
        for trial in trials:
            old = sizes[i]
            sizes[i] = trial
            new = shapes[:i] + [shape(i)] + shapes[i + 1:]
            e = estimate(new)
            sizes[i] = old
            if e < est and (best is None or e < best[0]):
                best = (e, trial, new)
        if best is None:
            break
        _, sizes[i], shapes = best
    for i, s_ in enumerate(shapes):
        if s_[4] > SMEM_MAX:
            raise ValueError(
                f"fused_plan: level {i} ({tabs[i]['lh']}x{tabs[i]['lw']}) "
                f"at poly_n {n} needs {s_[4]} B of shared memory a block, "
                f"more than {SMEM_MAX} B")
    cluster = max(z[2] for z in sizes)
    out, block0 = [], 0
    for t, (th_, tw_, split), s in zip(tabs, sizes, shapes):
        blocks = -(-s[1] * split // cluster) * cluster
        out.append(FusedLevel(t["lh"], t["lw"], t["lh"] + 2 * n,
                              t["lw"] + 2 * n, t["tv"], t["th"], th_, tw_,
                              s[0], s[1], s[3], s[4], s[2], split, blocks))
        block0 += blocks
    return FusedPlan(tuple(out), block0, max(lv.smem for lv in out),
                     cluster)


# K11 (the level images alone, n = 0) splits a tile's rows over at most
# 4 blocks, the split_max that timed fastest for one 1080p frame
# (tools/torch_k11_plans.py; PERF.md section 6).
IMG_SPLIT_MAX = 4


_fused_tables: dict = {}


def _fused_tables_on(device, h, w, levels, pyr_scale, n, plan):
    """Per plan level, on `device`: wv (ho, tv) f32, fv (ho, 2) int32,
    wht (th, wo) f32 (transposed), fh (wo, 2) int32, xs (tiles_x, 2)
    int32."""
    key = (str(device), h, w, levels, float(pyr_scale), n,
           tuple((lv.tile_h, lv.tile_w) for lv in plan.levels))
    tabs = _fused_tables.get(key)
    if tabs is None:
        tabs = []
        for lv, (lh, lw, iv, wv, ih, wh) in zip(
                plan.levels, level_tables(h, w, levels, float(pyr_scale),
                                          n)):
            arrs = (wv, first_count(iv, wv), np.ascontiguousarray(wh.T),
                    first_count(ih, wh), lv.xs)
            tabs.append(tuple(torch.as_tensor(np.ascontiguousarray(a),
                                              device=device) for a in arrs))
        _fused_tables[key] = tabs
    return tabs


_launch_plans: dict = {}


def _launch_plan(device, h, w, levels, pyr_scale, n, frames, split_max=0):
    """The plan of a call and, for each launch (a run of at most
    MAX_LEVELS levels), its level table: (plan, [(ptrs (levels, 6)
    uint64 with each level's output pointer still 0, dims (levels, 12)
    int32, blocks, first level)]), cached per device and shape: a call
    then only allocates its outputs and fills in their pointers. Each
    run's block0 counts from its first level (a multiple of the cluster,
    as every level's blocks are)."""
    key = (str(device), h, w, levels, float(pyr_scale), n, frames,
           split_max)
    hit = _launch_plans.get(key)
    if hit is not None:
        return hit
    plan = fused_plan(h, w, levels, float(pyr_scale), n, frames, split_max)
    tables = _fused_tables_on(device, h, w, levels, pyr_scale, n, plan)
    runs = []
    for r0 in range(0, len(plan.levels), MAX_LEVELS):
        ptrs, dims, block0 = [], [], 0
        for lv, tabs in zip(plan.levels[r0:r0 + MAX_LEVELS],
                            tables[r0:r0 + MAX_LEVELS]):
            ptrs.append([t.data_ptr() for t in tabs] + [0])
            dims.append([lv.lh, lv.lw, lv.ho, lv.wo, lv.tv, lv.th,
                         lv.tile_h, lv.tile_w, lv.tiles_x, block0, lv.group,
                         lv.split])
            block0 += lv.blocks
        runs.append((np.ascontiguousarray(ptrs, dtype=np.uint64),
                     np.ascontiguousarray(dims, dtype=np.int32), block0, r0))
    hit = _launch_plans[key] = (plan, runs)
    return hit


def _run_ptrs(template, outs, r0):
    """A launch's pointer table: the cached template (copied, so that
    concurrent calls never share one) with its levels' output pointers."""
    ptrs = template.copy()
    ptrs[:, 5] = [o.data_ptr() for o in outs[r0:r0 + len(ptrs)]]
    return ptrs


def level_route(n: int) -> str:
    """K4/K7b's route for an odd poly_n = n: "fused" (one launch, the
    level tile in shared memory, up to POLY_N_MAX) or "mem" (past it)."""
    if n < 1 or n % 2 == 0:
        raise ValueError(f"poly_n {n}: the kernel takes odd n >= 1")
    return "fused" if n <= POLY_N_MAX else "mem"


# launches of K4/K7b's device-memory route (K11's level images, then
# kh_polyexp_mem over the levels), past POLY_N_MAX
mem_route = SimpleNamespace(launches=0)


def _launch(imgs: torch.Tensor, levels: int, pyr_scale: float, n: int,
            poly_sigma: float, out_dtype):
    """kh_level_polyexp over a (N, H, W) f32 stack -> (list of
    (N, 5, lh, lw), coarsest first; launches made), or past POLY_N_MAX
    the device-memory route."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"coarse_polyexp_fused: out_dtype {out_dtype}")
    if level_route(n) == "mem":
        return _launch_mem(imgs, levels, pyr_scale, n, poly_sigma, out_dtype)
    N, h, w = imgs.shape
    dev = imgs.device
    plan, runs = _launch_plan(dev, h, w, levels, pyr_scale, n, N)
    outs = [torch.empty((N, 5, lv.lh, lv.lw), dtype=out_dtype, device=dev)
            for lv in plan.levels]
    if not outs:
        return outs, 0
    taps = poly_taps(n, float(poly_sigma))
    taps_dev = (poly_taps_on(dev, n, float(poly_sigma)).data_ptr()
                if n > PE_N_BY_VALUE else None)
    P, I = _build.P, _build.I
    fn = _build.function("kh_level_polyexp", P, I, I, I, I, P, P, P, P, I,
                         I, I, I, I, P)
    for tmpl, dims, blocks, r0 in runs:
        ptrs = _run_ptrs(tmpl, outs, r0)
        rc = fn(imgs.data_ptr(), N, h, w, len(dims), ptrs.ctypes.data,
                dims.ctypes.data, taps.ctypes.data, taps_dev, n,
                int(out_dtype == torch.bfloat16), blocks, plan.cluster,
                plan.smem, _build.stream(imgs))
        _build.check(rc, "kh_level_polyexp")
    return outs, len(runs)


def _launch_mem(imgs: torch.Tensor, levels: int, pyr_scale: float, n: int,
                poly_sigma: float, out_dtype):
    """K4/K7b past POLY_N_MAX: the coarse level images of every frame
    (K11's kernel, one launch a run of MAX_LEVELS levels), then
    kh_polyexp_mem over all of them (one call a run of
    polyexp.MEM_MAX_LEVELS levels, each call's scratch allocated here)
    -> (list of (N, 5, lh, lw), coarsest first; launches made). The level
    images are K4's level tiles at padding 0 and kh_polyexp_mem's clamped
    taps are the n-row replicate pad, so this is the plain version's
    arithmetic in its order."""
    lvls, runs = _launch_images(imgs, levels, pyr_scale)
    if not lvls:
        return lvls, runs
    outs, launches = polyexp._launch_mem_levels(lvls, n, poly_sigma,
                                                out_dtype)
    return outs, runs + launches


def _count(wrapper, n: int, launches: int) -> None:
    (mem_route if level_route(n) == "mem" else wrapper).launches += launches


def coarse_polyexp_fused(img: torch.Tensor, levels: int, pyr_scale: float,
                         poly_n: int, poly_sigma: float,
                         out_dtype=torch.float32):
    """(H, W) image -> list of (5, lh, lw) planes, coarse levels only."""
    if img.device.type == "cpu":
        return coarse_polyexp_fused_plain(img, levels, pyr_scale, poly_n,
                                          poly_sigma, out_dtype)
    _build.require(img, "img", (torch.float32,), 2)
    outs, launches = _launch(img[None], levels, pyr_scale, poly_n,
                             poly_sigma, out_dtype)
    _count(coarse_polyexp_fused, poly_n, launches)
    return [o[0] for o in outs]


coarse_polyexp_fused.launches = 0


def coarse_polyexp_fused_batch(imgs: torch.Tensor, levels: int,
                               pyr_scale: float, poly_n: int,
                               poly_sigma: float, out_dtype=torch.float32):
    """(N, H, W) frames -> list of (N, 5, lh, lw) planes, coarse levels
    only, one launch for all frames and every MAX_LEVELS levels."""
    if imgs.device.type == "cpu":
        return coarse_polyexp_fused_plain(imgs, levels, pyr_scale, poly_n,
                                          poly_sigma, out_dtype)
    _build.require(imgs, "imgs", (torch.float32,), 3)
    outs, launches = _launch(imgs, levels, pyr_scale, poly_n, poly_sigma,
                             out_dtype)
    _count(coarse_polyexp_fused_batch, poly_n, launches)
    return outs


coarse_polyexp_fused_batch.launches = 0


def coarse_level_images_plain(img: torch.Tensor, levels: int,
                              pyr_scale: float):
    return farneback_images(img, levels, pyr_scale)[:-1]      # k >= 1


def coarse_level_images(img: torch.Tensor, levels: int, pyr_scale: float):
    """(H, W) image -> list of (lh, lw) f32 level images, coarse levels
    only, coarsest first: one launch for every MAX_LEVELS levels."""
    if img.device.type == "cpu":
        return coarse_level_images_plain(img, levels, pyr_scale)
    _build.require(img, "img", (torch.float32,), 2)
    outs, launches = _launch_images(img, levels, pyr_scale)
    coarse_level_images.launches += launches
    return outs


def _launch_images(img: torch.Tensor, levels: int, pyr_scale: float):
    """kh_level_images on a checked (H, W) image, the fused plan at n = 0
    -> (list of (lh, lw), launches made); on a (N, H, W) stack
    kh_level_images_batch -> (list of (N, lh, lw), launches made)."""
    *lead, h, w = img.shape
    frames = lead[0] if lead else 1
    dev = img.device
    plan, runs = _launch_plan(dev, h, w, levels, pyr_scale, 0, frames,
                              IMG_SPLIT_MAX)
    outs = [torch.empty((*lead, lv.lh, lv.lw), dtype=torch.float32,
                        device=dev) for lv in plan.levels]
    P, I = _build.P, _build.I
    name = "kh_level_images_batch" if lead else "kh_level_images"
    fn = _build.function(name, P, *((I,) if lead else ()), I, I, I, P, P, I,
                         I, I, P)
    for tmpl, dims, blocks, r0 in runs:
        ptrs = _run_ptrs(tmpl, outs, r0)
        rc = fn(img.data_ptr(), *lead, h, w, len(dims), ptrs.ctypes.data,
                dims.ctypes.data, blocks, plan.cluster, plan.smem,
                _build.stream(img))
        _build.check(rc, name)
    return outs, len(runs)


coarse_level_images.launches = 0
