"""K9 wrapper: cv2.pyrDown chained over the levels of one f32 image's
pyramid, all levels in one launch (csrc/pyramid.cu).

Replaces kalman_hydra_tpu/kernels/pyramid_pallas.py::pyr_down, which runs
once per level: (H, W) f32 -> ((H + 1) // 2, (W + 1) // 2) f32, the
[1, 4, 6, 4, 1] / 16 separable blur with a REFLECT_101 border kept at
the even rows and columns. The kernel computes the reflected indices
itself; nothing is pre-padded.

`pyr_down_levels(img, n)` returns the n levels below img; `pyr_down(img)`
is its one-level call. CPU tensors take `pyr_down_levels_plain` (chained
`pyr_down_plain`: ops.filters.sep_filter2d, then every other row and
column, as ops/pyramid.py::pyr_down in the reference); CUDA tensors
launch the kernel, or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import _build
from ..ops.filters import sep_filter2d

PYR_TAPS = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0
LAUNCH_LEVELS = 4         # levels a launch takes (csrc/pyramid.cu)
# (tile_h, tile_w, threads) of the coarsest level's tile by levels in a
# launch, largest first: a launch takes the first with MIN_BLOCKS blocks,
# else the last. The tile's image region, 2^n (tile + 3) - 3 on a side,
# and level 1's vertical sums must fit a block's shared memory. Chosen by
# a sweep on an H100 at 1080p, 720p and 256 x 256 (numbers not kept).
TILES = {1: [(32, 64, 512), (16, 64, 256), (8, 64, 256)],
         2: [(16, 32, 512), (8, 16, 512)],
         3: [(8, 16, 512), (4, 4, 1024)],
         4: [(9, 8, 1024), (4, 8, 1024), (2, 2, 1024)]}
MIN_BLOCKS = 100
SMEM_LIMIT = 232448       # bytes of shared memory a block can have


def pyr_down_plain(img: torch.Tensor) -> torch.Tensor:
    return sep_filter2d(img, PYR_TAPS, PYR_TAPS,
                        border="reflect101")[..., ::2, ::2]


def pyr_down_levels_plain(img: torch.Tensor, n: int) -> List[torch.Tensor]:
    out = []
    for _ in range(n):
        img = pyr_down_plain(img)
        out.append(img)
    return out


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _padded(n: int) -> int:
    """Floats a plane takes in a shared buffer: a multiple of 4, so every
    plane starts 16-byte aligned."""
    return _cdiv(n, 4) * 4


class Launch(NamedTuple):
    src: int          # the level it reads (0: the image)
    levels: int       # the levels it writes, src + 1 .. src + levels
    tiles: int        # blocks
    threads: int      # threads a block
    smem: int         # bytes of dynamic shared memory a block takes
    table: object     # ctypes int array: tile_h, tile_w, tiles_x, tiles,
    #                   vec, a_floats, b_floats, threads, then h, w of
    #                   each level


class PyrPlan(NamedTuple):
    shapes: Tuple[Tuple[int, int], ...]   # (h, w) of levels 1..n
    offsets: Tuple[int, ...]               # each level's float offset
    size: int                              # floats in the shared buffer
    launches: Tuple[Launch, ...]           # one for n <= LAUNCH_LEVELS


def _launch(src: int, shapes, vec: bool) -> Launch:
    """One launch from level `src` writing the levels of `shapes`."""
    m = len(shapes)
    hn, wn = shapes[-1]
    for th, tw, threads in TILES[m]:          # largest first
        tiles_x = _cdiv(wn, tw)
        tiles = tiles_x * _cdiv(hn, th)
        if tiles >= MIN_BLOCKS:
            break
    rh0, rw0 = ((th + 3) << m) - 3, ((tw + 3) << m) - 3
    a = rh0 * ((rw0 + 6) // 4 * 4)           # staged rows x row stride
    b = (((th + 3) << (m - 1)) - 3) * rw0    # level 1's vertical sums
    table = [th, tw, tiles_x, tiles, int(vec), a, b, threads]
    for s in shapes:
        table += list(s)
    smem = 4 * (a + b + rh0)
    assert smem <= SMEM_LIMIT, (m, smem)
    return Launch(src, m, tiles, threads, smem,
                  (ctypes.c_int * len(table))(*table))


@functools.lru_cache(maxsize=256)
def pyr_plan(h: int, w: int, n: int, aligned: bool = True) -> PyrPlan:
    """The launch plan of n pyrDown levels of an (h, w) image: the level
    shapes, their place in one output buffer (each level 16-byte
    aligned) and the launches, each with its kernel table: one launch up
    to LAUNCH_LEVELS levels, the next from the last level it wrote.
    16-byte loads (`vec`) need a source width that is a multiple of 4
    and, for the image itself, an `aligned` pointer."""
    if n < 1:
        raise ValueError(f"pyr_down_levels: {n} levels; the wrapper takes "
                         f"1 or more")
    if h < 1 or w < 1:
        raise ValueError(f"pyr_down_levels: empty image {h}x{w}")
    shapes, offsets = [], []
    off = 0
    lh, lw = h, w
    for _ in range(n):
        lh, lw = (lh + 1) // 2, (lw + 1) // 2
        shapes.append((lh, lw))
        offsets.append(off)
        off += _padded(lh * lw)
    launches = []
    for src in range(0, n, LAUNCH_LEVELS):
        sh, sw = shapes[src - 1] if src else (h, w)
        launches.append(_launch(
            src, shapes[src:src + LAUNCH_LEVELS],
            sw % 4 == 0 and (aligned or src > 0)))
    return PyrPlan(tuple(shapes), tuple(offsets), off, tuple(launches))


def pyr_down_levels(img: torch.Tensor, n: int) -> List[torch.Tensor]:
    """The n pyrDown levels below img, [level 1, ..., level n]; one
    launch on the card for up to LAUNCH_LEVELS of them (a 5-level
    pyramid's four), one more for each LAUNCH_LEVELS beyond."""
    if img.device.type == "cpu" or n == 0:
        return pyr_down_levels_plain(img, n)
    _build.require(img, "img", (torch.float32,), 2)
    h, w = img.shape
    plan = pyr_plan(h, w, n, img.data_ptr() % 16 == 0)
    buf = torch.empty(plan.size, dtype=torch.float32, device=img.device)
    base = buf.data_ptr()
    fn = _build.function("kh_pyr_down_levels", _build.P, _build.I, _build.I,
                         _build.I, _build.P, _build.P, _build.P)
    stream = _build.stream(img)
    for ln in plan.launches:
        if ln.src:
            sh, sw = plan.shapes[ln.src - 1]
            sp = base + 4 * plan.offsets[ln.src - 1]
        else:
            sh, sw, sp = h, w, img.data_ptr()
        ptrs = (ctypes.c_uint64 * ln.levels)(
            *(base + 4 * o
              for o in plan.offsets[ln.src:ln.src + ln.levels]))
        rc = fn(sp, sh, sw, ln.levels, ptrs, ln.table, stream)
        _build.check(rc, "kh_pyr_down_levels")
        pyr_down_levels.launches += 1
    return [buf.as_strided(s, (s[1], 1), o)
            for s, o in zip(plan.shapes, plan.offsets)]


pyr_down_levels.launches = 0


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One pyrDown level: the one-level call of `pyr_down_levels`."""
    return pyr_down_levels(img, 1)[0]
