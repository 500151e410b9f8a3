"""K10 wrapper: the pyrLK Scharr derivatives gx, gy of every level of a
pyramid, in one launch (csrc/scharr.cu).

Replaces kalman_hydra_tpu/kernels/scharr_pallas.py::scharr_gradients,
which runs once per level: (H, W) f32 -> (gx, gy), each (H, W) f32, with
gx = smooth_y(edge_x f), gy = edge_y(smooth_x f), edge [-1, 0, 1],
smooth [3, 10, 3] / 32 and a replicate border (cv2's pyrLK derivative
convention).

`scharr_gradients_levels(pyr)` returns ((gx, gy), ...) for up to
MAX_LEVELS levels; `scharr_gradients(img)` is its one-level call. CPU
tensors take `scharr_gradients_plain` per level (two correlate1d passes
per gradient, as ops/lk.py::scharr_gradients in the reference); CUDA
tensors launch the kernel, or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build
from ..ops.filters import correlate1d

SCHARR_EDGE = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
SCHARR_SMOOTH = np.array([3.0, 10.0, 3.0], dtype=np.float32) / 32.0
MAX_LEVELS = 8             # the kernel's by-value level table
TILE_H, TILE_W = 16, 128   # csrc/scharr.cu's tile


def scharr_gradients_plain(img: torch.Tensor):
    gx = correlate1d(correlate1d(img, SCHARR_EDGE, dim=-1,
                                 border="replicate"),
                     SCHARR_SMOOTH, dim=-2, border="replicate")
    gy = correlate1d(correlate1d(img, SCHARR_EDGE, dim=-2,
                                 border="replicate"),
                     SCHARR_SMOOTH, dim=-1, border="replicate")
    return gx, gy


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ScharrPlan(NamedTuple):
    offsets: Tuple[Tuple[int, int], ...]   # float offsets of each (gx, gy)
    size: int                  # floats in the shared output buffer
    tiles: int                 # blocks of the launch
    table: object              # ctypes int array, 5 per level


@functools.lru_cache(maxsize=256)
def scharr_plan(shapes: Tuple[Tuple[int, int], ...],
                aligned: Tuple[bool, ...]) -> ScharrPlan:
    """The launch plan of one K10 launch over levels of these (h, w)
    shapes: each level's gx and gy planes in one buffer (each plane a
    multiple of 4 floats, so 16-byte aligned), and the kernel's table:
    per level h, w, tiles_x, first tile, vec (16-byte loads and stores:
    w % 4 == 0 and an `aligned` level)."""
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"scharr_gradients_levels: {len(shapes)} levels; "
                         f"the kernel takes 1..{MAX_LEVELS}")
    offsets, table = [], []
    off = tiles = 0
    for (h, w), al in zip(shapes, aligned):
        if h < 1 or w < 1:
            raise ValueError(f"scharr_gradients_levels: empty level {h}x{w}")
        tx = _cdiv(w, TILE_W)
        table += [h, w, tx, tiles, int(w % 4 == 0 and al)]
        plane = _cdiv(h * w, 4) * 4
        offsets.append((off, off + plane))
        off += 2 * plane
        tiles += tx * _cdiv(h, TILE_H)
    return ScharrPlan(tuple(offsets), off, tiles,
                      (ctypes.c_int * len(table))(*table))


def scharr_gradients_levels(pyr: Sequence[torch.Tensor]):
    """((gx, gy) of each level of `pyr`): one launch on the card for each
    MAX_LEVELS of them (an LK pyramid of more than 8 levels takes two)."""
    if not pyr or pyr[0].device.type == "cpu":
        return tuple(scharr_gradients_plain(a) for a in pyr)
    for i, a in enumerate(pyr):
        _build.require(a, f"pyr[{i}]", (torch.float32,), 2)
        if a.device != pyr[0].device:
            raise ValueError(f"pyr[{i}]: on {a.device}, pyr[0] on "
                             f"{pyr[0].device}")
    return _launches(pyr)


def _launches(pyr: Sequence[torch.Tensor]):
    """One `_launch` for each MAX_LEVELS of the checked levels."""
    return sum((_launch(pyr[i:i + MAX_LEVELS])
                for i in range(0, len(pyr), MAX_LEVELS)), ())


def _launch(pyr: Sequence[torch.Tensor]):
    """One kh_scharr_levels launch over at most MAX_LEVELS checked
    levels."""
    shapes = tuple((a.shape[0], a.shape[1]) for a in pyr)
    plan = scharr_plan(shapes, tuple(a.data_ptr() % 16 == 0 for a in pyr))
    buf = torch.empty(plan.size, dtype=torch.float32, device=pyr[0].device)
    base = buf.data_ptr()
    ptrs = []
    for a, (gx, gy) in zip(pyr, plan.offsets):
        ptrs += [a.data_ptr(), base + 4 * gx, base + 4 * gy]
    fn = _build.function("kh_scharr_levels", _build.I, _build.P, _build.P,
                         _build.I, _build.P)
    rc = fn(len(pyr), (ctypes.c_uint64 * len(ptrs))(*ptrs), plan.table,
            plan.tiles, _build.stream(pyr[0]))
    _build.check(rc, "kh_scharr_levels")
    scharr_gradients_levels.launches += 1
    return tuple((buf.as_strided(s, (s[1], 1), gx),
                  buf.as_strided(s, (s[1], 1), gy))
                 for s, (gx, gy) in zip(shapes, plan.offsets))


scharr_gradients_levels.launches = 0


def scharr_gradients(img: torch.Tensor):
    """(gx, gy) of one image: the one-level call of
    `scharr_gradients_levels`."""
    return scharr_gradients_levels((img,))[0]
