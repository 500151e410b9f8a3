#!/usr/bin/env python3
"""K11 (the coarse level images of one frame, one launch) under other
tile plans: its device time and output hash at 1080p and 720p.

    python3 tools/torch_k11_plans.py

The plans: kernels/level_image.py::fused_plan at n = 0 with each
split_max of 1, 2, 4 (the one the port takes, IMG_SPLIT_MAX) and 8, and
two per-level plans chosen by hand, each level its own (tile rows, tile
columns, blocks a tile's rows are split over), coarsest first. Each plan
is launched through kh_level_images as the wrapper launches it, timed on
the device alone (chip_smoke.device_ms: the calls replayed as one CUDA
graph) and held to chip_smoke.py's K11_WITNESS hash: a plan moves work
between blocks, never a byte. Prints one line a plan and the card's name
and power limit. Needs one CUDA card."""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kalman_hydra_tpu_torch.kernels import _build  # noqa: E402
from kalman_hydra_tpu_torch.kernels import level_image as li  # noqa: E402

KEYS = ("K11 1080x1920 L5 s0.5", "K11 720x1280 L5 s0.5")
HAND = {   # per level (tile_h, tile_w, split), coarsest first (1080p's 5)
    "hand A": [(8, 16, 4), (8, 16, 2), (8, 16, 1), (16, 32, 1), (32, 64, 1)],
    "hand B": [(8, 16, 2), (8, 16, 2), (8, 16, 1), (16, 32, 1), (16, 64, 1)],
}


def launcher(dev, key, sizes):
    """A kh_level_images call of the witness case `key` on per-level
    (tile_h, tile_w, split) `sizes`, and its outputs."""
    img, (levels, ps) = cs.k11_witness_case(key, dev)
    h, w = img.shape
    cluster = max(z[2] for z in sizes)
    keep, outs, ptrs, dims, block0, smem = [], [], [], [], 0, 0
    for (lh, lw, iv, wv, ih, wh), (th, tw, split) in zip(
            li.level_tables(h, w, levels, ps, 0), sizes):
        t = dict(lh=lh, lw=lw, fv=li.first_count(iv, wv),
                 fh=li.first_count(ih, wh), tv=iv.shape[1], th=ih.shape[1])
        tiles_x, tiles, xs, group, sm, _ = li._level_shape(t, th, tw, 0)
        tabs = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
                for a in (wv, t["fv"], wh.T, t["fh"], xs)]
        out = torch.empty((lh, lw), device=dev)
        keep += tabs
        outs.append(out)
        ptrs.append([a.data_ptr() for a in tabs] + [out.data_ptr()])
        dims.append([lh, lw, lh, lw, t["tv"], t["th"], th, tw, tiles_x,
                     block0, group, split])
        block0 += -(-tiles * split // cluster) * cluster
        smem = max(smem, sm)
    ptrs = np.ascontiguousarray(ptrs, np.uint64)
    dims = np.ascontiguousarray(dims, np.int32)
    P, I = _build.P, _build.I
    fn = _build.function("kh_level_images", P, I, I, I, P, P, I, I, I, P)

    def go():
        _build.check(fn(img.data_ptr(), h, w, len(dims), ptrs.ctypes.data,
                        dims.ctypes.data, block0, cluster, smem,
                        _build.stream(img)), "kh_level_images")
    go.keep = keep
    return go, outs


def main() -> int:
    dev = torch.device("cuda:0")
    plans = {}
    for split in (1, 2, 4, 8):
        plans[f"fused_plan split_max {split}"] = {
            key: [(lv.tile_h, lv.tile_w, lv.split) for lv in li.fused_plan(
                *map(int, key.split()[1].split("x")), 5, 0.5, 0, 1,
                split).levels] for key in KEYS}
    for name, sizes in HAND.items():
        plans[name] = {KEYS[0]: sizes, KEYS[1]: sizes[1:]}
    bad = 0
    for name, by_key in plans.items():
        line = []
        for key in KEYS:
            go, outs = launcher(dev, key, by_key[key])
            go()
            torch.cuda.synchronize()
            same = cs.tensors_hash(outs) == cs.K11_WITNESS[key]
            bad += not same
            line.append(f"{key.split()[1]} {cs.device_ms(go, 20)[0]:.4f} ms"
                        f"{'' if same else ' DIFFERENT bytes'}")
        print(f"{name}: " + ", ".join(line) + f"; tiles {by_key[KEYS[0]]}",
              flush=True)
    print(cs.card())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
