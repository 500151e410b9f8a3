#!/usr/bin/env python3
"""The coarse level images with their polyexp (K7b, K4) and sparse
Lucas-Kanade's frame step (K12) as two checkouts run them: device times,
launches per call and output hashes, in turns.

    python3 tools/torch_level_lk_ab.py OLD_ROOT NEW_ROOT [--turns 2]
                                       [--profile]

Each turn runs one process per checkout, in the order old, new, new, old
(then again). The process imports the port from its checkout (building
that checkout's kernels there at first use) and NEW_ROOT's chip_smoke.py
for its inputs, hashes and timers. It runs K7b and K4 through their
wrappers, and a frame step of sparse LK as the checkout's ops/lk.py does:
where kernels/lk.py has no `lk_sparse_levels` (the old form), one K12
launch a level with the torch glue between them (chip_smoke.lk_route);
otherwise the walk, one launch for all levels. It times, on the device
alone (chip_smoke.device_ms, the calls replayed as one CUDA graph) and
per call (CUDA events):
  * "k7b": 36 1080p frames (path C's 4 clips of 9), bf16 planes;
  * "k4": one 1080p frame, bf16 planes (paths A and D);
  * "k12 H", "k12 W", "k12 H0": one frame pair of chip_smoke's 1080p
    clip, 5 levels, at lk_block_halo 8 with K = 1024 (path H) and
    K = 256 (W), and at halo 0 with K = 256 (H0);
  * "k12 levels": path H's five one-level K12 calls alone, on arguments
    made beforehand;
and lists the device kernels of one call of each under torch.profiler
(name and microseconds: the old form's 15 launches of K4 split by level
and pass). It hashes (sha256) the outputs on every case of NEW_ROOT's
chip_smoke K7B_WITNESS and K12_WITNESS key forms. With --profile each
process also profiles one warm run of paths A, C, D and H with
chip_smoke.profile_path (device busy time, launches a frame step, idle
share, top device operators). The script prints every time, each
checkout's medians, whether the two checkouts' hashes agree, the old
checkout's hashes as K7B_WITNESS and K12_WITNESS tables, and the card's
name and power limit. Needs one CUDA card."""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path


def load_smoke(new_root: str):
    spec = importlib.util.spec_from_file_location(
        "smoke", Path(new_root).resolve() / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def child(root: str, new_root: str, profile: bool) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch
    smoke = load_smoke(new_root)
    from kalman_hydra_tpu_torch import pipeline
    from kalman_hydra_tpu_torch.kernels import lk as klk
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_polyexp_fused, coarse_polyexp_fused_batch)
    from kalman_hydra_tpu_torch.kernels.lk import lk_level
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.lk import lk_pyramid
    new_form = hasattr(klk, "lk_sparse_levels")
    dev = torch.device("cuda:0")
    cfgs = smoke.path_configs(pipeline)
    f = cfgs["A"].flow
    args = (f.levels, f.pyr_scale, f.poly_n, f.poly_sigma)
    bf = torch.bfloat16

    if new_form:
        def walk(pa, grads, pb, pts, c, guess):
            return klk.lk_sparse_levels(
                pa[:c.levels], pb[:c.levels], grads[:c.levels], pts,
                c.lk_winsize, c.lk_max_iter, c.lk_eps, c.lk_min_eig,
                c.lk_block_halo, guess=guess)
    else:
        walk = smoke.lk_route
    out = {"new_form": new_form, "ms": {}, "hash": {}, "kernels": {}}

    def timed(name, fn, reps):
        fn()
        torch.cuda.synchronize()
        out["ms"][name] = smoke.cuda_ms(fn, reps)
        out["ms"][name + " dev"] = smoke.device_ms(fn, reps)[0]
        out["kernels"][name] = [(nm[:60], us) for nm, us
                                in smoke.device_launches(fn)]

    clip = smoke.blob_clip(smoke.T, smoke.H, smoke.W)
    clips_c = np.stack([smoke.blob_clip(smoke.T, smoke.H, smoke.W, seed=s)
                        for s in range(smoke.N_CLIPS)])
    grays = grayscale_u8(torch.from_numpy(
        clips_c.reshape((-1,) + clips_c.shape[2:])).to(dev))
    gray = grays[0].contiguous()
    timed("k7b", lambda: coarse_polyexp_fused_batch(grays, *args,
                                                    out_dtype=bf), 3)
    timed("k4", lambda: coarse_polyexp_fused(gray, *args, out_dtype=bf), 20)
    del grays

    inputs = smoke.k12_witness_inputs(dev, clip)
    g0, g1, pts = inputs
    cfg_h = cfgs["H"].flow
    for label, halo, k in (("H", 8, smoke.K), ("W", 8, 256), ("H0", 0, 256)):
        c = dataclasses.replace(cfg_h, lk_block_halo=halo)
        pa, pb = lk_pyramid(g0, c), lk_pyramid(g1, c)
        p = pts[:k].contiguous()
        guess = p * (1.0 / 2 ** (c.levels - 1))
        timed(f"k12 {label}", lambda: walk(pa[0], pa[1], pb[0], p, c, guess),
              20)
    c = cfg_h
    pa, pb = lk_pyramid(g0, c), lk_pyramid(g1, c)
    guess = pts * (1.0 / 2 ** (c.levels - 1))
    calls = []
    for lvl in range(c.levels - 1, -1, -1):
        a = smoke.k12_level_args(pa[0][lvl], pb[0][lvl], *pa[1][lvl],
                                 pts * (1.0 / 2 ** lvl), guess, c)
        calls.append(a)
        got, _ = lk_level(*a)
        guess = (got - a[8]) * (2.0 if lvl else 1.0)
    timed("k12 levels", lambda: [lk_level(*a) for a in calls], 20)

    for key in smoke.k7b_witness_keys():
        out["hash"][key] = smoke.k7b_witness_hash(key, dev)
    for key in smoke.K12_KEYS:
        out["hash"][key] = smoke.k12_witness_hash(key, dev, inputs, cfgs["H"],
                                                  walk)
    if profile:
        from kalman_hydra_tpu_torch import api
        runs = {"A": (lambda: api.track_video(clip, cfgs["A"], device=dev),
                      smoke.T - 1),
                "C": (lambda: api.track_videos(clips_c, cfgs["C"],
                                               device=dev),
                      smoke.N_CLIPS * (smoke.T - 1)),
                "D": (lambda: api.track_video(clip, device=dev),
                      smoke.T - 1),
                "H": (lambda: api.track_video(clip, cfgs["H"], device=dev),
                      smoke.T - 1)}
        for label, (fn, steps) in runs.items():
            fn()
            torch.cuda.synchronize()
            clip_s = statistics.median(smoke.clip_seconds(fn))
            smoke.profile_path(label, fn, steps, os.devnull, clip_s)
    print("RESULT " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="also profile paths A, C, D and H in each process")
    ap.add_argument("--child", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.new, args.profile)
        return 0
    roots = {"old": args.old, "new": args.new}
    ms = {k: {} for k in roots}
    hashes = {}
    order = []
    for t in range(args.turns):
        order += ["old", "new"] if t % 2 == 0 else ["new", "old"]
    for label in order:
        res = subprocess.run([sys.executable, __file__, args.old, args.new,
                              "--child", roots[label]]
                             + ["--profile"] * args.profile,
                             capture_output=True, text=True, timeout=900)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if res.returncode != 0 or not line:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        r = json.loads(line[0][len("RESULT "):])
        if args.profile:
            print("\n".join(f"{label} | {ln}" for ln in res.stdout.splitlines()
                            if not ln.startswith("RESULT ")), flush=True)
        print(f"{label} ({'new' if r['new_form'] else 'old'} form): "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["ms"].items()),
              flush=True)
        for k, evs in r["kernels"].items():
            print(f"{label} {k}: {len(evs)} device launches a call: "
                  + "; ".join(f"{n} {us:.1f} us" for n, us in evs),
                  flush=True)
        for k, v in r["ms"].items():
            ms[label].setdefault(k, []).append(v)
        hashes.setdefault(label, r["hash"])
        if hashes[label] != r["hash"]:
            print(f"{label}: hashes differ between its runs")
            return 1
    for k in ms["old"]:
        print(f"{k} ms (medians of {args.turns} processes each): "
              + "; ".join(f"{lb} {statistics.median(v[k]):.4f}"
                          for lb, v in ms.items() if k in v))
    keys = list(hashes["old"])
    same = [k for k in keys if hashes["old"][k] == hashes["new"].get(k)]
    print(f"output hashes: {len(same)} of {len(keys)} cases the same bytes "
          f"in both checkouts; differ: {[k for k in keys if k not in same]}")
    for name, pre in (("K7B_WITNESS", "K"), ("K12_WITNESS", "K12 ")):
        tab = {k: v for k, v in hashes["old"].items()
               if (k.startswith("K12 ") == (pre == "K12 "))}
        print(f"{name} (old) = " + json.dumps(tab, indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if len(same) == len(keys) else 1


if __name__ == "__main__":
    sys.exit(main())
