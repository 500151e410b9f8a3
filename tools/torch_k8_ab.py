#!/usr/bin/env python3
"""The exact-warp iteration as two checkouts' ops layers run it: device
times and output hashes of K8 and K8-pairs, in turns.

    python3 tools/torch_k8_ab.py OLD_ROOT NEW_ROOT [--turns 2] [--profile]

Each turn runs one process per checkout, in the order old, new, new, old
(then again). The process imports the port from its checkout (building
that checkout's kernels there at first use) and NEW_ROOT's chip_smoke.py
for its inputs and timers. It runs each iteration as that checkout's
ops/farneback.py does: where the checkout's K8 takes R1 already warped
(`flow_update(R0, R1w, flow, ...)`), the plain torch gather
`warp_poly_planar` and then K8 (and for K8-pairs an `index_select` of
each pair's second frame once a level); otherwise K8 alone, the gather
in the kernel. It times, on the device alone (chip_smoke.device_ms, the
calls replayed as one CUDA graph) and per call (CUDA events):
  * "k8": one frame pair of path D, the reference's RunConfig() (six
    1080p levels x 3 chained iterations, the f32 planes of frames 0 and
    1 of chip_smoke's clip), from a random +-2 px prior flow and from a
    zero one;
  * "k8 pairs": one level's 3 chained iterations of path BX's finest
    level (720p, 16 pairs of 17 frames, f32, +-2 px), per call;
and, in a checkout of the old form, the kernel alone on a gather made
beforehand and the gather alone, the split of the old route. It hashes
(sha256) the route's output on every case of NEW_ROOT's chip_smoke
K8_WITNESS key form (chip_smoke.k8_witness_case): K8 on witness_inputs
at 1080x1920, 540x960 and 37x53, f32 and bf16 planes, box and Gaussian;
K8-pairs with round_m on a bf16 stack of chained clips at 540x960 and
37x53. With --profile each process also profiles one warm run of paths
D (api.track_video(clip), RunConfig()) and BX (RunConfig(pair_batch=
True), B's clip) with chip_smoke.profile_path: device busy time,
launches a frame step, idle share and the top device operators. The
script prints every time (and each process's profile lines), each
checkout's medians, whether the two checkouts' hashes agree, the old
checkout's hashes as a K8_WITNESS table, and the card's name and power
limit. Needs one CUDA card."""

from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

WITNESS_KEYS = [f"K8 {s} {d} {w}" for s in ("1080x1920", "540x960", "37x53")
                for d in ("float32", "bfloat16") for w in ("box", "gauss")] \
    + [f"K8-pairs {s} bfloat16 {w}" for s in ("540x960", "37x53")
       for w in ("box", "gauss")]


def child(root: str, new_root: str, profile: bool) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    spec = importlib.util.spec_from_file_location(
        "smoke", Path(new_root).resolve() / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from kalman_hydra_tpu_torch.config import RunConfig
    from kalman_hydra_tpu_torch.kernels.flow_iter import pair_frames
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.farneback import (polyexp_pyramid,
                                                      polyexp_pyramid_batch)
    fu = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_update")
    old = "R1w" in inspect.signature(fu.flow_update).parameters
    if old:
        from kalman_hydra_tpu_torch.ops.farneback import warp_poly_planar
    dev = torch.device("cuda:0")
    f = RunConfig().flow
    ws, iters = f.winsize, f.iterations

    def level(R0, R1, fl, gw=False):
        """One level's iterations as ops.farneback runs them."""
        if old:
            R0f = R0.to(torch.float32)
            for _ in range(iters):
                fl = fu.flow_update(R0f, warp_poly_planar(R1, fl), fl, ws, gw)
            return fl
        for _ in range(iters):
            fl = fu.flow_update(R0, R1, fl, ws, gw)
        return fl

    def pairs_level(Rl, second, fl, clip_len=0, round_m=False, gw=False,
                    n=iters):
        if old:
            R1s = Rl.index_select(0, second)
            for _ in range(n):
                fl = fu.flow_update_pairs(Rl, warp_poly_planar(R1s, fl), fl,
                                          ws, gw, clip_len, round_m=round_m)
            return fl
        for _ in range(n):
            fl = fu.flow_update_pairs(Rl, fl, ws, gw, clip_len,
                                      round_m=round_m)
        return fl

    out = {"old_form": old, "ms": {}, "hash": {}}

    def timed(name, fn, reps):
        fn()
        torch.cuda.synchronize()
        out["ms"][name] = smoke.cuda_ms(fn, reps)
        out["ms"][name + " dev"] = smoke.device_ms(fn, reps)[0]

    clip = smoke.blob_clip(smoke.T, smoke.H, smoke.W)
    grays = [grayscale_u8(torch.from_numpy(clip[i]).to(dev)) for i in (0, 1)]
    pyrs = [polyexp_pyramid(g, f) for g in grays]
    g = torch.Generator().manual_seed(8)
    flows = [(torch.rand(2, *R0.shape[1:], generator=g) * 4 - 2).to(dev)
             for R0 in pyrs[0]]
    zeros = [torch.zeros_like(fl) for fl in flows]
    timed("k8", lambda: [level(a, b, fl) for a, b, fl
                         in zip(*pyrs, flows)], 5)
    timed("k8 zero", lambda: [level(a, b, fl) for a, b, fl
                              in zip(*pyrs, zeros)], 5)
    clip_b = smoke.blob_clip(smoke.T_B, smoke.H_B, smoke.W_B)
    Rall = polyexp_pyramid_batch(
        grayscale_u8(torch.from_numpy(clip_b).to(dev)), f)[-1]
    B = Rall.shape[0] - 1
    second = torch.as_tensor(pair_frames(B), device=dev) + 1
    flb = (torch.rand(B, 2, *Rall.shape[2:], generator=g) * 4 - 2).to(dev)
    timed("k8 pairs", lambda: pairs_level(Rall, second, flb), 3)
    out["ms"]["k8 pairs"] /= iters
    out["ms"]["k8 pairs dev"] /= iters
    if old:     # the old route's parts, on gathers made beforehand
        R1ws = [warp_poly_planar(b, fl) for b, fl in zip(pyrs[1], flows)]
        timed("k8 alone", lambda: [fu.flow_update(a, r, fl, ws)
                                   for _ in range(iters) for a, r, fl
                                   in zip(pyrs[0], R1ws, flows)], 5)
        timed("gather alone", lambda: [warp_poly_planar(b, fl)
                                       for _ in range(iters) for b, fl
                                       in zip(pyrs[1], flows)], 5)
        R1wb = warp_poly_planar(Rall.index_select(0, second), flb)
        timed("k8 pairs alone",
              lambda: fu.flow_update_pairs(Rall, R1wb, flb, ws), 5)
        timed("pairs gather alone", lambda: warp_poly_planar(
            Rall.index_select(0, second), flb), 5)
    for key in WITNESS_KEYS:
        kind, planes, fl, gw = smoke.k8_witness_case(key, dev)
        if kind == "K8" and old:
            a, b = planes
            res = fu.flow_update(a.float(), warp_poly_planar(b, fl), fl, ws,
                                 gw)
        elif kind == "K8":
            res = fu.flow_update(*planes, fl, ws, gw)
        else:
            sec = torch.as_tensor(pair_frames(fl.shape[0], 3),
                                  device=dev) + 1
            res = pairs_level(planes[0], sec, fl, 3, True, gw, n=1)
        out["hash"][key] = hashlib.sha256(
            res.cpu().numpy().tobytes()).hexdigest()
    if profile:
        from kalman_hydra_tpu_torch import api
        cfg_bx = RunConfig(pair_batch=True)
        runs = {"D": (lambda: api.track_video(clip, device=dev),
                      smoke.T - 1),
                "BX": (lambda: api.track_video(clip_b, cfg_bx, device=dev),
                       smoke.T_B - 1)}
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
                    help="also profile paths D and BX in each process")
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
        print(f"{label} ({'old' if r['old_form'] else 'new'} form): "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["ms"].items()),
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
    same = [k for k in WITNESS_KEYS if hashes["old"][k] == hashes["new"][k]]
    print(f"output hashes: {len(same)} of {len(WITNESS_KEYS)} cases the "
          f"same bytes in both checkouts; differ: "
          f"{[k for k in WITNESS_KEYS if k not in same]}")
    print("K8_WITNESS (old) = " + json.dumps(hashes["old"], indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if len(same) == len(WITNESS_KEYS) else 1


if __name__ == "__main__":
    sys.exit(main())
