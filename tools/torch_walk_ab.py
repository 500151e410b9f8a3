#!/usr/bin/env python3
"""The polynomial expansion of a frame stack and of one frame (K7a, K3)
and the gated coarse levels of a Farneback frame pair (K5) as two
checkouts run them: device times, launches per call and output hashes,
in turns.

    python3 tools/torch_walk_ab.py OLD_ROOT NEW_ROOT [--turns 2]

Each turn runs one process per checkout, in the order old, new, new, old
(then again). The process imports the port from its checkout (building
that checkout's kernels there at first use) and NEW_ROOT's chip_smoke.py
for its inputs, hashes and timers. It runs the gated levels as the
checkout's ops/farneback.py does: where kernels/flow_level.py has no
`flow_levels` (the old form), one K5 launch a level with resize_linear
between them (chip_smoke.k5_route); otherwise the walk, one launch for
all of them. It times, on the device alone (chip_smoke.device_ms, the
calls replayed as one CUDA graph) and per call (CUDA events):
  * "k7a 1080p": 36 1080p frames (path C's 4 clips of 9), bf16 planes;
    "k7a 720p": path B's 17 720p frames;
  * "k3 bf16", "k3 f32": one 1080p frame (paths A and D);
  * "k5 1080p", "k5 720p": the gated levels (34x60 ... 270x480, 45x80
    ... 360x640) of frames 0 and 1 of chip_smoke's clips, bf16 planes,
    a zero prior, the resizes between them included (path A's step);
    "k5 1080p first k": the first k of the 1080p levels alone (device);
and lists the device kernels of one call of each under torch.profiler.
It hashes (sha256) the outputs on every case of NEW_ROOT's chip_smoke
K5_WITNESS, K7A_WITNESS and K7B_WITNESS (K3's) key forms. The script
prints every time, each checkout's medians, whether the two checkouts'
hashes agree, the old checkout's hashes as K5_WITNESS and K7A_WITNESS
tables, and the card's name and power limit. Needs one CUDA card."""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
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


def child(root: str, new_root: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch
    smoke = load_smoke(new_root)
    from kalman_hydra_tpu_torch import pipeline
    # the module, which the package's flow_level function hides
    kfl = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_level")
    from kalman_hydra_tpu_torch.kernels.polyexp import (
        poly_expansion_planar, poly_expansion_planar_batch)
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.farneback import polyexp_pyramid
    from kalman_hydra_tpu_torch.ops.pyramid import gaussian_blur_level
    new_form = hasattr(kfl, "flow_levels")
    walk = kfl.flow_levels if new_form else smoke.k5_route
    dev = torch.device("cuda:0")
    cfgs = smoke.path_configs(pipeline)
    f = cfgs["A"].flow
    n, s = f.poly_n, f.poly_sigma
    bf = torch.bfloat16
    out = {"new_form": new_form, "ms": {}, "hash": {}, "kernels": {}}

    def timed(name, fn, reps):
        fn()
        torch.cuda.synchronize()
        out["ms"][name] = smoke.cuda_ms(fn, reps)
        out["ms"][name + " dev"] = smoke.device_ms(fn, reps)[0]
        out["kernels"][name] = [(nm[:60], us) for nm, us
                                in smoke.device_launches(fn)]

    clip = smoke.blob_clip(smoke.T, smoke.H, smoke.W)
    clip_b = smoke.blob_clip(smoke.T_B, smoke.H_B, smoke.W_B)
    clips_c = np.stack([smoke.blob_clip(smoke.T, smoke.H, smoke.W, seed=i)
                        for i in range(smoke.N_CLIPS)])
    stack = clips_c.reshape((-1,) + clips_c.shape[2:])
    for label, frames in (("1080p", stack),
                          ("720p", clip_b)):
        img0 = gaussian_blur_level(
            grayscale_u8(torch.from_numpy(frames).to(dev)), f, k=0)
        timed(f"k7a {label}",
              lambda: poly_expansion_planar_batch(img0, n, s, bf), 3)
    del img0
    one = gaussian_blur_level(
        grayscale_u8(torch.from_numpy(clip[0]).to(dev)), f, k=0)
    timed("k3 bf16", lambda: poly_expansion_planar(one, n, s, bf), 20)
    timed("k3 f32", lambda: poly_expansion_planar(one, n, s), 20)

    for label, frames in (("1080p", clip), ("720p", clip_b)):
        pyrs = [polyexp_pyramid(grayscale_u8(torch.from_numpy(
            frames[i]).to(dev)), dataclasses.replace(f, bf16_poly=True))
            for i in (0, 1)]
        gated = [i for i, R in enumerate(pyrs[0])
                 if kfl.fits(R.shape[1], R.shape[2], 2)]
        R0s = [pyrs[0][i] for i in gated]
        R1s = [pyrs[1][i] for i in gated]
        fl0 = torch.zeros((2,) + tuple(R0s[0].shape[1:]), device=dev)
        timed(f"k5 {label}", lambda: walk(R0s, R1s, fl0, f.winsize,
                                          f.fast_warp, f.iterations, False,
                                          f.pyr_scale), 20)
        if label == "1080p":        # the walk over the first k levels
            for k in range(1, len(R0s)):
                fn = (lambda k=k: walk(R0s[:k], R1s[:k], fl0, f.winsize,
                                       f.fast_warp, f.iterations, False,
                                       f.pyr_scale))
                fn()
                torch.cuda.synchronize()
                out["ms"][f"k5 1080p first {k} dev"] = smoke.device_ms(
                    fn, 20)[0]

    for key in smoke.k5_witness_keys():
        out["hash"][key] = smoke.k5_witness_hash(key, dev, walk)
    for key in smoke.k7a_witness_keys():
        out["hash"][key] = smoke.k7a_witness_hash(key, dev)
    for key in smoke.k7b_witness_keys():
        if key.startswith("K3 "):
            out["hash"][key] = smoke.k7b_witness_hash(key, dev)
    print("RESULT " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--child", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.new)
        return 0
    roots = {"old": args.old, "new": args.new}
    ms = {k: {} for k in roots}
    hashes = {}
    order = []
    for t in range(args.turns):
        order += ["old", "new"] if t % 2 == 0 else ["new", "old"]
    for label in order:
        res = subprocess.run([sys.executable, __file__, args.old, args.new,
                              "--child", roots[label]],
                             capture_output=True, text=True, timeout=900)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if res.returncode != 0 or not line:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        r = json.loads(line[0][len("RESULT "):])
        print(f"{label} ({'new' if r['new_form'] else 'old'} form): "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["ms"].items()),
              flush=True)
        for k, evs in r["kernels"].items():
            print(f"{label} {k}: {len(evs)} device launches a call: "
                  + "; ".join(f"{nm} {us:.1f} us" for nm, us in evs),
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
    for name, pre in (("K5_WITNESS", "K5 "), ("K7A_WITNESS", "K7a "),
                      ("K3 of K7B_WITNESS", "K3 ")):
        tab = {k: v for k, v in hashes["old"].items() if k.startswith(pre)}
        print(f"{name} (old) = " + json.dumps(tab, indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if len(same) == len(keys) else 1


if __name__ == "__main__":
    sys.exit(main())
