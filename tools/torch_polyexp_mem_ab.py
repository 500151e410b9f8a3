#!/usr/bin/env python3
"""The device-memory polyexp route (K3/K7a and K4/K7b past POLY_N_MAX)
as two checkouts run it: device times, per-call times, launches and
output hashes, in turns.

    python3 tools/torch_polyexp_mem_ab.py OLD_ROOT NEW_ROOT [--turns 2]

Each turn runs one process per checkout, in the order old, new, new, old
(then again). The process imports the port from its checkout (building
that checkout's kernels there at first use) and the chip_smoke.py beside
this script for its inputs, hashes and timers. On chip_smoke.py's F4
inputs (frames 0 and 1 of path A's 1080p clip, path A's levels and
pyr_scale; polyexp_mem_witness_inputs) at poly_n 53, 101 and 257 (F4's
poly_sigma) it times, on the device alone (chip_smoke.device_ms, the
calls replayed as one CUDA graph) and per call (CUDA events):
  * "K3 n": poly_expansion_planar of frame 0, f32;
  * "K4 n": coarse_polyexp_fused of frame 0, f32;
  * "K7a n": poly_expansion_planar_batch of both frames, bf16;
  * "K7b n": coarse_polyexp_fused_batch of both frames, bf16;
and at n = 101 counts the launches of one K4 call and of one api.flow
call (the wrappers' counters and the device kernels under
torch.profiler). It hashes (sha256) the outputs on every
POLYEXP_MEM_WITNESS key of chip_smoke.py. The script prints every time,
each checkout's medians, whether the two checkouts' hashes agree, the
old checkout's hashes as a POLYEXP_MEM_WITNESS table, and the card's
name and power limit. Witness tables are taken on one commit named as
both checkouts. Needs one CUDA card."""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
N_CASES = (53, 101, 257)


def load_smoke():
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def child(root: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    smoke = load_smoke()
    from kalman_hydra_tpu_torch import api, kernels
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_polyexp_fused, coarse_polyexp_fused_batch)
    from kalman_hydra_tpu_torch.kernels.polyexp import (
        poly_expansion_planar, poly_expansion_planar_batch)
    dev = torch.device("cuda:0")
    grays, f = smoke.polyexp_mem_witness_inputs(dev)
    g0, bf = grays[0], torch.bfloat16
    out = {"ms": {}, "hash": {}, "launches": {}, "kernels": {}}

    def timed(name, fn, reps):
        fn()
        torch.cuda.synchronize()
        out["ms"][name] = smoke.cuda_ms(fn, reps)
        out["ms"][name + " dev"] = smoke.device_ms(fn, reps)[0]

    for n in N_CASES:
        sg = dict(smoke.POLY_N_CASES)[n]
        args = (f.levels, f.pyr_scale, n, sg)
        reps = 4 if n > 101 else 10
        timed(f"K3 {n}", lambda: poly_expansion_planar(g0, n, sg), reps)
        timed(f"K4 {n}", lambda: coarse_polyexp_fused(g0, *args), reps)
        timed(f"K7a {n}", lambda: poly_expansion_planar_batch(
            grays, n, sg, bf), reps)
        timed(f"K7b {n}", lambda: coarse_polyexp_fused_batch(
            grays, *args, out_dtype=bf), reps)
    n, sg = 101, dict(smoke.POLY_N_CASES)[101]
    fl = dataclasses.replace(f, poly_n=n, poly_sigma=sg)
    frames = [g.cpu().numpy() for g in grays]
    for name, fn in (
            ("K4 101", lambda: coarse_polyexp_fused(g0, fl.levels,
                                                     fl.pyr_scale, n, sg)),
            ("api.flow 101", lambda: api.flow(frames[0], frames[1], fl,
                                              device=dev))):
        fn()
        torch.cuda.synchronize()
        kernels.reset_launches()
        fn()
        torch.cuda.synchronize()
        out["launches"][name] = {k: v for k, v
                                 in kernels.launch_counts().items() if v}
        out["kernels"][name] = [(nm[:60], us) for nm, us
                                in smoke.device_launches(fn)]
    for key in smoke.polyexp_mem_witness_keys():
        out["hash"][key] = smoke.polyexp_mem_witness_hash(key, grays, f)
    print("RESULT " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--child", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
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
        print(f"{label}: " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in r["ms"].items()),
              flush=True)
        for k, c in r["launches"].items():
            evs = r["kernels"][k]
            print(f"{label} {k}: launches {c}; {len(evs)} device kernels "
                  f"a call: " + "; ".join(f"{nm} {us:.1f} us"
                                          for nm, us in evs), flush=True)
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
    print("POLYEXP_MEM_WITNESS (old) = "
          + json.dumps(hashes["old"], indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if len(same) == len(keys) else 1


if __name__ == "__main__":
    sys.exit(main())
