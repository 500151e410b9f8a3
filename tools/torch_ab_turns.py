#!/usr/bin/env python3
"""Frames/s of the port's paths A, B, AP, D, BX and H for two checkouts,
in turns.

    python3 tools/torch_ab_turns.py OLD_ROOT NEW_ROOT [--turns 4]

Each turn runs one process per checkout, in the order old, new, new, old
(then again): the process imports the port and chip_smoke.py from its
checkout (building that checkout's kernels there at first use), makes
the paths' clips and configurations with that chip_smoke.py, warms each
path up once and times 3 clips of each, through api.track_video. The
script prints every clip time, each checkout's median frames/s and range
per path, and the card's name and power limit. Needs one CUDA card."""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PATHS = ("A", "B", "AP", "D", "BX", "H")


def child(root: str) -> None:
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import torch
    spec = importlib.util.spec_from_file_location(
        "smoke", Path(root) / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from kalman_hydra_tpu_torch import api, pipeline
    dev = torch.device("cuda:0")
    cfgs = smoke.path_configs(pipeline)
    clip = smoke.blob_clip(smoke.T, smoke.H, smoke.W)
    clip_b = smoke.blob_clip(smoke.T_B, smoke.H_B, smoke.W_B)
    runs = {"A": (clip, cfgs["A"]), "B": (clip_b, cfgs["B"]),
            "AP": (clip, cfgs["AP"]), "D": (clip, cfgs["D"]),
            "BX": (clip_b, cfgs["BX"]), "H": (clip, cfgs["H"])}
    out = {}
    for name, (c, cfg) in runs.items():
        api.track_video(c, cfg, device=dev)          # build and warm up
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            api.track_video(c, cfg, device=dev)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out[name] = {"steps": len(c) - 1, "seconds": ts}
    print("RESULT " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.old)
        return 0
    roots = {"old": args.old, "new": args.new}
    fps = {k: {p: [] for p in PATHS} for k in roots}
    order = []
    for t in range(args.turns):
        order += ["old", "new"] if t % 2 == 0 else ["new", "old"]
    for label in order:
        res = subprocess.run([sys.executable, __file__, roots[label], "-",
                              "--child"], capture_output=True, text=True,
                             timeout=900)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if res.returncode != 0 or not line:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        for p, r in json.loads(line[0][len("RESULT "):]).items():
            fps[label][p] += [r["steps"] / s for s in r["seconds"]]
            print(f"{label} {p}: clip seconds "
                  f"{['%.4f' % s for s in r['seconds']]}", flush=True)
    for p in PATHS:
        print(f"path {p} frames/s, {len(order)} processes in turns "
              f"(medians, ranges): " + "; ".join(
                  f"{k} {statistics.median(v[p]):.2f} "
                  f"({min(v[p]):.2f}-{max(v[p]):.2f})"
                  for k, v in fps.items()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
