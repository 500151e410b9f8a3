#!/usr/bin/env python3
"""The coarse level images of one frame (K11) and the fused EKF step
(K1) as two checkouts run them: device times, launches per call and
output hashes, in turns.

    python3 tools/torch_k11_k1_ab.py OLD_ROOT NEW_ROOT [--turns 2]

Each turn runs one process per checkout, in the order old, new, new, old
(then again). The process imports the port from its checkout (building
that checkout's kernels there at first use) and the chip_smoke.py beside
this script for its inputs, hashes and timers. It times, on the device
alone (chip_smoke.device_ms, the calls replayed as one CUDA graph) and
per call (CUDA events):
  * "k11 1080p": coarse_level_images of one 1080p frame at path D2's
    levels 5, pyr_scale 0.5; "k11 720p" likewise;
  * "k1 1024x6": ekf_fused_step at K = 1024, n = 6, H (2, n) (path A's
    filter); "k1 256x4": K = 256, n = 4 (path D's);
and lists the device kernels of one call of each under torch.profiler.
It hashes (sha256) the outputs on every K11_WITNESS and K1_WITNESS key
of chip_smoke.py. The script prints every time, each checkout's medians,
whether the two checkouts' hashes agree, the old checkout's hashes as
K11_WITNESS and K1_WITNESS tables, and the card's name and power limit.
Witness tables are taken on one commit named as both checkouts. Needs
one CUDA card."""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


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
    from kalman_hydra_tpu_torch.kernels.ekf import ekf_fused_step
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_level_images)
    dev = torch.device("cuda:0")
    out = {"ms": {}, "hash": {}, "kernels": {}}

    def timed(name, fn, reps):
        fn()
        torch.cuda.synchronize()
        out["ms"][name] = smoke.cuda_ms(fn, reps)
        out["ms"][name + " dev"] = smoke.device_ms(fn, reps)[0]
        out["kernels"][name] = [(nm[:60], us) for nm, us
                                in smoke.device_launches(fn)]

    for label, key in (("1080p", "K11 1080x1920 L5 s0.5"),
                       ("720p", "K11 720x1280 L5 s0.5")):
        img, (lv, s) = smoke.k11_witness_case(key, dev)
        timed(f"k11 {label}", lambda: coarse_level_images(img, lv, s), 20)
    for label, key in (("1024x6", "K1 K=1024 n=6 H2"),
                       ("256x4", "K1 K=256 n=4 H2")):
        args = smoke.k1_witness_case(key, dev)
        timed(f"k1 {label}", lambda: ekf_fused_step(*args), 50)
    for key in smoke.k11_witness_keys():
        out["hash"][key] = smoke.k11_witness_hash(key, dev)
    for key in smoke.k1_witness_keys():
        out["hash"][key] = smoke.k1_witness_hash(key, dev)
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
    for name, pre in (("K11_WITNESS", "K11 "), ("K1_WITNESS", "K1 ")):
        tab = {k: v for k, v in hashes["old"].items() if k.startswith(pre)}
        print(f"{name} (old) = " + json.dumps(tab, indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if len(same) == len(keys) else 1


if __name__ == "__main__":
    sys.exit(main())
