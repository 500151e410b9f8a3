#!/usr/bin/env python3
"""Two checkouts' port in ONE process, call by call in turns, on the
footage and configurations of the benchmark's clip9 and batch4x9 cells.

    python3 tools/torch_lifecycle_ab.py OLD_ROOT [--pairs 30] [--seed N]

OLD_ROOT's kalman_hydra_tpu_torch is imported under another name
(`kh_old`: the package imports itself only relatively), its
`kernels._build` being this checkout's, so both programs launch from
one kernel library (two libraries built apart, each with its own static
CUDA runtime, were seen to refuse the second one's launches). So every
source under OLD_ROOT's csrc/ must be byte for byte this checkout's
(this checkout may add sources); the script checks that first. Both
get the same footage
(benchmark/traffic/blob.py's pool from the seed, in pageable host
memory, as the cells hold it) and the same RunConfig
(benchmark/configs/). Pair i runs both on pool item i (cycling), old
first in even pairs and new first in odd ones, each call timed on the
host clock up to its trajectories on the host, as the cells time them.
The script prints, for each cell, both checkouts' ms a frame step
(median and quartiles), the pairs in which the new one was faster,
whether both gave the same trajectories bit for bit on every item, and
the card's name and power limit. Needs one CUDA card."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
CELLS = {"clip9": ("farneback-1080p", "clip9"),
         "batch4x9": ("farneback-1080p-pairs", "batch4x9")}


def load_old(root: str):
    """OLD_ROOT's package as `kh_old`, on this checkout's kernel library:
    (api, config)."""
    from kalman_hydra_tpu_torch.kernels import _build
    pkg = Path(root).resolve() / "kalman_hydra_tpu_torch"
    differ = [p.name for p in sorted((pkg / "csrc").iterdir())
              if p.read_bytes() != (_build.CSRC / p.name).read_bytes()]
    if differ:
        raise SystemExit(f"csrc/ sources differ between the checkouts: "
                         f"{differ}; one kernel library cannot serve both")
    sys.modules["kh_old.kernels._build"] = _build
    spec = importlib.util.spec_from_file_location(
        "kh_old", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["kh_old"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("kh_old.api"),
            importlib.import_module("kh_old.config"))


def cell_inputs(cell: str, seed: int):
    """(run_config JSON, items, steps a call) of one cell: its pool of
    clips (one clip or a batch an item) as benchmark/lib/drivers.py makes
    it."""
    from benchmark.traffic import blob
    cname, tname = CELLS[cell]
    conf = json.loads((HERE / "benchmark" / "configs" /
                       f"{cname}.json").read_text())
    traf = json.loads((HERE / "benchmark" / "traffic" /
                       f"{tname}.json").read_text())
    fr = conf["frame"]
    pool = blob.clip_pool(seed, traf["clips"], traf["clip_len"],
                          fr["height"], fr["width"], traf["velocity"],
                          max(fr["height"], fr["width"])
                          * traf["blob_sigma_of_max_side"], "cuda")
    b = traf["batch"]
    items = (list(pool) if b == 1 else
             list(pool[:len(pool) // b * b].reshape(
                 (-1, b) + pool.shape[1:])))
    return json.dumps(conf["run_config"]), items, b * (traf["clip_len"] - 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("--pairs", type=int, default=30)
    ap.add_argument("--seed", type=int, default=4294971217)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch
    torch.set_num_threads(1)
    old_api, old_config = load_old(args.old)
    from kalman_hydra_tpu_torch import api as new_api
    from kalman_hydra_tpu_torch import config as new_config
    progs = {"old": (old_api, old_config), "new": (new_api, new_config)}
    ok = True
    for cell in CELLS:
        cfg_json, items, steps = cell_inputs(cell, args.seed)
        calls = {}
        for label, (api, config) in progs.items():
            cfg = config.RunConfig.from_json(cfg_json)
            if items[0].ndim == 4:
                calls[label] = (lambda c, a=api, g=cfg:
                                [a.track_video(c, g, device="cuda")])
            else:
                calls[label] = (lambda c, a=api, g=cfg:
                                a.track_videos(c, g, device="cuda"))
        outs = {k: {} for k in calls}
        for label, fn in calls.items():           # build and warm up
            for i in range(2):
                outs[label][i] = fn(items[i])
        torch.cuda.synchronize()
        ms = {k: [] for k in calls}
        for i in range(args.pairs):
            item = i % len(items)
            for label in (("old", "new") if i % 2 == 0 else ("new", "old")):
                t0 = time.perf_counter()
                out = calls[label](items[item])
                ms[label].append((time.perf_counter() - t0) * 1e3 / steps)
                outs[label].setdefault(item, out)
        same = all(
            np.array_equal(a.positions, b.positions)
            and np.array_equal(a.alive, b.alive)
            and np.array_equal(a.track_id, b.track_id)
            and np.array_equal(a.nis, b.nis)
            for item in outs["old"]
            for a, b in zip(outs["old"][item], outs["new"][item]))
        ok &= same
        faster = sum(n < o for o, n in zip(ms["old"], ms["new"]))
        for label, v in ms.items():
            q = statistics.quantiles(v, n=4)
            print(f"{cell} {label}: ms a frame step, median "
                  f"{statistics.median(v):.4f}, quartiles {q[0]:.4f} "
                  f"{q[2]:.4f}; frames/s at the median "
                  f"{1e3 / statistics.median(v):.2f}", flush=True)
        ratio = statistics.median(ms["new"]) / statistics.median(ms["old"])
        print(f"{cell}: new faster in {faster} of {args.pairs} pairs; "
              f"new / old median {ratio:.4f}; trajectories bit for bit "
              f"the same on all {len(outs['old'])} items: {same}",
              flush=True)
        print(f"{cell} per call (old, new): " + "; ".join(
            f"{o:.3f} {n:.3f}" for o, n in zip(ms["old"], ms["new"])))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
