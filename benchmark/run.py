"""Run one cell of the benchmark of kalman_hydra_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Set-up (imports, the card, the kernels'
library, the seeded footage, warm-up), then `--seconds` of closed-loop
calls; with --trace 1 a fixed number of further calls under
torch.profiler. Then every call's trajectories are checked against the
plain reference (benchmark/reference/), and the last line of standard
output is one JSON object: correct, attempted, failed, metrics, device
(and breakdown with --trace 1), and last the numbers compared beside
their limits, which also close standard error. Without the card the
cell asks for it exits 2 and prints no result; with a module of JAX or
of the JAX package loaded at the end, 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # one process, few threads: the host's other cores are shared, and the
    # port's host work is one Python loop that launches kernels
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    # build and kernel caches at fixed places inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from benchmark.lib import card, guard, harness
    try:
        result, log = harness.run(
            args.workload, args.seed, args.seconds, bool(args.trace),
            root=ROOT, t0=T0,
            trace_dir=ROOT / "build" / "benchmark" if args.trace else None)
    except card.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = guard.offenders()
    if found:
        print(f"benchmark: modules of {found} are loaded; the run may "
              "import neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for line in log:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
