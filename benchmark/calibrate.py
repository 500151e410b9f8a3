"""Readings that a cell's output limits are set from (limits/<cell>.json),
on the card at the cell's own size, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9

For each seed of --seeds the program answers as in a run: a clip cell
tracks every item of its pool once; the stream runs one track_stream
call for BENCHMARK.json's run_seconds. The check (lib/check.py) judges
every answer against the float32 reference. For each control seed the
reference computed with its flow layer in bfloat16 (lib/stand_in.py) is
put in the program's place (the stream: over its first
CONTROL_FRAMES frames) and judged the same way, and so is each fault
of lib/faults.py planted in the float32 reference's own answers. One
JSON line a seed and side with each number of the check. The largest
program reading is the lower end of a limit; the smallest control
reading, or for the lifecycle's number the smallest fault reading, the
upper end.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# frames of the stream that the control tracks: the walk's two turns over
# a 64-frame pool (the bfloat16 reference runs ~12 frames/s)
CONTROL_FRAMES = 128


def _line(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark.lib import card, check, drivers, faults, spec, stand_in
    bench = spec.load(ROOT)
    cell = spec.cell(bench, args.workload, ROOT)
    card.require(cell.chips)
    run_cfg, frame = cell.config["run_config"], cell.config["frame"]
    stream = cell.traffic["driver"] == "stream"
    program = drivers.Program(run_cfg, "cuda")
    control = stand_in.Control(run_cfg, "cuda")

    def drive(drv):
        if stream:
            return drv.window(bench["run_seconds"])
        return [drv.call(i) for i in range(len(drv.items))]

    def judged(drv, calls):
        t = time.perf_counter()
        with torch.no_grad():
            ref = drv.reference(calls)
        return ref, check.judge(drv, calls, ref, cell.limits), \
            time.perf_counter() - t

    warm = True
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        drv = drivers.make(cell.traffic, frame, run_cfg, seed, "cuda",
                           program)
        if warm:
            drv.warm()
            warm = False
        t = time.perf_counter()
        calls = drive(drv)
        t_prog = time.perf_counter() - t
        _ref, v, t_ref = judged(drv, calls)
        _line(workload=args.workload, seed=seed, side="program",
              **v["worst"], failed=v["failed"], errors=v["errors"],
              frame_steps=sum(c.steps for c in calls),
              program_s=round(t_prog, 3), reference_s=round(t_ref, 3))
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        drv = drivers.make(cell.traffic, frame, run_cfg, seed, "cuda",
                           control)
        t = time.perf_counter()
        with torch.no_grad():
            calls = ([drv.frames(CONTROL_FRAMES)] if stream
                     else [drv.call(i) for i in range(len(drv.items))])
        t_ctl = time.perf_counter() - t
        ref, v, t_ref = judged(drv, calls)
        _line(workload=args.workload, seed=seed, side="control",
              **v["worst"], failed=v["failed"], errors=v["errors"],
              frame_steps=sum(c.steps for c in calls),
              control_s=round(t_ctl, 3), reference_s=round(t_ref, 3))
        for name in sorted(faults.FAULTS):
            broken = [c._replace(outs=faults.plant(
                name, [ref[k] for k, _o in drv.answers(c)]))
                for c in calls]
            w = check.judge(drv, broken, ref, cell.limits)
            _line(workload=args.workload, seed=seed, side=f"fault:{name}",
                  **w["worst"], failed=w["failed"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
