"""Command-line interface of the port (after kalman_hydra_tpu/cli.py):
parse args, open the video, track, export, report.

  python -m kalman_hydra_tpu_torch track clip.mp4 --out tracks.npz [--smooth]
  python -m kalman_hydra_tpu_torch track clip.npz --stream --checkpoint ck.npz
  python -m kalman_hydra_tpu_torch flow a.npy b.npy --out flow.npz
  python -m kalman_hydra_tpu_torch synth --out clip.npz --frames 32

`track` and `flow` run on the card unless given `--device cpu`. The
reference's `mesh` subcommand and `--profile` flag, and its `bench`
harness, are not ported yet: they raise NotImplementedError naming their
ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import logging
import sys

import numpy as np

logger = logging.getLogger("kalman_hydra_tpu_torch")


def _load_cfg(args):
    from .config import RunConfig, SmoothConfig
    if args.config:
        with open(args.config) as f:
            cfg = RunConfig.from_json(f.read())
    else:
        cfg = RunConfig()
    over = {}
    if args.method or args.temporal:
        fover = {}
        if args.method:
            fover["method"] = args.method
        if args.temporal:
            # warm-start chaining is Farneback-only; the config's
            # validation enforces it
            fover["temporal_init"] = True
        over["flow"] = dataclasses.replace(cfg.flow, **fover)
    if args.tracks:
        over["tracks"] = dataclasses.replace(cfg.tracks,
                                             num_tracks=args.tracks)
    if args.smooth or args.smooth_chunk or args.smooth_lag:
        over["smooth"] = SmoothConfig(enabled=True,
                                      chunk=args.smooth_chunk or 0,
                                      lag=args.smooth_lag or 0)
    return cfg.replace(**over) if over else cfg


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="kalman_hydra_tpu_torch")
    ap.add_argument("-v", "--v", action="count", default=0, dest="v",
                    help="verbosity (-v info, -vv debug)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    device = dict(default="cuda", help="torch device to run on (default "
                  "cuda; cpu runs the kernels' plain versions)")

    t = sub.add_parser("track", help="track a video -> trajectories")
    t.add_argument("video")
    t.add_argument("--out", default="tracks.npz")
    t.add_argument("--config", help="RunConfig JSON file")
    t.add_argument("--method", choices=["farneback", "lk_dense", "lk_sparse"])
    t.add_argument("--tracks", type=int)
    t.add_argument("--smooth", action="store_true")
    t.add_argument("--smooth-chunk", type=int, default=0,
                   help="host-chunked RTS chunk length (0 = one RTS on "
                        "the device; implies --smooth when > 0)")
    t.add_argument("--smooth-lag", type=int, default=0,
                   help="online fixed-lag smoother window (O(lag) device "
                        "memory; implies --smooth when > 0)")
    t.add_argument("--stream", action="store_true",
                   help="O(1)-memory streaming mode")
    t.add_argument("--checkpoint", help="state checkpoint path")
    t.add_argument("--checkpoint-every", type=int, default=0)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--max-frames", type=int)
    t.add_argument("--temporal", action="store_true",
                   help="warm-start each pair's flow from the previous "
                        "pair (Farneback)")
    t.add_argument("--profile", help="write a profiler trace here "
                   "(not ported yet: ROADMAP P14)")
    t.add_argument("--device", **device)

    f = sub.add_parser("flow", help="dense flow between two frames")
    f.add_argument("a")
    f.add_argument("b")
    f.add_argument("--out", default="flow.npz")
    f.add_argument("--config")
    f.add_argument("--method", choices=["farneback", "lk_dense"])
    f.add_argument("--device", **device)

    s = sub.add_parser("synth", help="generate a synthetic test clip")
    s.add_argument("--out", default="clip.npz")
    s.add_argument("--frames", type=int, default=16)
    s.add_argument("--height", type=int, default=256)
    s.add_argument("--width", type=int, default=256)
    s.add_argument("--seed", type=int, default=0)

    b = sub.add_parser("bench", help="the benchmark harness (not ported "
                       "yet: ROADMAP P6)")
    b.add_argument("--config", type=int, default=0)
    b.add_argument("--quick", action="store_true")

    m = sub.add_parser("mesh", help="segment -> mesh -> track vertices "
                       "(not ported yet: ROADMAP P11b)")
    m.add_argument("video")
    m.add_argument("--out", default="mesh_tracks.npz")
    m.add_argument("--config")
    m.add_argument("--vertices", type=int, default=64)
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--measurement", choices=["render", "flow_render"])
    m.add_argument("--max-frames", type=int)
    m.add_argument("--stream", action="store_true")
    return ap


def _track(ap, args) -> int:
    from . import api
    from . import pipeline as pl
    from .io.export import save
    from .io.video import FrameStream, PrefetchStream
    from .utils.report import run_report
    if args.profile:
        raise NotImplementedError("track --profile: the profiler trace is "
                                  "not ported yet (ROADMAP P14)")
    cfg = _load_cfg(args)
    if (args.checkpoint or args.resume) and not args.stream:
        ap.error("--checkpoint/--resume require --stream "
                 "(clip mode has no incremental state to save)")
    if args.stream:
        src = FrameStream(args.video)
        if args.max_frames:
            src = itertools.islice(iter(src), args.max_frames)
        tracks = pl.track_stream(
            PrefetchStream(src, depth=4), cfg,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            device=args.device)
        save(tracks, args.out)
    else:
        tracks = api.track_video(args.video, cfg, out_path=args.out,
                                 max_frames=args.max_frames,
                                 device=args.device)
    rep = run_report(tracks, gate_chi2=cfg.ekf.gate_chi2)
    logger.info("run report: %s", json.dumps(rep, sort_keys=True))
    report_path = args.out.rsplit(".", 1)[0] + ".report.json"
    with open(report_path, "w") as f:
        json.dump(rep, f, indent=2, sort_keys=True)
    print(f"tracked {tracks.num_frames} frames x {tracks.num_tracks} slots "
          f"(live {tracks.alive.mean():.0%}) -> {args.out} "
          f"(+ {report_path})")
    return 0


def _flow(args) -> int:
    from . import api
    from .config import FlowConfig, RunConfig
    a = _load_frame(args.a)
    b = _load_frame(args.b)
    if args.config:
        # a RunConfig JSON, as `track` takes; its flow section is used
        with open(args.config) as f:
            cfg = RunConfig.from_json(f.read()).flow
    else:
        cfg = FlowConfig()
    if args.method:
        cfg = dataclasses.replace(cfg, method=args.method)
    fl = api.flow(a, b, cfg, device=args.device)
    np.savez_compressed(args.out, flow=fl)
    mag = np.linalg.norm(fl, axis=-1)
    print(f"flow {fl.shape}: |u| mean {mag.mean():.3f} max {mag.max():.3f}"
          f" -> {args.out}")
    return 0


def _synth(args) -> int:
    from .io.synthetic import moving_blob_clip
    frames, truth = moving_blob_clip(num_frames=args.frames,
                                     height=args.height, width=args.width,
                                     seed=args.seed)
    np.savez_compressed(args.out, frames=frames,
                        truth_positions=truth.positions)
    print(f"wrote {frames.shape} clip -> {args.out}")
    return 0


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=(logging.WARNING if args.v == 0
               else logging.INFO if args.v == 1 else logging.DEBUG),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.cmd == "track":
        return _track(ap, args)
    if args.cmd == "flow":
        return _flow(args)
    if args.cmd == "synth":
        return _synth(args)
    if args.cmd == "mesh":
        raise NotImplementedError("mesh: the mesh-render channels are not "
                                  "ported yet (ROADMAP P11b)")
    raise NotImplementedError("bench: the port has no benchmark harness "
                              "yet (ROADMAP P6)")


def _load_frame(path: str) -> np.ndarray:
    if path.endswith((".npy", ".npz")):
        if path.endswith(".npz"):
            with np.load(path) as z:
                return z[list(z.keys())[0]]
        return np.load(path)
    import cv2
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise IOError(f"cannot read {path}")
    return img


if __name__ == "__main__":
    sys.exit(main())
