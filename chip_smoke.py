#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (kalman_hydra_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile TRACE_JSON]

Phases, each of which must pass (the script exits non-zero otherwise and
prints no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the four CUDA kernels from csrc/ with nvcc (build time printed);
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (1080x1920, K=1024), with the stated bars;
  4. time each kernel and its plain version with CUDA events (warmed up,
     in turns plain, kernel, kernel, plain);
  5. drive the main path through api.track_video: a 1080x1920 T=9 clip,
     K=1024 tracks, with every launch counter reset just before and read
     just after; check the outputs, the flow of one frame pair against
     the plain functions on the card, a small clip against the CPU path,
     and report frames/s.
The last three lines are the per-kernel JSON summary, the card's name and
power limit exactly as nvidia-smi prints them, and the JSON result
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

H, W, T, K = 1080, 1920, 9, 1024
FAILURES: list = []


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name):
    """Run a phase; record (not raise) its failure so later phases still
    report, then fail the run at the end."""
    def deco(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                log(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)")
                return out
            except Exception:
                traceback.print_exc()
                log(f"[{name}] FAILED")
                FAILURES.append(name)
                return None
        return run
    return deco


def card() -> str:
    """The first card's "name, power.limit" as nvidia-smi prints them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain, reps: int = 20):
    """(kernel ms, plain ms) per call: warmed, then plain, kernel, kernel,
    plain, each a block of `reps` calls; the two blocks are averaged."""
    for fn in (kernel, plain):
        fn()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x|, taken at 2^-6 below that (the f32 sums' own
    summation-order noise on u8-scale images is ~1e-5)."""
    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0 ** -6)))
    return torch.pow(2.0, e - 7)


def rand_spd(g: torch.Generator, k: int, n: int, dev):
    A = torch.randn(k, n, n, generator=g).to(dev)
    return A @ A.transpose(1, 2) + torch.eye(n, device=dev)


@phase("K1 ekf_fused_step")
def check_k1(dev, results):
    from kalman_hydra_tpu_torch.config import EkfConfig
    from kalman_hydra_tpu_torch.kernels.ekf import (ekf_fused_step,
                                                    ekf_fused_step_plain)
    from kalman_hydra_tpu_torch.models import dynamics
    cfg = EkfConfig(state_dim=6)
    F, Q = dynamics.transition(cfg), dynamics.process_noise(cfg)
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(K, 6, generator=g) * 5).to(dev)
    P = rand_spd(g, K, 6, dev)
    y = (torch.randn(K, 2, generator=g) * 2).to(dev)
    Hs = [torch.as_tensor(dynamics.position_H(cfg), device=dev)]
    Hs.append((Hs[0] + 0.1 * torch.randn(K, 2, 6, generator=g).to(dev))
              .contiguous())
    err = 0.0
    for H in Hs:
        got = ekf_fused_step(x, P, y, H, F, Q, cfg.r)
        ref = ekf_fused_step_plain(x, P, y, H, F, Q, cfg.r)
        err = max(err, *((a - b).abs().max().item()
                         for a, b in zip(got, ref)))
    log(f"  K1 K={K} n=6, H (2,n) and (K,2,n): max_abs_err {err:.3e} "
        "(bar 1e-4)")
    assert err < 1e-4
    ms, pms = time_pair(lambda: ekf_fused_step(x, P, y, Hs[0], F, Q, cfg.r),
                        lambda: ekf_fused_step_plain(x, P, y, Hs[0], F, Q,
                                                     cfg.r))
    log(f"  K1 time: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    results["ekf_fused_step"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)


@phase("K3 poly_expansion_planar")
def check_k3(dev, gray, cfg, results):
    from kalman_hydra_tpu_torch.kernels.polyexp import (
        poly_expansion_planar, poly_expansion_planar_plain)
    from kalman_hydra_tpu_torch.ops.pyramid import gaussian_blur_level
    img0 = gaussian_blur_level(gray, cfg.flow, k=0)
    n, s = cfg.flow.poly_n, cfg.flow.poly_sigma
    k32 = poly_expansion_planar(img0, n, s)
    p32 = poly_expansion_planar_plain(img0, n, s)
    err = (k32 - p32).abs().max().item()
    kb = poly_expansion_planar(img0, n, s, torch.bfloat16).float()
    pb = poly_expansion_planar_plain(img0, n, s, torch.bfloat16).float()
    ulps = ((kb - pb).abs() / bf16_ulp(pb)).max().item()
    log(f"  K3 {H}x{W}: f32 max_abs_err {err:.3e} (bar 1e-3); bf16 max "
        f"diff {ulps:.2f} ulp (bar 1)")
    assert err < 1e-3 and ulps <= 1.0
    ms, pms = time_pair(
        lambda: poly_expansion_planar(img0, n, s, torch.bfloat16),
        lambda: poly_expansion_planar_plain(img0, n, s, torch.bfloat16))
    log(f"  K3 time (bf16 out): kernel {ms:.4f} ms, plain {pms:.4f} ms")
    results["poly_expansion_planar"] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=pms)


@phase("K4 coarse_polyexp_fused")
def check_k4(dev, gray, cfg, results):
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_polyexp_fused, coarse_polyexp_fused_plain)
    f = cfg.flow
    args = (gray, f.levels, f.pyr_scale, f.poly_n, f.poly_sigma)
    got = coarse_polyexp_fused(*args)
    ref = coarse_polyexp_fused_plain(*args)
    errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
    shapes = [tuple(a.shape[1:]) for a in got]
    log(f"  K4 levels {shapes}: f32 max_abs_err per level "
        f"{['%.3e' % e for e in errs]} (bar 1e-3)")
    assert len(got) == len(ref) == 5 and max(errs) < 1e-3
    ms, pms = time_pair(
        lambda: coarse_polyexp_fused(*args, out_dtype=torch.bfloat16),
        lambda: coarse_polyexp_fused_plain(*args, out_dtype=torch.bfloat16),
        reps=10)
    log(f"  K4 time (bf16 out, all 5 levels): kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms")
    results["coarse_polyexp_fused"] = dict(max_abs_err=max(errs), ms=ms,
                                           plain_ms=pms)


@phase("K2 flow_iter")
def check_k2(dev, cfg, results):
    from kalman_hydra_tpu_torch.kernels.flow_iter import (flow_iter,
                                                          flow_iter_plain)
    from kalman_hydra_tpu_torch.ops.pyramid import farneback_levels
    f = cfg.flow
    g = torch.Generator().manual_seed(2)
    worst = 0.0
    for (_k, lh, lw, _s, _ks) in farneback_levels(H, W, f.levels,
                                                  f.pyr_scale):
        R0 = torch.randn(5, lh, lw, generator=g).to(dev)
        R1 = torch.randn(5, lh, lw, generator=g).to(dev)
        fl = (torch.rand(2, lh, lw, generator=g) * 20 - 10).to(dev)
        line = []
        for dt in (torch.float32, torch.bfloat16):
            a, b = R0.to(dt), R1.to(dt)
            for gw in (False, True):
                e = (flow_iter(a, b, fl, f.winsize, f.fast_warp, gw)
                     - flow_iter_plain(a, b, fl, f.winsize, f.fast_warp,
                                       gw)).abs().max().item()
                worst = max(worst, e)
                line.append(f"{str(dt)[6:]}{'/gauss' if gw else ''} "
                            f"{e:.2e}")
        log(f"  K2 {lh}x{lw}: " + ", ".join(line))
    log(f"  K2 max_abs_err {worst:.3e} (bar 1e-4, f32 and bf16 planes)")
    assert worst < 1e-4
    R0 = torch.randn(5, H, W, generator=g).to(dev).to(torch.bfloat16)
    R1 = torch.randn(5, H, W, generator=g).to(dev).to(torch.bfloat16)
    fl = (torch.rand(2, H, W, generator=g) * 6 - 3).to(dev)
    ms, pms = time_pair(
        lambda: flow_iter(R0, R1, fl, f.winsize, f.fast_warp),
        lambda: flow_iter_plain(R0, R1, fl, f.winsize, f.fast_warp))
    log(f"  K2 time ({H}x{W}, bf16 planes): kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms")
    results["flow_iter"] = dict(max_abs_err=worst, ms=ms, plain_ms=pms)


@phase("main path (api.track_video, 1080p T=9 K=1024)")
def main_path(dev, clip, cfg, results):
    from kalman_hydra_tpu_torch import api, kernels
    from kalman_hydra_tpu_torch.ops.pyramid import farneback_levels
    kernels.reset_launches()
    tr = api.track_video(clip, cfg, device=dev)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    nlev = len(farneback_levels(H, W, cfg.flow.levels, cfg.flow.pyr_scale))
    expect = {"ekf_fused_step": T - 1,
              "flow_iter": nlev * cfg.flow.iterations * (T - 1),
              "poly_expansion_planar": T, "coarse_polyexp_fused": T}
    log(f"  launches {counts} (expected {expect})")
    for name, c in counts.items():
        results.setdefault(name, {})["launches"] = c
    assert counts == expect
    assert tr.positions.shape == (T, K, 2) and tr.alive.shape == (T, K)
    assert np.isfinite(tr.positions).all() and np.isfinite(tr.nis).all()
    live = int(tr.alive[-1].sum())
    log(f"  outputs finite; live tracks at the last frame: {live}/{K}")
    assert live > 0
    return tr


def plain_flow(g0, g1, f):
    """Frame-pair flow (H, W, 2) composed from the kernels' plain versions
    only, as ops.farneback composes the kernels."""
    from kalman_hydra_tpu_torch.kernels.flow_iter import flow_iter_plain
    from kalman_hydra_tpu_torch.kernels.level_image import \
        coarse_polyexp_fused_plain
    from kalman_hydra_tpu_torch.kernels.polyexp import \
        poly_expansion_planar_plain
    from kalman_hydra_tpu_torch.ops.pyramid import (gaussian_blur_level,
                                                    resize_linear)
    dt = torch.bfloat16 if f.bf16_poly else torch.float32
    pyrs = [coarse_polyexp_fused_plain(g, f.levels, f.pyr_scale, f.poly_n,
                                       f.poly_sigma, dt)
            + [poly_expansion_planar_plain(gaussian_blur_level(g, f, k=0),
                                           f.poly_n, f.poly_sigma, dt)]
            for g in (g0, g1)]
    flow = None
    for R0, R1 in zip(*pyrs):
        lh, lw = R0.shape[1:]
        flow = (torch.zeros((2, lh, lw), device=R0.device) if flow is None
                else resize_linear(flow, lh, lw) * (1.0 / f.pyr_scale))
        for _ in range(f.iterations):
            flow = flow_iter_plain(R0, R1, flow, f.winsize, f.fast_warp,
                                   f.gaussian_win)
    return flow.movedim(0, -1)


@phase("flow pair vs plain functions on the card")
def flow_vs_plain(dev, clip, cfg):
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.farneback import (
        farneback_from_pyramids, polyexp_pyramid)
    g0, g1 = (grayscale_u8(torch.from_numpy(clip[i]).to(dev))
              for i in (0, 1))
    flows = [farneback_from_pyramids(polyexp_pyramid(g0, cfg.flow),
                                     polyexp_pyramid(g1, cfg.flow), cfg.flow),
             plain_flow(g0, g1, cfg.flow)]
    epe = torch.linalg.vector_norm(flows[0] - flows[1], dim=-1)
    mag = torch.linalg.vector_norm(flows[1], dim=-1).mean().item()
    log(f"  frame 0->1 flow, kernels vs plain: mean EPE "
        f"{epe.mean().item():.3e} px (bar 1e-3), max {epe.max().item():.3e}"
        f" px; mean |flow| {mag:.3f} px")
    assert epe.mean().item() < 1e-3


@phase("small clip: CUDA path vs CPU path")
def small_vs_cpu(dev, cfg):
    from kalman_hydra_tpu_torch.io.synthetic import moving_blob_clip
    from kalman_hydra_tpu_torch import api
    clip, _ = moving_blob_clip(num_frames=5, height=128, width=160,
                               num_points=8, seed=0)
    small = cfg.replace(
        flow=dataclasses.replace(cfg.flow, levels=3),
        tracks=dataclasses.replace(cfg.tracks, num_tracks=32,
                                   corner_pool=256, reinit_every=2))
    a = api.track_video(clip, small, device=dev)
    b = api.track_video(clip, small, device="cpu")
    err = np.abs(a.positions - b.positions).max()
    log(f"  128x160 T=5 K=32: max |pos_cuda - pos_cpu| {err:.3e} px "
        "(bar 1e-3); alive/track_id identical: "
        f"{(a.alive == b.alive).all() and (a.track_id == b.track_id).all()}")
    assert err < 1e-3
    assert (a.alive == b.alive).all() and (a.track_id == b.track_id).all()


@phase("throughput")
def throughput(dev, clip, cfg, name):
    from kalman_hydra_tpu_torch import api
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        api.track_video(clip, cfg, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    fps = (T - 1) / med
    log(f"  clip times {['%.4f' % t for t in times]} s; median {med:.4f} s "
        f"-> {fps:.2f} frames/s (1080p, T={T}, K={K}; {name})")
    return med


@phase("profile (one warm clip under torch.profiler)")
def profile_main_path(dev, clip, cfg, trace_path, clip_s):
    """Device busy time, idle share and the top device consumers of one
    warm main-path clip; the Chrome trace goes to trace_path.

    The profiler slows the host loop, so the idle share is taken against
    the unprofiled median clip time `clip_s` of this process (the metric's
    own wall) and, as a second reading, against the span from the first
    to the last device event of the profiled clip."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kalman_hydra_tpu_torch import api
    api.track_video(clip, cfg, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.track_video(clip, cfg, device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name != "Activity Buffer Request"]   # CUPTI's own
    copies = [e for e in dev_events if e.name.startswith("Mem")]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    busy, end = 0.0, -1.0
    for a, b in spans:                   # union of device intervals (us)
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3
    span = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    copy_ms = sum(e.time_range.elapsed_us() for e in copies) / 1e3
    unprof = clip_s * 1e3 if clip_s else float("nan")
    log(f"  profiled clip: wall {wall:.3f} ms under the profiler, "
        f"{unprof:.3f} ms unprofiled (median above); device busy "
        f"{busy:.3f} ms = kernels {busy - copy_ms:.3f} ms in "
        f"{len(dev_events) - len(copies)} launches "
        f"({(len(dev_events) - len(copies)) / (T - 1):.0f}/frame step) + "
        f"copies {copy_ms:.3f} ms in {len(copies)}")
    log(f"  device idle share: {1 - busy / unprof:.3f} of the unprofiled "
        f"clip time; {1 - busy / span:.3f} of the device-event span "
        f"({span:.3f} ms)")
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=20, max_name_column_width=60))
    if trace_path:
        prof.export_chrome_trace(trace_path)
        log(f"  chrome trace written to {trace_path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="TRACE_JSON", default=None,
                    help="also profile one warm main-path clip and write "
                         "its Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import kalman_hydra_tpu_torch as kht
    from kalman_hydra_tpu_torch.io.synthetic import moving_blob_clip
    from kalman_hydra_tpu_torch import pipeline
    from kalman_hydra_tpu_torch.kernels import _build
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8

    name = card()
    log(f"card: {name}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    dev = kht.cuda_device(0)

    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds else 0:.1f} "
        "s)")

    cfg = pipeline.main_path_config(num_tracks=K)
    t0 = time.perf_counter()
    clip, _ = moving_blob_clip(num_frames=T, height=H, width=W,
                               num_points=16, blob_sigma=max(H, W) / 18.0,
                               velocity=(2.1, -1.4), seed=0)
    log(f"clip {clip.shape} {clip.dtype} made in "
        f"{time.perf_counter() - t0:.1f} s")
    gray = grayscale_u8(torch.from_numpy(clip[0]).to(dev))

    results: dict = {}
    check_k1(dev, results)
    check_k3(dev, gray, cfg, results)
    check_k4(dev, gray, cfg, results)
    check_k2(dev, cfg, results)
    main_path(dev, clip, cfg, results)
    flow_vs_plain(dev, clip, cfg)
    small_vs_cpu(dev, cfg)
    clip_s = throughput(dev, clip, cfg, name)
    if args.profile:
        profile_main_path(dev, clip, cfg, args.profile, clip_s)
    if "jax" in sys.modules:
        log("chip_smoke: jax was imported")
        FAILURES.append("no jax")

    src = {"ekf_fused_step": ("ekf.cu", "ekf_pallas.py:171"),
           "flow_iter": ("flow_iter.cu", "flow_iter_pallas.py:802"),
           "poly_expansion_planar": ("polyexp.cu", "polyexp_pallas.py:140"),
           "coarse_polyexp_fused": ("level_image.cu",
                                    "level_image_pallas.py:195")}
    rows = []
    for kname, (cu, tpu) in src.items():
        r = results.get(kname, {})
        rows.append({"name": kname, "route": "cuda",
                     "source": f"kalman_hydra_tpu_torch/csrc/{cu}",
                     "replaces": f"kalman_hydra_tpu/kernels/{tpu}",
                     "launches": r.get("launches"),
                     "max_abs_err": r.get("max_abs_err"),
                     "ms": r.get("ms"), "plain_ms": r.get("plain_ms")})
    if FAILURES:
        log(f"chip_smoke FAILED phases: {FAILURES}")
        return 1
    log(json.dumps({"kernels": rows}))
    log(name)                       # nvidia-smi's own "name, power.limit"
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
