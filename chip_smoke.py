#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (kalman_hydra_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile TRACE_JSON]

Phases, each of which must pass (the script exits non-zero otherwise and
prints no result line):
  1. require CUDA and the port of this checkout; print the card's name
     and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc, one process per source
     (build time printed); count the device kernels of one call of K4,
     K7b, K12's walk, K5's walk, K3 and K7a under torch.profiler (one
     each);
  3. hold each kernel against its plain PyTorch version on the card at
     the shapes its path gives it, with the stated bars, and each batched
     kernel against its per-item kernel (bit for bit; K5's one-level
     launch and K13 against n_iters K2 launches, K5's walk against its
     per-level route, K8-pairs against per-pair K8, K9's and K10's
     one launch a pyramid against their one-level launches), the fused
     K2 against the output bytes of the three-launch K2 it replaced
     (K2_WITNESS) and against K5 at one iteration, K5's walk (every gated
     level of a frame pair in one launch, the resizes inside) against
     the bytes of the per-level route it replaced (K5_WITNESS), K7a
     against the first design's bytes (K7A_WITNESS), and K8 and K8-pairs,
     the exact gather in the kernel, against the output bytes of the
     parent route they replaced, the plain gather then the three-launch
     kernel (K8_WITNESS), K7b and K4 in one launch against the bytes of
     the 15-launch route they replaced and K3 against its own
     (K7B_WITNESS), and K12's walk (one launch a frame step) and its
     one-level launch against the points and status of the per-level
     route they replaced (K12_WITNESS) and the walk against that route on
     the card (bit for bit) and its plain version, K11 (one launch for a
     frame's coarse levels) and K1 (a group of lanes a track) against
     the bytes of their first designs (K11_WITNESS, K1_WITNESS); run the
     settings past the kernels' old limits at 1080p (F2: 16 levels at
     pyr_scale 0.8; F5: lk_sparse and lk_dense at 10 levels; F4: poly_n
     9, 11, 13; F3: winsize 63, 81, 101 at fast_warp 0 and 8) through
     api.flow or pipeline.track_clip against the plain route on the card,
     and each kernel they reach against its plain version; hold
     api.flow and pipeline.track_clip against the OpenCV oracle's
     tests/golden/oracle_v1.npz; OC: hold the card's Farneback flow
     (both warps), sparse and dense LK and trajectories (main_path_config()
     and RunConfig()) against the port's own OpenCV oracle
     (kalman_hydra_tpu_torch.ref, on the host) at 1080p, and time the
     oracle on the host at 1 cv2 thread and at its default count beside
     path A (without cv2 on the host OC says so and runs nothing);
  4. time each kernel, its plain version and, where one PyTorch call
     computes the same function, that call, with CUDA events (warmed up,
     in turns forward and back), per call and on the device alone (the
     timed calls replayed as one CUDA graph, or where a call cannot be
     captured their device events under torch.profiler); compute each
     kernel's bound (the larger of its bytes over 3.35 TB/s and its FLOPs
     over 67 TFLOP/s f32);
  5. drive the paths through the public API, with every launch counter
     reset just before each and read just after:
       A. api.track_video, 1080x1920 T=9, K=1024, the headline graph
          (fi_level_fused=True): one K5 walk a step over the levels
          under its gate;
       B. api.track_video, 720x1280 T=17, K=1024, pair_path_config()
          (bench cfg3's pair-batched graph);
       C. api.track_videos, 4 clips of 1080x1920 T=9, K=1024, the main
          path with pair_batch;
       D. api.track_video with no config (the reference's RunConfig():
          exact warp, one K8 launch, the gather in it, on every level
          iteration), 1080x1920 T=9;
       D2. RunConfig() at pe_fused=False (K11 + K3 per level), T=5;
       E. bench's temporal warm-1 stage, 1080x1920 T=9, K=1024;
       F. bench cfg5 through api.smooth (RTS, pair-batched), 480x854
          T=33;
       G. bench cfg2's pixel-KF stage through api.flow_sequence(smooth=
          True), 480x854 T=33;
       H. bench --sparse through api.track_video: sparse LK at 1080x1920
          T=9, K=1024, lk_block_halo 8 (K12's block window), 6-state, one
          K12 launch a frame step;
       H0. api.track_video with RunConfig(flow=FlowConfig(method=
          "lk_sparse")): the reference's LK defaults (halo 0, K12's exact
          window, 4-state, K=256), 1080x1920 T=9;
       J. BASELINE config 1 as bench times it: dense LK (fast_warp 8),
          4-state, K=256, 256x256 T=33, per frame;
       AP. A with fi_pipeline=True (bench KH_FI_PIPE=1): K13 on the two
          levels above K5's gate;
       BX. api.track_video with RunConfig(pair_batch=True) (the
          reference's defaults, pair-batched: K8-pairs, the exact gather
          in it), B's clip;
       I. AP with the 6-state implicit-flow IEKF (iekf_iters 2), then
          the UKF: no K1 (a nonlinear measurement);
       P. RunConfig() with measurement="photometric" (no flow, no
          kernel), then flow_photometric with adaptive_q 0.3 and
          seed_in_body (D's flow launches, no K1), 1080p T=9;
       W. docs/WALKTHROUGH.md section 3: sparse LK at lk_block_halo 8,
          6-state, adaptive_q 0.3, fixed-lag 8, 1080p T=9;
       Q. pipeline.track_precomputed_flow over AP's 8 flows from AP's
          1024 seeds (K1 only);
       S, S-D, S-H. A's, D's and H's configs streamed from a .npy of
          the clip through api.track_video(path, streaming=True): the
          per-frame launches, the array run's tracks (< 1e-3 px; bit
          for bit printed);
       S-mem. A's config streamed over 9 and 65 frames (a walk forward
          and back over the clip): peak card memory within 8 MiB
          (track_clip of the 65 frames printed beside);
       S-ckpt. A's and W's configs checkpointed every frame over 5
          frames, then resumed over 9: the uninterrupted tail (< 1e-4);
       S-F. F's config (RTS) streamed per frame: track_clip at
          pair_batch=False (< 1e-3 px);
       S-cli. the CLI's track --stream --checkpoint, then --resume, on
          A's config at 1080p T=5: exit 0 and a .report.json each;
       then whether cv2 and the native loader are on the host (where both
       are, each decodes an MJPG copy of the clip), and S-fps: S against
       A's array run, in turns;
       R. api.track_mesh on deforming_body_clip at 1080x1920, T=9, V=256
          (its deformation scaled by 480/1080: R-480's motion in px a
          frame), measurement "render" (no kernel of K1-K13): two card
          runs with
          equal hashes, the CPU's run of the same call (positions < 1e-3
          px, alive and track_id identical), the median vertex error at
          the last frame against the clip's affine truth no worse than
          the CPU's + 0.05 px; frames/s of the call and of the tracking
          alone (track_clip with the template), idle shares;
       R-480. the same at 480x640, V=64, the default deformation; RF. R
          with "flow_render" and A's FlowConfig (K2-K5, no K1: the
          implicit-flow update); R-bench. bench --render's clip, the
          default deformation at 1080p, which the channel (the
          reference's too: tools/torch_render_reach.py) does not follow:
          two card runs with equal hashes, the card against the CPU
          within R_BENCH_BAR px with alive and track_id identical;
       R-S. R streamed (track_mesh(streaming=True)): R bit for bit;
       R-mesh. the strain of R's trajectories (mesh_strain_sequence and
          the remeshing mesh_strain_sequence_dynamic) on the card against
          the CPU: the same remesh events, < 1e-5 (max_shear past a
          shear of 10: < SHEAR_ULPS * eps_f32 * shear^2);
       P14. utils.profiling.trace around one warm A step names the
          port's kernels; cost() of a 1024² f32 matmul >= 2 * 1024³ *
          0.5 FLOPs; a small A run under utils.debug.debug_checks
          launches what it launches without them, with the same tracks,
          and a NaN in one frame raises FloatingPointError naming the
          stage and the frame;
       K2-band. K2's band mode on 1080x1920 planes cut into 4 bands in
          the reference's slab layout (band rows +- RPAD), at winsize
          15, 81 and 101 (the three tile routes): against its plain
          band version (< 1e-4) and each band's interior against the
          full-frame K2 launch (< 1e-5), one launch a band; timed;
       SF. parallel.spatial.farneback_sharded on A's FlowConfig over a
          1080x1920 translating_pair on meshes of 4 and 8 shards of the
          one card (and at f32 planes on 4) against api.flow (rows >= 8
          px from the border < 0.05 px, all < 0.15; f32 5e-3, 0.1; rows
          48 ... 1031, the band interiors, < 1e-5) and against its plain
          route on the card (mean EPE < 1e-3 px, max < 1e-3 px);
       SL. lk_dense_sharded (levels 3, 2 shards) against api.flow at
          method "lk_dense" (< 1e-3 inside, < 0.1);
       DP, DP-C, DP-R. parallel.track_clips_sharded: C's 4 clips at
          main_path_config() on 4 shards with reduce_metrics, at
          pair_path_config() on 2 shards of 2 clips, and R-480's clip 4
          times with its template on 4 shards, against
          track_clips_batch (< 1e-5 px, < 5e-4 px for render; alive and
          track_id identical); DP's metrics against NumPy's means;
       DP-D. api.track_videos(sharded=True) with no config on the
          default mesh, bit for bit sharded=False; then
          api.flow_sharded on the default mesh against api.flow;
     check the launch counts, the outputs against the plain functions,
     the CPU smoothers, the per-frame path and the CPU path, and report
     frames/s; H, H0, W and J again through the per-level K9/K10 launches
     (the same tracks, bit for bit) and frames/s of both routes in turns.
The last three lines are the per-kernel JSON summary, the card's name and
power limit exactly as nvidia-smi prints them, and the JSON result
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import platform
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

H, W, T, K = 1080, 1920, 9, 1024           # path A, and each clip of C
H_B, W_B, T_B = 720, 1280, 17              # path B (bench cfg3)
N_CLIPS = 4                                # path C
T_D2 = 5                                   # path D2
H_F, W_F, T_F = 480, 854, 33               # paths F and G (cfg5, cfg2)
H_J, W_J, T_J = 256, 256, 33               # path J (BASELINE config 1)
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, data sheet
F32_FLOPS_PER_S = 67e12                    # f32 outside the tensor cores
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


def device_ms(fn, reps: int = 20):
    """(ms per call on the device alone, how it was taken). "graph":
    `reps` calls captured as one CUDA graph (the wrappers launch on the
    current stream, which is the capturing one), replayed 5 times and
    timed with events, so the host's cost per call drops out. "profiler":
    where a call cannot be captured, the sum of the device events of
    `reps` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        return cuda_ms(g.replay, 5) / reps, "graph"
    except Exception as e:          # not capturable: the profiler's sum
        log(f"  (no CUDA graph: {type(e).__name__}: {str(e)[:120]})")
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and e.name != "Activity Buffer Request")
    return us / 1e3 / reps, "profiler"


def device_launches(fn) -> list:
    """The device kernels one warm call of fn launches, as torch.profiler
    records them: [(name, microseconds)] in order (copies and memsets
    left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name != "Activity Buffer Request"
                  and not e.name.startswith("Mem")),
                 key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in evs]


def time_turns(fns: dict, reps: int = 20) -> dict:
    """ms per call of each function: warmed, then timed in turns, in the
    given order and back (plain, kernel, kernel, plain for two), each a
    block of `reps` calls; the two blocks of each are averaged. Every
    entry but "plain" also gets its device-only time (`device_ms`) under
    "<name> dev", and how it was taken under "<name> how"."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    ms = dict.fromkeys(names, 0.0)
    for order in (names, names[::-1]):
        for n in order:
            ms[n] += cuda_ms(fns[n], reps) / 2
    for n in names:
        if n != "plain":
            ms[f"{n} dev"], ms[f"{n} how"] = device_ms(fns[n], reps)
    return ms


def bound(nbytes: float, flops: float):
    """(least ms, what bounds it): each input read once and each output
    written once at the HBM rate, or the FLOPs at the f32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def fi_flops(taps: int, gaussian: bool = False) -> int:
    """FLOPs per pixel that one Farneback iteration needs: ~95 for the
    warp and M, ~21 for the scale and the solve, and the two window passes
    over M's 5 planes. A box window needs one add and one subtract per
    plane and pass (a sliding sum), whatever its width; a Gaussian needs a
    multiply-add per tap. This is the function's need, not the cost of
    csrc/flow_iter.cuh, which sums every tap of the box too."""
    return 116 + (20 * taps if gaussian else 20)


def pe_flops(n: int) -> int:
    """FLOPs per output pixel of the polynomial expansion: 3 vertical
    and 6 horizontal moments, 2 per tap, and 7 to combine them."""
    return 18 * (2 * n + 1) + 7


def record(results, name, err, ms, plain_ms, nbytes, flops,
           library_ms=None, dev=None):
    """Keep a kernel's numbers; `dev` is the time_turns dict (or a sum of
    them) holding the device-only times of "kernel" and "library"."""
    b, by = bound(nbytes, flops)
    dev = dev or {}
    dms, lib_dms = dev.get("kernel dev"), dev.get("library dev")
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by, library_ms=library_ms,
                         device_ms=dms, device_how=dev.get("kernel how"),
                         library_device_ms=lib_dms)
    log(f"  {name}: bound {b:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP); kernel {ms:.4f} ms per call, "
        f"{'not measured' if dms is None else '%.4f' % dms} ms on the "
        f"device ({dev.get('kernel how')}); plain {plain_ms:.4f} ms, "
        f"library "
        f"{'none' if library_ms is None else '%.4f ms' % library_ms}"
        f"{'' if lib_dms is None else ' (%.4f ms on the device)' % lib_dms}")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x|, taken at 2^-6 below that (the f32 sums' own
    summation-order noise on u8-scale images is ~1e-5)."""
    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0 ** -6)))
    return torch.pow(2.0, e - 7)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def rand_spd(g: torch.Generator, k: int, n: int, dev):
    A = torch.randn(k, n, n, generator=g).to(dev)
    return A @ A.transpose(1, 2) + torch.eye(n, device=dev)


def blob_clip(t, h, w, seed=0):
    """bench.py's synthetic clip at (t, h, w)."""
    from kalman_hydra_tpu_torch.io.synthetic import moving_blob_clip
    clip, _ = moving_blob_clip(num_frames=t, height=h, width=w,
                               num_points=16, blob_sigma=max(h, w) / 18.0,
                               velocity=(2.1, -1.4), seed=seed)
    return clip


def polyexp_conv(img_pad: torch.Tensor, n: int, sigma: float):
    """The polynomial expansion as ONE cuDNN convolution of the
    replicate-padded image with 5 (2n+1)^2 kernels (the expansion is
    linear in the image): the library yardstick of K3 and K7a. It is
    timed here and used nowhere in the port."""
    from kalman_hydra_tpu_torch.kernels.polyexp import poly_taps
    t = poly_taps(n, float(sigma))
    k = 2 * n + 1
    g, xg, xxg = (torch.tensor(t[j * k:(j + 1) * k]) for j in range(3))
    ig11, ig03, ig33, ig55 = (float(v) for v in t[3 * k:])
    # (rows, cols) taps: m_ab = vertical b-moment x horizontal a-moment
    m = {"00": torch.outer(g, g), "10": torch.outer(g, xg),
         "20": torch.outer(g, xxg), "01": torch.outer(xg, g),
         "11": torch.outer(xg, xg), "02": torch.outer(xxg, g)}
    wts = torch.stack([m["10"] * ig11, m["01"] * ig11,
                       m["00"] * ig03 + m["20"] * ig33,
                       m["00"] * ig03 + m["02"] * ig33, m["11"] * ig55])
    wts = wts[:, None].to(img_pad.device)
    return lambda: torch.nn.functional.conv2d(img_pad[:, None], wts)


@phase("K1 ekf_fused_step")
def check_k1(dev, results):
    from kalman_hydra_tpu_torch.config import EkfConfig
    from kalman_hydra_tpu_torch.kernels.ekf import (ekf_fused_step,
                                                    ekf_fused_step_plain)
    from kalman_hydra_tpu_torch.models import dynamics
    g = torch.Generator().manual_seed(1)
    errs = {}
    for n in (4, 6):           # RunConfig()'s CV filter; the main path's CA
        cfg = EkfConfig(state_dim=n)
        F, Q = dynamics.transition(cfg), dynamics.process_noise(cfg)
        x = (torch.randn(K, n, generator=g) * 5).to(dev)
        P = rand_spd(g, K, n, dev)
        y = (torch.randn(K, 2, generator=g) * 2).to(dev)
        Hs = [torch.as_tensor(dynamics.position_H(cfg), device=dev)]
        Hs.append((Hs[0] + 0.1 * torch.randn(K, 2, n, generator=g).to(dev))
                  .contiguous())
        errs[n] = 0.0
        for H_ in Hs:
            got = ekf_fused_step(x, P, y, H_, F, Q, cfg.r)
            ref = ekf_fused_step_plain(x, P, y, H_, F, Q, cfg.r)
            errs[n] = max(errs[n], *(max_err(a, b) for a, b in zip(got, ref)))
        log(f"  K1 K={K} n={n}, H (2,n) and (K,2,n): max_abs_err "
            f"{errs[n]:.3e} (bar 1e-4)")
    err = max(errs.values())
    assert err < 1e-4
    ms = time_turns({
        "plain": lambda: ekf_fused_step_plain(x, P, y, Hs[0], F, Q, cfg.r),
        "kernel": lambda: ekf_fused_step(x, P, y, Hs[0], F, Q, cfg.r)})
    n = 6
    # x, P, y, H in; x, P, nis out. ~2n^3 for the predict, ~10n^2 update
    record(results, "ekf_fused_step", err, ms["kernel"], ms["plain"],
           4 * (2 * K * n + 2 * K * n * n + 2 * K + 2 * n + K),
           K * (4 * n ** 3 + 10 * n * n), dev=ms)


@phase("K3 poly_expansion_planar")
def check_k3(dev, gray, cfg, results):
    from kalman_hydra_tpu_torch.kernels.polyexp import (
        poly_expansion_planar, poly_expansion_planar_plain)
    from kalman_hydra_tpu_torch.ops.filters import pad1d
    from kalman_hydra_tpu_torch.ops.pyramid import gaussian_blur_level
    img0 = gaussian_blur_level(gray, cfg.flow, k=0)
    n, s = cfg.flow.poly_n, cfg.flow.poly_sigma
    k32 = poly_expansion_planar(img0, n, s)
    err = max_err(k32, poly_expansion_planar_plain(img0, n, s))
    kb = poly_expansion_planar(img0, n, s, torch.bfloat16).float()
    pb = poly_expansion_planar_plain(img0, n, s, torch.bfloat16).float()
    ulps = ((kb - pb).abs() / bf16_ulp(pb)).max().item()
    pad = pad1d(pad1d(img0, n, n, -2, "replicate"), n, n, -1,
                "replicate")[None].contiguous()
    conv = polyexp_conv(pad, n, s)
    log(f"  K3 {H}x{W}: f32 max_abs_err {err:.3e} (bar 1e-3); bf16 max "
        f"diff {ulps:.2f} ulp (bar 1); cuDNN conv yardstick vs kernel "
        f"(f32) {max_err(conv()[0], k32):.3e}")
    assert err < 1e-3 and ulps <= 1.0
    # a contiguous view 4 bytes past a 16-byte boundary: the kernel loads
    # it by element, and gives the bytes of its aligned copy
    flat = torch.empty(1 + H * W, device=dev)
    view = flat[1:].view(H, W)
    view.copy_(img0)
    same = all(torch.equal(poly_expansion_planar(view, n, s, dt),
                           poly_expansion_planar(img0, n, s, dt))
               for dt in (torch.float32, torch.bfloat16))
    log(f"  K3 on a view at {view.data_ptr() % 16} bytes past a 16-byte "
        f"boundary: {'the same bytes' if same else 'DIFFERENT bytes'} as "
        f"on an aligned copy")
    assert view.data_ptr() % 16 and same
    for n1, s1 in ((1, POLY_SIGMA[1]), (3, POLY_SIGMA[3])):
        e1 = max_err(poly_expansion_planar(img0, n1, s1),
                     poly_expansion_planar_plain(img0, n1, s1))
        kb = poly_expansion_planar(img0, n1, s1, torch.bfloat16).float()
        pb = poly_expansion_planar_plain(img0, n1, s1,
                                         torch.bfloat16).float()
        u1 = ((kb - pb).abs() / bf16_ulp(pb)).max().item()
        log(f"  K3 {H}x{W} poly_n {n1}: f32 max_abs_err {e1:.3e} (bar "
            f"1e-3); bf16 max diff {u1:.2f} ulp (bar 1)")
        assert e1 < 1e-3 and u1 <= 1.0
    ms = time_turns({
        "plain": lambda: poly_expansion_planar_plain(img0, n, s,
                                                     torch.bfloat16),
        "kernel": lambda: poly_expansion_planar(img0, n, s, torch.bfloat16),
        "library": conv})
    record(results, "poly_expansion_planar", err, ms["kernel"],
           ms["plain"], H * W * (4 + 5 * 2), H * W * pe_flops(n),
           ms["library"], dev=ms)


def k4_flops(h, w, f) -> int:
    from kalman_hydra_tpu_torch.kernels.level_image import level_tables
    fl = 0
    for (lh, lw, iv, _wv, ih, _wh) in level_tables(h, w, f.levels,
                                                    f.pyr_scale, f.poly_n):
        ho, wo = lh + 2 * f.poly_n, lw + 2 * f.poly_n
        fl += 2 * ho * w * iv.shape[1] + 2 * ho * wo * ih.shape[1] \
            + lh * lw * pe_flops(f.poly_n)
    return fl


def k4_bytes(h, w, f, isz: int) -> int:
    from kalman_hydra_tpu_torch.ops.pyramid import farneback_levels
    px = sum(lh * lw for (k, lh, lw, _s, _ks)
             in farneback_levels(h, w, f.levels, f.pyr_scale) if k > 0)
    return h * w * 4 + 5 * px * isz


@phase("K4 coarse_polyexp_fused")
def check_k4(dev, gray, cfg, results):
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_polyexp_fused, coarse_polyexp_fused_plain)
    f = cfg.flow
    args = (gray, f.levels, f.pyr_scale, f.poly_n, f.poly_sigma)
    got = coarse_polyexp_fused(*args)
    ref = coarse_polyexp_fused_plain(*args)
    errs = [max_err(a, b) for a, b in zip(got, ref)]
    shapes = [tuple(a.shape[1:]) for a in got]
    log(f"  K4 levels {shapes}: f32 max_abs_err per level "
        f"{['%.3e' % e for e in errs]} (bar 1e-3)")
    assert len(got) == len(ref) == 5 and max(errs) < 1e-3
    ms = time_turns({
        "plain": lambda: coarse_polyexp_fused_plain(
            *args, out_dtype=torch.bfloat16),
        "kernel": lambda: coarse_polyexp_fused(*args,
                                               out_dtype=torch.bfloat16)},
        reps=10)
    record(results, "coarse_polyexp_fused", max(errs), ms["kernel"],
           ms["plain"], k4_bytes(H, W, f, 2), k4_flops(H, W, f), dev=ms)


# sha256 of the output bytes of the route that K7b and K4 replaced (commit
# 1d94c6b: per coarse level a vertical, a horizontal and a K3 launch,
# with the tmp and lvl scratch in device memory), over each level's
# output in plan order, on k7b_witness_case's inputs; "K3" keys hold K3's
# own bytes, which the shared polyexp tile body must not move. Computed
# by tools/torch_level_lk_ab.py on that commit, on an NVIDIA H100 80GB
# HBM3. 37x53 has no coarse level at any level count (OpenCV's 32-pixel
# floor), so 148x212 at 3 levels stands for it: coarse levels 37x53 and
# 74x106.
K7B_WITNESS = {
    "K7b 1080x1920 N=2 float32 n5":
        "e4902c6dae10942dc92c324240874a054605d2b9f726d398e78b65cf01eb2f14",
    "K4 1080x1920 N=1 float32 n5":
        "b21a59dd01fdaa4b686855bd37d076cade562cd416df8e6aa93c2e2cdf4dbc88",
    "K7b 1080x1920 N=2 float32 n7":
        "5a317db662a80f18080281f8077b1c719ace1bcead20eb80f07adc2da963c0b2",
    "K4 1080x1920 N=1 float32 n7":
        "6db4f3e6ebadf0898395f2a1b56c409063a2ac17e78f3f119e3ebe4c355becd0",
    "K7b 1080x1920 N=2 bfloat16 n5":
        "9d0b01e205d02c833f346a18184986e81bf63e92cd289752a4d2a13280643f8f",
    "K4 1080x1920 N=1 bfloat16 n5":
        "4028a7d00b4c77f6b477c7f31e5b6eb228412491f1a3a9e7686042e64cf0aa53",
    "K7b 1080x1920 N=2 bfloat16 n7":
        "b79463fd79657e2b5edb4e8fae91881d1e70095cc894f02bae8815a6195d8939",
    "K4 1080x1920 N=1 bfloat16 n7":
        "1930c3742b57004d6ea6a4683c356d78bb9e60657e946b8ca0295af2552d5be4",
    "K7b 720x1280 N=2 float32 n5":
        "7c1b59bf9e68eb98cc91dc7a49ba408f1c9bfad931b0f5c0af696145d4d50570",
    "K4 720x1280 N=1 float32 n5":
        "18d6fedb22203271933d9801bcb1bf38992b9932bacf796110363467cdda17d8",
    "K7b 720x1280 N=2 float32 n7":
        "b5658d614d4eb147b7785e086b60b37eeab9b3f35d3415e9aba1cc0143cea755",
    "K4 720x1280 N=1 float32 n7":
        "1fa04bd61ac6333ebdf733ec67a423ac4824fb66add4737eb8fd1da9ad20d390",
    "K7b 720x1280 N=2 bfloat16 n5":
        "47bcd4ccc989b3af7223f0d9ae1b4a55d5c2a860a7bd5b7f20e8d41a77839145",
    "K4 720x1280 N=1 bfloat16 n5":
        "8ce947fefdc28d36578e878a9b962bf80a3e321e82d54422cba6f74572ce7df1",
    "K7b 720x1280 N=2 bfloat16 n7":
        "b69b3c91e82eb41179ff339959d7d6e969d27adb02587255c6ccbdc2250c01ea",
    "K4 720x1280 N=1 bfloat16 n7":
        "d734b5e375dcfb2ef902dbc3d0012aa6ed2078805e163043cbbcad1264706f52",
    "K7b 148x212 N=3 float32 n5":
        "342eca6c79fff810cf7b31ac19bb6c03f8183890f44b36d6d2a7e5dc8878c6d4",
    "K4 148x212 N=1 float32 n5":
        "8e8710171c1c4ea4b2379bfa52f79287b7276bed840045cbbde6fd5e65237efd",
    "K7b 148x212 N=3 float32 n7":
        "046360cf5d0e13f926e87bd5226ffe31ac6e05af80c2d293402deb7ccb27975c",
    "K4 148x212 N=1 float32 n7":
        "e1dea1ae439987b2405a81919de96f43b94539decf0131b266d3cbdc245cbf81",
    "K7b 148x212 N=3 bfloat16 n5":
        "d0a9add86811f49fca9f557394cd756ae5b5c6c55142539a5d5ab124cdc612a5",
    "K4 148x212 N=1 bfloat16 n5":
        "b9a1bb20f89c8b25199d779529df11a58eb4aaaa809b0c75870d0970679ad2e6",
    "K7b 148x212 N=3 bfloat16 n7":
        "4c4080b4282d7200cdf8d9a6a6a45d613249e5b83594ad4cc4e368602a15b048",
    "K4 148x212 N=1 bfloat16 n7":
        "c0c921f24befa180322b8536e9a18cf4466b7434dcab3fab6a0c0723b5a97818",
    "K3 1080x1920 N=1 float32 n5":
        "83023a48b9e9be3e8157f35d50017ffd6957c322d20981472537ec922677cbab",
    "K3 1080x1920 N=1 float32 n7":
        "7771ed2d007f33c48a75f7622dfa1c43fd6024cec6717c261ace21f52cd80ff1",
    "K3 1080x1920 N=1 bfloat16 n5":
        "1c46208a5e73f590f23c4a6caa5fa3d378ab2f19994223af858e9591af1f36bd",
    "K3 1080x1920 N=1 bfloat16 n7":
        "8f6750aebd8756764209c65465df168a406037d033e2ac0f5da4784185f948a1",
}
K7B_SHAPES = {(1080, 1920): (2, 5), (720, 1280): (2, 5), (148, 212): (3, 3)}
POLY_SIGMA = {1: 0.6, 3: 0.9, 5: 1.1, 7: 1.5}


def k7b_witness_keys() -> list:
    keys = []
    for (h, w), (nf, _lv) in K7B_SHAPES.items():
        for dt in ("float32", "bfloat16"):
            for n in (5, 7):
                keys += [f"K7b {h}x{w} N={nf} {dt} n{n}",
                         f"K4 {h}x{w} N=1 {dt} n{n}"]
    return keys + [f"K3 1080x1920 N=1 {dt} n{n}"
                   for dt in ("float32", "bfloat16") for n in (5, 7)]


def k7b_witness_case(key, dev):
    """The inputs of a K7B_WITNESS key, "<K7b|K4|K3> <h>x<w> N=<frames>
    <dtype> n<poly_n>": (kind, (N, h, w) f32 frames on dev (K4 and K3
    take frame 0 of the shape's K7b stack), (levels, pyr_scale, poly_n,
    poly_sigma), out dtype). The frames are u8-scale uniform noise from
    numpy's legacy generator (the same numbers on every machine)."""
    kind, shape, frames, dt, pn = key.split()
    h, w = map(int, shape.split("x"))
    nf, levels = K7B_SHAPES[(h, w)]
    n = int(pn[1:])
    rs = np.random.RandomState(9)
    imgs = (rs.random_sample((nf, h, w)) * 255).astype(np.float32)
    imgs = torch.from_numpy(imgs[:int(frames[2:])]).to(dev)
    return kind, imgs, (levels, 0.5, n, POLY_SIGMA[n]), getattr(torch, dt)


def tensors_hash(ts) -> str:
    """sha256 of the tensors' bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def k7b_witness_hash(key, dev) -> str:
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_polyexp_fused, coarse_polyexp_fused_batch)
    from kalman_hydra_tpu_torch.kernels.polyexp import poly_expansion_planar
    kind, imgs, args, dt = k7b_witness_case(key, dev)
    if kind == "K7b":
        outs = coarse_polyexp_fused_batch(imgs, *args, out_dtype=dt)
    elif kind == "K4":
        outs = coarse_polyexp_fused(imgs[0], *args, out_dtype=dt)
    else:
        outs = [poly_expansion_planar(imgs[0], args[2], args[3], dt)]
    return tensors_hash(outs)


@phase("device launches a call of K4, K7b, K12's and K5's walks, K3, "
       "K7a, K11 and K1 (profiler)")
def check_launches(dev, clip, clip_b, cfg, cfg_h):
    """torch.profiler's device kernels of one call of K4 (a 1080p frame),
    K7b (B's 17 720p frames, and 4 x 9 1080p frames as path C), K12's
    walk (a 1080p frame pair of path H), K5's walk (the gated levels of a
    1080p frame pair of path A), K3 (a 1080p frame), K7a (C's 36
    frames), K11 (a 1080p frame's five coarse levels) and K1 (K = 1024,
    from z, the prediction written too): one each, where the routes they
    replaced made 15 (five coarse levels x vertical, horizontal, K3), 5
    (a level each, and the glue between), 4 (a level each, and the
    resizes between) and 10 (K11: two a level)."""
    from kalman_hydra_tpu_torch.kernels.ekf import ekf_predict_update
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_level_images, coarse_polyexp_fused,
        coarse_polyexp_fused_batch)
    from kalman_hydra_tpu_torch.kernels.flow_level import fits, flow_levels
    from kalman_hydra_tpu_torch.kernels.lk import lk_sparse_levels
    from kalman_hydra_tpu_torch.kernels.polyexp import (
        poly_expansion_planar, poly_expansion_planar_batch)
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.farneback import polyexp_pyramid
    from kalman_hydra_tpu_torch.ops.lk import lk_pyramid
    from kalman_hydra_tpu_torch.ops.pyramid import gaussian_blur_level
    f = cfg.flow
    args = (f.levels, f.pyr_scale, f.poly_n, f.poly_sigma)
    bf = torch.bfloat16
    g0, g1, pts = k12_witness_inputs(dev, clip)
    grays_b = grayscale_u8(torch.from_numpy(clip_b).to(dev))
    grays_c = g0.expand(N_CLIPS * T, H, W).contiguous()
    fl = cfg_h.flow
    pa, pb = lk_pyramid(g0, fl), lk_pyramid(g1, fl)
    ra, rb = polyexp_pyramid(g0, f), polyexp_pyramid(g1, f)
    R0s = [R for R in ra if fits(R.shape[1], R.shape[2], 2)]
    R1s = rb[:len(R0s)]
    fl0 = torch.zeros((2,) + tuple(R0s[0].shape[1:]), device=dev)
    img0 = gaussian_blur_level(g0, f, k=0)
    imgs0 = img0.expand(N_CLIPS * T, H, W).contiguous()
    calls = {
        "K4 1080x1920": lambda: coarse_polyexp_fused(g0, *args,
                                                     out_dtype=bf),
        f"K7b {H_B}x{W_B} N={T_B}": lambda: coarse_polyexp_fused_batch(
            grays_b, *args, out_dtype=bf),
        f"K7b {H}x{W} N={N_CLIPS * T}": lambda: coarse_polyexp_fused_batch(
            grays_c, *args, out_dtype=bf),
        "K12 walk, 5 levels, K=1024": lambda: lk_sparse_levels(
            pa[0], pb[0], pa[1], pts, fl.lk_winsize, fl.lk_max_iter,
            fl.lk_eps, fl.lk_min_eig, fl.lk_block_halo),
        f"K5 walk, {len(R0s)} levels": lambda: flow_levels(
            R0s, R1s, fl0, f.winsize, f.fast_warp, f.iterations, False,
            f.pyr_scale),
        "K3 1080x1920": lambda: poly_expansion_planar(
            img0, f.poly_n, f.poly_sigma, bf),
        f"K7a {H}x{W} N={N_CLIPS * T}": lambda: poly_expansion_planar_batch(
            imgs0, f.poly_n, f.poly_sigma, bf),
        "K11 1080x1920": lambda: coarse_level_images(g0, f.levels,
                                                     f.pyr_scale),
        "K1 K=1024 from z": lambda: ekf_predict_update(*k1_args)}
    k1_args = k1_witness_case("K1 K=1024 n=6 H2", dev)
    # the process's first profiler session has been seen to record no
    # device event (the first call below, warmed or not): open one on a
    # throwaway kernel first
    device_launches(lambda: torch.ones(8, device=dev).add_(1))
    bad = []
    for name, fn in calls.items():
        # warmed and timed first, as tools/torch_level_lk_ab.py does: a
        # cold K7b call profiled at once has been seen to record no
        # device event
        cuda_ms(fn, 3)
        device_ms(fn, 3)
        ev = device_launches(fn)
        log(f"  {name}: {len(ev)} device launch(es) a call: "
            + "; ".join(f"{nm[:48]} {us:.1f} us" for nm, us in ev))
        if len(ev) != 1:
            bad.append(name)
    assert not bad, f"not one device launch a call: {bad}"


@phase("K7b and K4 against the 15-launch route's outputs (bit for bit)")
def check_k7b_witness(dev):
    """K7b and K4 in one launch against the route they replaced (per
    coarse level a vertical, a horizontal and a K3 launch): their output
    bytes on every K7B_WITNESS case (1080x1920 and 720x1280 N=2, 148x212
    N=3; f32 and bf16; poly_n 5 and 7) hash to the old route's, and K3's
    own bytes (the shared tile body) to K3's before it."""
    bad = []
    for key, want in K7B_WITNESS.items():
        same = k7b_witness_hash(key, dev) == want
        log(f"  {key}: {'same bytes' if same else 'DIFFERENT bytes'} as "
            f"the old route")
        if not same:
            bad.append(key)
    assert not bad, f"K7b/K4/K3 differ from the old route on {bad}"


# Odd shapes: one short band (1x5), levels smaller than one tile (20x30,
# 37x53), ragged bands and columns (70x90, 45x100: 100 is not a multiple
# of the 64-column tile) and a ragged 1080p-sized frame.
FI_ODD_SIZES = ((37, 53), (70, 90), (1, 5), (20, 30), (45, 100),
                (1079, 1919))


def smooth_flow(h, w, dev):
    """A smooth prior flow (+-2.5 px across, +-1.5 px down), as the
    coarse-to-fine warm start gives the fine levels: K2's gathers of R1
    then fall on few rows, where the random +-3 px flow of the timed
    calls scatters them over seven."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([2.5 * torch.sin(xx * (2 * np.pi / 300)),
                        1.5 * torch.cos(yy * (2 * np.pi / 200))]).to(dev)


@phase("K2 flow_iter")
def check_k2(dev, cfg, results):
    """K2 on the six 1080p levels and the odd shapes, random planes and a
    random prior flow of +-10 px (beyond the +-8 clamp), f32 and bf16
    planes, box and Gaussian windows at the configuration's winsize (the
    kernel's taps-15 build) and at winsizes 5 and 31 (its generic build):
    against the plain version (< 1e-4). Timed at 1080p bf16 on a random
    +-3 px flow (the table's figure, as in earlier runs) and on a smooth
    one."""
    from kalman_hydra_tpu_torch.kernels.flow_iter import (TILE, flow_iter,
                                                          flow_iter_plain)
    from kalman_hydra_tpu_torch.ops.pyramid import farneback_levels
    f = cfg.flow
    g = torch.Generator().manual_seed(2)
    worst = 0.0
    shapes = [(lh, lw) for (_k, lh, lw, _s, _ks)
              in farneback_levels(H, W, f.levels, f.pyr_scale)]
    for lh, lw in shapes + list(FI_ODD_SIZES):
        R0 = torch.randn(5, lh, lw, generator=g).to(dev)
        R1 = torch.randn(5, lh, lw, generator=g).to(dev)
        fl = (torch.rand(2, lh, lw, generator=g) * 20 - 10).to(dev)
        line = []
        wins = (f.winsize,) if (lh, lw) in shapes else (f.winsize, 5, 31)
        for dt in (torch.float32, torch.bfloat16):
            a, b = R0.to(dt), R1.to(dt)
            for gw in (False, True):
                for ws in wins:
                    e = max_err(flow_iter(a, b, fl, ws, f.fast_warp, gw),
                                flow_iter_plain(a, b, fl, ws, f.fast_warp,
                                                gw))
                    worst = max(worst, e)
                    line.append(f"{str(dt)[6:]}{'/g' if gw else ''}"
                                f"{'' if ws == f.winsize else '/w%d' % ws} "
                                f"{e:.1e}")
        log(f"  K2 {lh}x{lw}: " + ", ".join(line))
    log(f"  K2 max_abs_err {worst:.3e} (bar 1e-4, f32 and bf16 planes)")
    assert worst < 1e-4
    R0 = torch.randn(5, H, W, generator=g).to(dev).to(torch.bfloat16)
    R1 = torch.randn(5, H, W, generator=g).to(dev).to(torch.bfloat16)
    fl = (torch.rand(2, H, W, generator=g) * 6 - 3).to(dev)
    fs = smooth_flow(H, W, dev)
    ms = time_turns({
        "plain": lambda: flow_iter_plain(R0, R1, fl, f.winsize, f.fast_warp),
        "kernel": lambda: flow_iter(R0, R1, fl, f.winsize, f.fast_warp),
        "smooth": lambda: flow_iter(R0, R1, fs, f.winsize, f.fast_warp)})
    log(f"  K2 time ({H}x{W}, bf16 planes, tile {TILE[0]}x{TILE[1]}): "
        f"random flow {ms['kernel']:.4f} ms per call, "
        f"{ms['kernel dev']:.4f} on the device; smooth flow "
        f"{ms['smooth']:.4f}, {ms['smooth dev']:.4f} on the device")
    taps = 2 * (f.winsize // 2) + 1
    record(results, "flow_iter", worst, ms["kernel"], ms["plain"],
           H * W * (10 * 2 + 8 + 8), H * W * fi_flops(taps), dev=ms)
    results["flow_iter"]["smooth_device_ms"] = ms["smooth dev"]


# sha256 of the output bytes of the three-launch K2 that the fused kernel
# replaced (commit 2f41914, M and its vertical pass in device memory) on
# witness_inputs at winsize 15, max_disp 8, computed as check_k2_witness
# computes them, on an NVIDIA H100 80GB HBM3. K5 at one iteration gave
# the same bytes there.
K2_WITNESS = {
    "1080x1920 float32 box":
        "051ac8a57f592d4177b5ae15148007dcd1c5ddfba6a9bf47a4f5cb310c2c70a5",
    "1080x1920 float32 gauss":
        "0228dcb69f7c7f6ef257fefdf2a6b07d6a8a43ab9939cf01243ad8f9e7d42bf2",
    "1080x1920 bfloat16 box":
        "ee50d084b09e585607c9febcaf80b366ac0463896d94bff4c7f91f8e37fae999",
    "1080x1920 bfloat16 gauss":
        "b4a5c359024cd51b9df85b8712e3a270f5706655825e5dbf2988faf5242e00af",
    "540x960 float32 box":
        "01a1c2a805f476050f4621c777db644d2786aab25cbd93bac0212a1e0bc7a3c7",
    "540x960 float32 gauss":
        "0d646bfa70aea1c6fb34609175924819ca8d6def2cb82472633eea06390957f5",
    "540x960 bfloat16 box":
        "21a47aa339f087111bf19fe51e5a51f3a6ae58887f11d62bad3c6afea1f4bb65",
    "540x960 bfloat16 gauss":
        "341968987e4e4453c1b22669afc1db5e06a8931dd8b077faf97164549ca91e5d",
    "37x53 float32 box":
        "d8b38baceb907f3b0b41e7ce34f60e32e11e6d40402fd1698a9f88d2cb275d7c",
    "37x53 float32 gauss":
        "649beee59c1c696b6382d76ae9d80fe0c163d1ab0d538dcaf1ca242860f6dbd7",
    "37x53 bfloat16 box":
        "867cb387d09a26416a77f9a3ee3c4e34595a4e5cec2ed700fe8e49eb1cd78e97",
    "37x53 bfloat16 gauss":
        "01786c87c6fa43853b8103fc78c747b425fe3951e044e6b22510b8e2e2f35c20",
}


def witness_inputs(h, w, seed=7):
    """R0, R1 (5, h, w) and a +-10 px prior flow (2, h, w), f32, from
    numpy's legacy generator (the same numbers on every machine)."""
    rs = np.random.RandomState(seed)
    R0 = rs.standard_normal((5, h, w)).astype(np.float32)
    R1 = rs.standard_normal((5, h, w)).astype(np.float32)
    fl = (rs.random_sample((2, h, w)) * 20 - 10).astype(np.float32)
    return R0, R1, fl


@phase("K2 against the three-launch K2's outputs (bit for bit)")
def check_k2_witness(dev):
    """The fused K2 against the old K2 it replaced: its output bytes on
    witness_inputs at 1080x1920, 540x960 and 37x53 (f32 and bf16 planes,
    box and Gaussian windows) hash to K2_WITNESS; and K5 at one iteration
    (flow_level, the walk's one-level launch) gives the same output bit
    for bit."""
    import hashlib
    from kalman_hydra_tpu_torch.kernels.flow_iter import flow_iter
    from kalman_hydra_tpu_torch.kernels.flow_level import flow_level
    bad = []
    for key in K2_WITNESS:
        shape, dt, win = key.split()
        h, w = map(int, shape.split("x"))
        R0, R1, fl = (torch.from_numpy(a).to(dev)
                      for a in witness_inputs(h, w))
        dt = getattr(torch, dt)
        a, b = R0.to(dt), R1.to(dt)
        out = flow_iter(a, b, fl, 15, 8, win == "gauss")
        same_hash = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest() \
            == K2_WITNESS[key]
        e5 = max_err(out, flow_level(a, b, fl, 15, 8, 1, win == "gauss"))
        log(f"  K2 {key}: {'same bytes' if same_hash else 'DIFFERENT bytes'}"
            f" as the three-launch K2; vs K5 at one iteration {e5:.1e}")
        if not same_hash or e5 != 0.0:
            bad.append(key)
    assert not bad, f"the fused K2 differs from the old one on {bad}"


@phase("K5 flow_levels (the walk) and flow_level (its one-level launch)")
def check_k5(dev, clip, cfg, results):
    """K5's walk over the 1080p levels under its gate, on the polyexp
    planes of frames 0 and 1 and a random prior flow of +-3 px at the
    coarsest: against the plain version (< 1e-4; f32 and bf16 planes, box
    and Gaussian windows) and against the per-level route of one-level
    launches with resize_linear between them (bit for bit); the one-level
    launch on every gated level against 3 K2 launches (bit for bit).
    Timed at bf16 against the per-level route and the plain version."""
    from kalman_hydra_tpu_torch.kernels.flow_iter import flow_iter
    from kalman_hydra_tpu_torch.kernels.flow_level import (
        MAX_LEVELS, fits, flow_level, flow_levels, flow_levels_plain)
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.farneback import polyexp_pyramid
    from kalman_hydra_tpu_torch.ops.pyramid import farneback_levels
    f = cfg.flow
    f32 = dataclasses.replace(f, bf16_poly=False)
    grays = [grayscale_u8(torch.from_numpy(clip[i]).to(dev)) for i in (0, 1)]
    pyrs = [polyexp_pyramid(gr, f32) for gr in grays]
    gated = [i for i, R in enumerate(pyrs[0])
             if fits(R.shape[1], R.shape[2], 2)]
    g = torch.Generator().manual_seed(5)
    D, it, wins, ps = f.fast_warp, f.iterations, f.winsize, f.pyr_scale
    lh, lw = pyrs[0][gated[0]].shape[1:]
    fl = (torch.rand(2, lh, lw, generator=g) * 6 - 3).to(dev)
    worst = worst_route = worst_k2 = 0.0
    for dt in (torch.float32, torch.bfloat16):
        R0s = [pyrs[0][i].to(dt) for i in gated]
        R1s = [pyrs[1][i].to(dt) for i in gated]
        for gw in (False, True):
            got = flow_levels(R0s, R1s, fl, wins, D, it, gw, ps)
            e = max_err(got, flow_levels_plain(R0s, R1s, fl, wins, D, it,
                                               gw, ps))
            e1 = max_err(got, k5_route(R0s, R1s, fl, wins, D, it, gw, ps))
            worst, worst_route = max(worst, e), max(worst_route, e1)
            log(f"  K5 walk {[tuple(R.shape[1:]) for R in R0s]} "
                f"{str(dt)[6:]}{'/gauss' if gw else ''}: vs plain {e:.2e}, "
                f"vs the per-level route {e1:.1e}")
            for a, b in zip(R0s, R1s):
                pr = (torch.rand(2, *a.shape[1:], generator=g) * 6
                      - 3).to(dev)
                via = pr
                for _ in range(it):
                    via = flow_iter(a, b, via, wins, D, gw)
                worst_k2 = max(worst_k2, max_err(
                    flow_level(a, b, pr, wins, D, it, gw), via))
    log(f"  K5 over the {len(gated)} gated levels: max_abs_err vs plain "
        f"{worst:.3e} (bar 1e-4); vs the per-level route {worst_route:.1e}"
        f" and one level vs {it} x K2 {worst_k2:.1e} (bar 0)")
    assert gated and worst < 1e-4 and worst_route == 0.0 and worst_k2 == 0.0
    # pyr_scale 0.8 gates 11 levels of a 1080p frame, more than one walk
    # takes: a walk for each MAX_LEVELS of them, the resize between
    rs = np.random.RandomState(17)
    deep = [(lh, lw) for (_k, lh, lw, _s, _ks)
            in farneback_levels(H, W, 20, 0.8) if fits(lh, lw, 2)]
    R0d, R1d = ([torch.from_numpy(rs.standard_normal((5, lh, lw)).astype(
        np.float32)).to(dev).to(torch.bfloat16) for lh, lw in deep]
        for _ in (0, 1))
    fd = torch.zeros((2,) + deep[0], device=dev)
    before = flow_levels.launches
    got = flow_levels(R0d, R1d, fd, wins, D, it, False, 0.8)
    walks = flow_levels.launches - before
    same = torch.equal(got, k5_route(R0d, R1d, fd, wins, D, it, False, 0.8))
    log(f"  K5 over 1080p's {len(deep)} gated levels at pyr_scale 0.8: "
        f"{walks} walks; {'the same bytes' if same else 'DIFFERENT bytes'}"
        f" as the per-level route")
    assert len(deep) > MAX_LEVELS and same
    assert walks == -(-len(deep) // MAX_LEVELS)
    R0s = [pyrs[0][i].to(torch.bfloat16) for i in gated]
    R1s = [pyrs[1][i].to(torch.bfloat16) for i in gated]
    ms = time_turns({
        "plain": lambda: flow_levels_plain(R0s, R1s, fl, wins, D, it, False,
                                           ps),
        "kernel": lambda: flow_levels(R0s, R1s, fl, wins, D, it, False, ps),
        "route": lambda: k5_route(R0s, R1s, fl, wins, D, it, False, ps)})
    log(f"  K5 walk bf16: {ms['kernel']:.4f} ms per call "
        f"({ms['kernel dev']:.4f} on the device); the per-level route "
        f"{ms['route']:.4f} ms ({ms['route dev']:.4f}); plain "
        f"{ms['plain']:.4f} ms")
    px = sum(R.shape[1] * R.shape[2] for R in R0s)
    taps = 2 * (wins // 2) + 1
    # the planes of every level and the prior in, the last flow out
    record(results, "flow_levels", worst, ms["kernel"], ms["plain"],
           px * 10 * 2 + fl.numel() * 4 + 8 * R0s[-1].shape[1]
           * R0s[-1].shape[2], it * px * fi_flops(taps), dev=ms)
    results["flow_levels"].update(route_ms=ms["route"],
                                  route_device_ms=ms["route dev"])


@phase("K5's walk against the per-level route's outputs (bit for bit)")
def check_k5_witness(dev):
    """The walk (one launch for every gated level, the resizes inside)
    against the route it replaced: its output bytes on every K5_WITNESS
    case (1080x1920, 720x1280 and 150x203; f32 and bf16; box and
    Gaussian; zero and random prior) hash to the old route's."""
    from kalman_hydra_tpu_torch.kernels.flow_level import flow_levels
    bad = []
    for key, want in K5_WITNESS.items():
        same = k5_witness_hash(key, dev, flow_levels) == want
        log(f"  {key}: {'same bytes' if same else 'DIFFERENT bytes'} as "
            f"the old route")
        if not same:
            bad.append(key)
    assert not bad, f"K5's walk differs from the old route on {bad}"


@phase("K7a against the first design's outputs (bit for bit)")
def check_k7a_witness(dev):
    """K7a (the redesigned polyexp, K3's kernel) on every K7A_WITNESS case
    (720x1280 N=17 at poly_n 1, 3, 5 and 7, 1080x1920 N=36 at 5 and 7;
    f32 and bf16) hashes to the first design's bytes."""
    bad = []
    for key, want in K7A_WITNESS.items():
        same = k7a_witness_hash(key, dev) == want
        log(f"  {key}: {'same bytes' if same else 'DIFFERENT bytes'} as "
            f"the first design")
        if not same:
            bad.append(key)
    assert not bad, f"K7a differs from the first design on {bad}"


# sha256 of the output bytes of the route that K5's walk replaced (commit
# fad7b1c: one K5 launch a gated level, with resize_linear(...) * (1 /
# pyr_scale) between them, as farneback_from_pyramids ran it), the finest
# gated level's flow, on k5_witness_case's inputs at winsize 15, max_disp
# 8, 3 iterations, pyr_scale 0.5. Computed by tools/torch_walk_ab.py on
# that commit, on an NVIDIA H100 80GB HBM3.
K5_WITNESS = {
    "K5 1080x1920 float32 box zero":
        "6a5c3561c8374ab851982d368b7560213532af36ea44f3ca3b6ef17524202f7a",
    "K5 1080x1920 float32 box prior":
        "d32098bdfde1947a003fea7c8f0733307df4534184502ada7da86f532527920d",
    "K5 1080x1920 float32 gauss zero":
        "c08a02ee41d343c6c0f9aa39a9f5a0ae52cf4c543757a8e0b498fe2843c6cfbc",
    "K5 1080x1920 float32 gauss prior":
        "e2df9be5e32b64b53274169ee21fd74baa512f6dc2a42a99386f7a4311097ebc",
    "K5 1080x1920 bfloat16 box zero":
        "81708e3e7d19d328b00a49474022727684063cf09a5771a81a21c7cb3d35a656",
    "K5 1080x1920 bfloat16 box prior":
        "50f47f810b19d3636b2c43cbd70d825e89bed973e88cc52b5e94a10221ab6899",
    "K5 1080x1920 bfloat16 gauss zero":
        "844a45fb891b989c2f2b4e4d85d0e2b8d43d6df85db9a16ff13c47831ed3dc78",
    "K5 1080x1920 bfloat16 gauss prior":
        "5d8a16aa5ffdb7be33353c1e5206d89c931be4e34b8f6f1fd4692dcdf859ea8f",
    "K5 720x1280 float32 box zero":
        "814f48f4d66af8de0a53e47875bfff728beeb0b1e78dedcf2bb0a243602873c7",
    "K5 720x1280 float32 box prior":
        "ffe99e3de68e19ab1ce3991a1de7520cb183a152e91ad9a81918cd128528ad4d",
    "K5 720x1280 float32 gauss zero":
        "95bc96328c9c197d59ab8073e9688c54a1c318e330821e127031d399e2ea5f26",
    "K5 720x1280 float32 gauss prior":
        "d886d7e5ccb14e9946c3b8834744562b87e0a90ff17e4365849f09d5fdc52dce",
    "K5 720x1280 bfloat16 box zero":
        "76cdb6a5a34ee04d0b45b515eb88703540b110030d731aa36fa7d790455cf0d0",
    "K5 720x1280 bfloat16 box prior":
        "eed9a4be15e1c787aea78aef8b3a955a77c825c1681c67dfc8bde19cff542575",
    "K5 720x1280 bfloat16 gauss zero":
        "4b67aa6a5c780f799ff4fe03422acaab8733ef501992083adfcfa5c10eee570f",
    "K5 720x1280 bfloat16 gauss prior":
        "6a53c4c5826f9f1f020d0f4fac9900f52d98d924fb02c1e5d3efdcda558b3cdf",
    "K5 150x203 float32 box zero":
        "1d5aa934b20a81f2319b95594f12fa0ba160b8d3d986520eb812641c2dd054c4",
    "K5 150x203 float32 box prior":
        "58f7250b0e1050a6a94c5d52871b006ad03372464a6084147d224794c0460886",
    "K5 150x203 float32 gauss zero":
        "77883d8e34aa777b64c618a23292858adfdce02d587cae533da58970411b4239",
    "K5 150x203 float32 gauss prior":
        "33efaaec867b1a53db85e8476d2058d19103f4f1b7206516214871c36d83c2cf",
    "K5 150x203 bfloat16 box zero":
        "387d27d2198d8a4b6c16ff144551b3a5a0d912e9e93e4c38b88d371058242dc7",
    "K5 150x203 bfloat16 box prior":
        "05832a8fd5aa372d9245c8ca7ced29d2fbbaa544b5c7badd1e4100117a613ac2",
    "K5 150x203 bfloat16 gauss zero":
        "33ab8db9e910a1bb57dbd1e11aee96f8ced6daed972e2ae890f15f8a9ca744a0",
    "K5 150x203 bfloat16 gauss prior":
        "8323f389c75029c2b25b19acc2cb18f7dbf1de9fb1f7e35badbdce926ae7ac4f",
}
K5_SHAPES = ((1080, 1920), (720, 1280), (150, 203))
K5_ARGS = (15, 8, 3)               # winsize, max_disp, iterations


def k5_witness_keys() -> list:
    return [f"K5 {h}x{w} {dt} {win} {prior}" for h, w in K5_SHAPES
            for dt in ("float32", "bfloat16") for win in ("box", "gauss")
            for prior in ("zero", "prior")]


def k5_witness_case(key, dev):
    """The inputs of a K5_WITNESS key, "K5 <h>x<w> <dtype> <box|gauss>
    <zero|prior>": (R0s, R1s, flow, gaussian). R0s and R1s are (5, lh,
    lw) planes of every level of the shape's Farneback plan (5 levels,
    pyr_scale 0.5) that passes K5's gate, coarsest first: standard normal
    from numpy's legacy generator (the same numbers on every machine),
    cast to the dtype; flow is the coarsest level's prior, zero or
    uniform in +-3 px."""
    from kalman_hydra_tpu_torch.kernels.flow_level import fits
    from kalman_hydra_tpu_torch.ops.pyramid import farneback_levels
    _, shape, dt, win, prior = key.split()
    h, w = map(int, shape.split("x"))
    dt = getattr(torch, dt)
    isz = torch.empty((), dtype=dt).element_size()
    rs = np.random.RandomState(13)
    R0s, R1s = [], []
    for (_k, lh, lw, _s, _ks) in farneback_levels(h, w, 5, 0.5):
        if not fits(lh, lw, isz):
            break
        for out in (R0s, R1s):
            out.append(torch.from_numpy(rs.standard_normal(
                (5, lh, lw)).astype(np.float32)).to(dev).to(dt))
    lh, lw = R0s[0].shape[1:]
    fl = np.zeros((2, lh, lw), np.float32)
    if prior == "prior":
        fl = (rs.random_sample((2, lh, lw)) * 6 - 3).astype(np.float32)
    return R0s, R1s, torch.from_numpy(fl).to(dev), win == "gauss"


def k5_route(R0s, R1s, flow, winsize, max_disp, iters, gaussian,
             pyr_scale):
    """The gated levels as farneback_from_pyramids ran them before the
    walk: one K5 launch a level, the flow resized and scaled between."""
    from kalman_hydra_tpu_torch.kernels.flow_level import flow_level
    from kalman_hydra_tpu_torch.ops.pyramid import resize_linear
    for i, (a, b) in enumerate(zip(R0s, R1s)):
        if i:
            flow = resize_linear(flow, a.shape[1], a.shape[2]) * (
                1.0 / pyr_scale)
        flow = flow_level(a, b, flow, winsize, max_disp, iters, gaussian)
    return flow


def k5_witness_hash(key, dev, walk) -> str:
    """The hash of `walk(R0s, R1s, flow, winsize, max_disp, iters,
    gaussian, pyr_scale)` on the key's case (flow_levels or k5_route)."""
    R0s, R1s, fl, gw = k5_witness_case(key, dev)
    return tensors_hash([walk(R0s, R1s, fl, *K5_ARGS, gw, 0.5)])


# sha256 of K7a's output bytes before its redesign (commit fad7b1c: one
# 16 x 64 tile a block, taps read from shared memory) on k7a_witness_case's
# frames; computed by tools/torch_walk_ab.py on that commit (poly_n 1 and
# 3 on 9f5b788, which still ran that design for them), on an NVIDIA H100
# 80GB HBM3.
K7A_WITNESS = {
    "K7a 720x1280 N=17 float32 n1":
        "0daaf9569bbb3acbd6e6c85c0ea66c15ba3235d98c6a0b5d520f6fd918329fbc",
    "K7a 720x1280 N=17 float32 n3":
        "37680b0f5dca99ab58be49ed575b6dd69a810552aa751a17f4f2b1d601453c6b",
    "K7a 720x1280 N=17 bfloat16 n1":
        "2ce173f288cca21aa5428bf58a2b3c1e3fbc8ae78083ed4ca93a79163975ad9c",
    "K7a 720x1280 N=17 bfloat16 n3":
        "1d0fb20a27b17ff65817a0e30f6577ce404cbf7295499db0744f544c998acedf",
    "K7a 720x1280 N=17 float32 n5":
        "dd3e149b7e225507e64ac6f009ab97c5d39f68bab38c61f7655803c468212a04",
    "K7a 720x1280 N=17 float32 n7":
        "5a98387d3e5c242576a172faf80a13efe7025a2c24d1bf3d8f0b8a4dff1f3f51",
    "K7a 720x1280 N=17 bfloat16 n5":
        "c79628a2c46cb802efe42fdcd1da6fbc00b54418f52dcef9f8388b50366fc742",
    "K7a 720x1280 N=17 bfloat16 n7":
        "508474b1ba7d0ad907673fe486dcc58cd93430f967cc371d99937458940a8001",
    "K7a 1080x1920 N=36 float32 n5":
        "4a4d7d7b9f25e5f1f8e86ce48b100cf3ca04a9e6b3b79536d0d4305c0500434d",
    "K7a 1080x1920 N=36 float32 n7":
        "54337f6d50d47705508fae04613b639ef7dea84a496859be337dba38265bf213",
    "K7a 1080x1920 N=36 bfloat16 n5":
        "c4baced56f964608577e338c2449428b642937b98af6622666ec35fe4c8d90c2",
    "K7a 1080x1920 N=36 bfloat16 n7":
        "2f724b3141e779923b5c0177e56d75bf4e1f5afe101424f8e4daca8debeaffb8",
}
K7A_SHAPES = ((720, 1280, 17), (1080, 1920, 36))


def k7a_witness_keys() -> list:
    """poly_n 5 and 7 at both shapes; 1 and 3 (which the first design
    served alone before the redesign) at the first."""
    return [f"K7a {h}x{w} N={nf} {dt} n{n}" for i, (h, w, nf)
            in enumerate(K7A_SHAPES) for dt in ("float32", "bfloat16")
            for n in ((5, 7) if i else (1, 3, 5, 7))]


def k7a_witness_hash(key, dev) -> str:
    """K7a on "K7a <h>x<w> N=<frames> <dtype> n<poly_n>": u8-scale uniform
    noise frames from numpy's legacy generator, as k7b_witness_case."""
    from kalman_hydra_tpu_torch.kernels.polyexp import (
        poly_expansion_planar_batch)
    _, shape, frames, dt, pn = key.split()
    h, w = map(int, shape.split("x"))
    n = int(pn[1:])
    rs = np.random.RandomState(9)
    imgs = torch.from_numpy((rs.random_sample((int(frames[2:]), h, w))
                             * 255).astype(np.float32)).to(dev)
    out = poly_expansion_planar_batch(imgs, n, POLY_SIGMA[n],
                                      getattr(torch, dt))
    return tensors_hash([out])


def update_flops(taps: int, gaussian: bool = False) -> int:
    """FLOPs per pixel that one K8 call needs: ~67 for the exact gather
    (the sample point and its weights, ~12; per plane 8 multiplies and 3
    adds, 55), ~39 for the damped normal equations, ~21 for the solve,
    and the two window passes over M's 5 planes counted as in
    fi_flops."""
    return 127 + (20 * taps if gaussian else 20)


@phase("K8 flow_update")
def check_k8(dev, clip, cfg, results):
    """K8 at each of the six 1080p level shapes, on path D's frame 0 -> 1
    pyramids (RunConfig(): f32 planes, and the same planes in bf16), box
    and Gaussian windows, zero and random +-2 px prior flows: against the
    plain version, the exact gather included (< 1e-4). Timed per level
    with the box window on the f32 planes, from the +-2 px flow and from
    zero; the kernels line keeps one frame pair's 6 x `iterations` calls
    (+-2 px)."""
    from kalman_hydra_tpu_torch.kernels.flow_update import (
        flow_update, flow_update_plain)
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.farneback import polyexp_pyramid
    f = cfg.flow
    grays = [grayscale_u8(torch.from_numpy(clip[i]).to(dev)) for i in (0, 1)]
    pyrs = [polyexp_pyramid(gr, f) for gr in grays]
    g = torch.Generator().manual_seed(8)
    taps = 2 * (f.winsize // 2) + 1
    worst = 0.0
    tot = {"kernel": 0.0, "plain": 0.0, "kernel dev": 0.0, "zero dev": 0.0}
    nbytes = flops = 0
    for R0, R1 in zip(*pyrs):
        lh, lw = R0.shape[1:]
        zero = torch.zeros(2, lh, lw, device=dev)
        fl = (torch.rand(2, lh, lw, generator=g) * 4 - 2).to(dev)
        line = []
        for fname, flow in (("zero", zero), ("+-2px", fl)):
            for dt in (torch.float32, torch.bfloat16):
                a, b = R0.to(dt), R1.to(dt)
                for gw in (False, True):
                    e = max_err(flow_update(a, b, flow, f.winsize, gw),
                                flow_update_plain(a, b, flow, f.winsize, gw))
                    worst = max(worst, e)
                    line.append(f"{fname}/{str(dt)[6:]}"
                                f"{'/gauss' if gw else ''} {e:.2e}")
        log(f"  K8 {lh}x{lw}: " + ", ".join(line))
        ms = time_turns({
            "plain": lambda: flow_update_plain(R0, R1, fl, f.winsize),
            "kernel": lambda: flow_update(R0, R1, fl, f.winsize),
            "zero": lambda: flow_update(R0, R1, zero, f.winsize)})
        log(f"  K8 {lh}x{lw} time: kernel {ms['kernel']:.4f} ms "
            f"({ms['kernel dev']:.4f} on the device; from a zero flow "
            f"{ms['zero dev']:.4f}), plain {ms['plain']:.4f} ms")
        for k in tot:
            tot[k] += f.iterations * ms[k]
        how = ms["kernel how"]
        nbytes += f.iterations * lh * lw * (4 * 10 + 8 + 8)
        flops += f.iterations * lh * lw * update_flops(taps)
    log(f"  K8 max_abs_err {worst:.3e} (bar 1e-4, every level, box and "
        f"Gaussian, zero and +-2 px flows, f32 and bf16 planes); one frame "
        f"pair's {f.iterations} x {len(pyrs[0])} calls {tot['kernel']:.4f} "
        f"ms, {tot['kernel dev']:.4f} on the device ({tot['zero dev']:.4f} "
        f"from zero flows)")
    assert worst < 1e-4
    record(results, "flow_update", worst, tot["kernel"], tot["plain"],
           nbytes, flops, dev=dict(tot, **{"kernel how": how}))
    results["flow_update"]["zero_flow_device_ms"] = tot["zero dev"]


# sha256 of the output bytes of the parent route that K8 and K8-pairs
# replaced (commit 8db1409: the plain torch gather ops/farneback.py::
# warp_poly_planar, after an index_select of each pair's second frame for
# K8-pairs, then the three-launch K8 / K8-pairs with M and Mv in device
# memory) on witness_inputs at winsize 15 (K8) and on
# witness_pair_inputs with round_m (K8-pairs), computed by
# tools/torch_k8_ab.py on that commit, on an NVIDIA H100 80GB HBM3.
K8_WITNESS = {
    "K8 1080x1920 float32 box":
        "fdd25775a8d063ec05bc3a98bcf6644ee406b006b88fd2fea06dc3a2472fe8a1",
    "K8 1080x1920 float32 gauss":
        "500c5a2082fed1cdcebc19bdb932e75bfdf2ceb3b9f93747e2f2838f854e240f",
    "K8 1080x1920 bfloat16 box":
        "4d4610270f37e2c4b5a6730e49d58dc32a5e5744616d6ccd7905a70379a45055",
    "K8 1080x1920 bfloat16 gauss":
        "f4835fcd32047fc01fce0ed52230ab59a69e3ed7ae133d3c85af66151fb9f3a5",
    "K8 540x960 float32 box":
        "85b13dcef0520d94e63a6fa52b05173f5d15b272360d521e40441ba11c3c17c3",
    "K8 540x960 float32 gauss":
        "d468961b91d8efb9634d4bf545069a62c04abee31bee13e5a49f5f08d4365388",
    "K8 540x960 bfloat16 box":
        "42789251ca399842e87d5d545a74b1952edfd871d7196c63709c9d04fe9df18c",
    "K8 540x960 bfloat16 gauss":
        "33aad0d611a114ba54a31920c33609e1357b71bcaa49cb7f0506eebbce6b4f0a",
    "K8 37x53 float32 box":
        "8429c74493e2277acbcbe5c332f05e7709237931bd06aff4740511b5a3bbea17",
    "K8 37x53 float32 gauss":
        "add8f10810e45e00013b157919b462e5d9c113a95edba6ca9a6f9e8cd1f58dfe",
    "K8 37x53 bfloat16 box":
        "3c4afd85692c772889e11354592728a0b2007e522bec8afe9a0c9845e3fd51e5",
    "K8 37x53 bfloat16 gauss":
        "64a1006fcacaa9223c52d8141b104405ae4d1bae4b3c9b341c9cc09d757f7e65",
    "K8-pairs 540x960 bfloat16 box":
        "e518fc482bc18c78e37fe4a126ddce43e835f2f5481c68db35ccc012f95c7ee7",
    "K8-pairs 540x960 bfloat16 gauss":
        "0544f8852ab8817454a0a0327d6ea48dd90c9dfae638b3d4ca2564753743c2e1",
    "K8-pairs 37x53 bfloat16 box":
        "fe6bbff9488ceaccef727911b7c96cce5e2dc2f65edd6882eb0a101a857088a6",
    "K8-pairs 37x53 bfloat16 gauss":
        "261221a06df1ee4670277d434eaa1afda09993159d91935ae31a34836f56c54c",
}


def witness_pair_inputs(h, w, n=6, clip_len=3, seed=11):
    """An (n, 5, h, w) plane stack of n // clip_len chained clips and the
    +-10 px prior flows (B, 2, h, w) of its B pairs, f32, from numpy's
    legacy generator."""
    rs = np.random.RandomState(seed)
    Rall = rs.standard_normal((n, 5, h, w)).astype(np.float32)
    B = (n // clip_len) * (clip_len - 1)
    fl = (rs.random_sample((B, 2, h, w)) * 20 - 10).astype(np.float32)
    return Rall, fl


def k8_witness_case(key, dev):
    """The inputs of a K8_WITNESS key, "K8 <h>x<w> <dtype> <box|gauss>"
    or "K8-pairs <h>x<w> <dtype> <box|gauss>" (clip_len 3, round_m),
    as a call: (kind, planes, flow, gaussian)."""
    kind, shape, dt, win = key.split()
    h, w = map(int, shape.split("x"))
    dt = getattr(torch, dt)
    if kind == "K8":
        R0, R1, fl = (torch.from_numpy(a).to(dev)
                      for a in witness_inputs(h, w))
        return kind, (R0.to(dt), R1.to(dt)), fl, win == "gauss"
    Rall, fl = (torch.from_numpy(a).to(dev)
                for a in witness_pair_inputs(h, w))
    return kind, (Rall.to(dt),), fl, win == "gauss"


@phase("K8 against the parent route's outputs (bit for bit)")
def check_k8_witness(dev):
    """K8 and K8-pairs, the gather in the kernel, against the parent
    route they replaced (the plain torch gather, then the three-launch
    kernel): their output bytes on every K8_WITNESS case (1080x1920,
    540x960 and 37x53, f32 and bf16 planes, box and Gaussian windows for
    K8; a bf16 stack of two chained 3-frame clips with M rounded to bf16
    for K8-pairs) hash to the parent's."""
    import hashlib
    from kalman_hydra_tpu_torch.kernels.flow_update import (
        flow_update, flow_update_pairs)
    bad = []
    assert K8_WITNESS, "no witness hashes"
    for key, want in K8_WITNESS.items():
        kind, planes, fl, gw = k8_witness_case(key, dev)
        if kind == "K8":
            out = flow_update(*planes, fl, 15, gw)
        else:
            out = flow_update_pairs(*planes, fl, 15, gw, 3, round_m=True)
        same = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest() \
            == want
        log(f"  {key}: {'same bytes' if same else 'DIFFERENT bytes'} as "
            f"the parent route")
        if not same:
            bad.append(key)
    assert not bad, f"K8 differs from the parent route on {bad}"


@phase("K11 coarse_level_images")
def check_k11(dev, gray, cfg, results):
    """K11 on a 1080p frame: the five coarse level images against the
    plain stage-by-stage blur + resize (bar 1e-2, the reference's)."""
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_level_images, coarse_level_images_plain, level_tables)
    f = cfg.flow
    args = (gray, f.levels, f.pyr_scale)
    got = coarse_level_images(*args)
    ref = coarse_level_images_plain(*args)
    errs = [max_err(a, b) for a, b in zip(got, ref)]
    log(f"  K11 levels {[tuple(a.shape) for a in got]}: max_abs_err per "
        f"level {['%.3e' % e for e in errs]} (bar 1e-2); measured max "
        f"{max(errs):.3e}")
    assert len(got) == len(ref) == 5 and max(errs) < 1e-2
    ms = time_turns({"plain": lambda: coarse_level_images_plain(*args),
                     "kernel": lambda: coarse_level_images(*args)}, reps=10)
    tabs = level_tables(H, W, f.levels, f.pyr_scale, 0)
    px = sum(lh * lw for (lh, lw, *_t) in tabs)
    fl = sum(2 * lh * W * iv.shape[1] + 2 * lh * lw * ih.shape[1]
             for (lh, lw, iv, _wv, ih, _wh) in tabs)
    record(results, "coarse_level_images", max(errs), ms["kernel"],
           ms["plain"], H * W * 4 + px * 4, fl, dev=ms)


K11_WITNESS = {
    "K11 1080x1920 L5 s0.5":
        "b7fdc6e177250720b2b698950219a34c105384a86f9f4eb92b9ceb9d63dd5b9e",
    "K11 720x1280 L5 s0.5":
        "9090f8948f4d0c9eccf85fe9a61a5d212f9bf5d6ec8f761382f72d6cd465cf63",
    "K11 150x203 L4 s0.5":
        "0c31025b23f01c07526976b0b2e84c0484ec6287cde429c6363c5bba0d71804b",
    "K11 1080x1920 L16 s0.8":
        "47219c4340ee312d0da1c4aca580147ce6abc98ec4f5788c99981a8726103c13",
}
K11_CASES = ((1080, 1920, 5, 0.5), (720, 1280, 5, 0.5), (150, 203, 4, 0.5),
             (1080, 1920, 16, 0.8))


def k11_witness_keys() -> list:
    return [f"K11 {h}x{w} L{lv} s{s}" for h, w, lv, s in K11_CASES]


def k11_witness_case(key, dev):
    """The inputs of a K11_WITNESS key, "K11 <h>x<w> L<levels>
    s<pyr_scale>": an (h, w) f32 image of u8-scale uniform noise from
    numpy's legacy generator, and (levels, pyr_scale)."""
    _, shape, lv, s = key.split()
    h, w = map(int, shape.split("x"))
    img = (np.random.RandomState(5).random_sample((h, w)) * 255).astype(
        np.float32)
    return torch.from_numpy(img).to(dev), (int(lv[1:]), float(s[1:]))


def k11_witness_hash(key, dev) -> str:
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_level_images)
    img, args = k11_witness_case(key, dev)
    return tensors_hash(coarse_level_images(img, *args))


K1_WITNESS = {
    "K1 K=1024 n=6 H2":
        "e1729fde8041f861ae1ba23ca338fcb5eb0a3f95626022786d107b2fadbcc180",
    "K1 K=1024 n=6 HK":
        "d6b218d52c90c6ccd4f051e2bf333aea9472af05f0c7153b8d1ae119845c23dd",
    "K1 K=256 n=4 H2":
        "67fe05a97d188444dc8b79dcd3c72b521081646d52e71b0421ce263cd878cd67",
    "K1 K=256 n=4 HK":
        "f0d0b2b8e54a897dc1fde2193d402d01dacc11645380065ae7b3edbe377bdb27",
    "K1 K=1000 n=6 H2":
        "74a3014a48ee002758b8252a170b083c2ca42018fd9c59fe4c398114053b334a",
}
K1_CASES = ((1024, 6, 0), (1024, 6, 1), (256, 4, 0), (256, 4, 1),
            (1000, 6, 0))


def k1_witness_keys() -> list:
    return [f"K1 K={k} n={n} H{'K' if per else '2'}"
            for k, n, per in K1_CASES]


def k1_witness_case(key, dev):
    """The inputs of a K1_WITNESS key, "K1 K=<tracks> n=<state> H<2|K>":
    x (K, n), P (K, n, n) SPD, y (K, 2), H (2, n) = [I2 0] or per track
    (K, 2, n), F, Q and r of EkfConfig(state_dim=n), all from numpy's
    legacy generator (the same numbers on every machine)."""
    from kalman_hydra_tpu_torch.config import EkfConfig
    from kalman_hydra_tpu_torch.models import dynamics
    _, ks, ns, hs = key.split()
    k, n = int(ks[2:]), int(ns[2:])
    cfg = EkfConfig(state_dim=n)
    rs = np.random.RandomState(3)
    x = (rs.standard_normal((k, n)) * 5).astype(np.float32)
    A = rs.standard_normal((k, n, n)).astype(np.float32)
    P = (A @ A.transpose(0, 2, 1) + np.eye(n, dtype=np.float32)).astype(
        np.float32)
    y = (rs.standard_normal((k, 2)) * 2).astype(np.float32)
    H = dynamics.position_H(cfg)
    if hs == "HK":
        H = (H + 0.1 * rs.standard_normal((k, 2, n))).astype(np.float32)
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (x, P, y, H)]
    return (*ts, dynamics.transition(cfg), dynamics.process_noise(cfg),
            cfg.r)


def k1_witness_hash(key, dev) -> str:
    from kalman_hydra_tpu_torch.kernels.ekf import ekf_fused_step
    return tensors_hash(ekf_fused_step(*k1_witness_case(key, dev)))


@phase("K11 against the two-launch route's outputs (bit for bit)")
def check_k11_witness(dev):
    """K11, one launch for every coarse level of a frame, on every
    K11_WITNESS case (1080x1920 and 720x1280 at 5 levels, 150x203 at 4,
    1080x1920 at 16 levels and pyr_scale 0.8): the bytes of the route it
    replaced (two launches a level through a scratch plane), one launch a
    call for up to 12 coarse levels (two for the 15 of the last case)."""
    from kalman_hydra_tpu_torch.kernels.level_image import (
        MAX_LEVELS, coarse_level_images, coarse_level_images_plain)
    bad = []
    for key, want in K11_WITNESS.items():
        img, (lv, sc) = k11_witness_case(key, dev)
        coarse_level_images.launches = 0
        got = coarse_level_images(img, lv, sc)
        launches = coarse_level_images.launches
        same = tensors_hash(got) == want
        err = max(max_err(a, b) for a, b in zip(
            got, coarse_level_images_plain(img, lv, sc)))
        log(f"  {key}: {'same bytes' if same else 'DIFFERENT bytes'} as "
            f"the old route; {launches} launches for {len(got)} levels; "
            f"vs plain {err:.3e} (bar 1e-2)")
        if not same or err >= 1e-2 or \
                launches != -(-len(got) // MAX_LEVELS):
            bad.append(key)
    assert not bad, f"K11 differs from the old route on {bad}"


@phase("K1 against the first design's outputs (bit for bit)")
def check_k1_witness(dev):
    """K1 (a group of lanes a track) on every K1_WITNESS case (K = 1024
    and 1000 at n = 6, 256 at n = 4; H shared or per track): the first
    design's bytes; and its frame-loop call from the measurement z
    (ekf_predict_update: the prediction written too) against its plain
    version (bar 1e-4)."""
    from kalman_hydra_tpu_torch.kernels.ekf import (
        ekf_predict_update, ekf_predict_update_plain)
    bad = []
    for key, want in K1_WITNESS.items():
        args = k1_witness_case(key, dev)
        same = k1_witness_hash(key, dev) == want
        x, P, y, H_ = args[:4]
        z = y + (x[:, :2] if H_.ndim == 2 else 0.0)
        err = max(max_err(a, b) for a, b in zip(
            ekf_predict_update(x, P, z, *args[3:]),
            ekf_predict_update_plain(x, P, z, *args[3:])))
        log(f"  {key}: {'same bytes' if same else 'DIFFERENT bytes'} as "
            f"the first design; from z, 5 outputs vs plain {err:.3e} "
            f"(bar 1e-4)")
        if not same or err >= 1e-4:
            bad.append(key)
    assert not bad, f"K1 differs from the first design on {bad}"


def flow_pair(dev, clip, f, expect, what):
    """api.flow of frames 0 -> 1 at 1080p through the kernels, with every
    launch counter reset before and read after (they must equal
    `expect`), against the composition of the kernels' plain versions on
    the card (mean EPE < 1e-3 px, the flow-pair bar)."""
    from kalman_hydra_tpu_torch import api, kernels
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    kernels.reset_launches()
    got = api.flow(clip[0], clip[1], f, device=dev)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    g0, g1 = (grayscale_u8(torch.from_numpy(clip[i]).to(dev))
              for i in (0, 1))
    ref = plain_flow(g0, g1, f)
    epe = torch.linalg.vector_norm(torch.from_numpy(got).to(dev) - ref,
                                   dim=-1)
    log(f"  {what}: launches {counts}; kernels vs plain mean EPE "
        f"{epe.mean().item():.3e} px (bar 1e-3), max "
        f"{epe.max().item():.3e}; finite {bool(np.isfinite(got).all())}")
    assert counts == {k: v for k, v in expect.items() if v}, expect
    assert np.isfinite(got).all() and epe.mean().item() < 1e-3


def flow_expected(f, h, w) -> dict:
    """Launches of one api.flow call: two frames' pyramids and one pair
    step of per_frame_expected, without K1."""
    from kalman_hydra_tpu_torch.config import EkfConfig, RunConfig
    e = per_frame_expected(RunConfig(flow=f, ekf=EkfConfig(
        measurement="implicit_flow")), h, w, 2)
    return {k: v for k, v in e.items() if k != "ekf_fused_step"}


@phase("F2: 16 levels at pyr_scale 0.8 (15 coarse levels) through api.flow")
def fault_f2(dev, clip, cfg):
    """K4 and K7b at more than 12 coarse levels: one launch for each run
    of 12 (K4 f32 and K7b bf16 against their plain versions), then the
    main path's flow at levels 16, pyr_scale 0.8 through api.flow (K4,
    K3, K5's walks, K2) against the plain route."""
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_polyexp_fused, coarse_polyexp_fused_batch,
        coarse_polyexp_fused_plain)
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    f = dataclasses.replace(cfg.flow, levels=16, pyr_scale=0.8)
    grays = grayscale_u8(torch.from_numpy(clip[:2]).to(dev))
    args = (f.levels, f.pyr_scale, f.poly_n, f.poly_sigma)
    coarse_polyexp_fused.launches = coarse_polyexp_fused_batch.launches = 0
    k4 = coarse_polyexp_fused(grays[0], *args)
    k7b = coarse_polyexp_fused_batch(grays, *args,
                                     out_dtype=torch.bfloat16)
    e4 = max(max_err(a, b) for a, b in zip(
        k4, coarse_polyexp_fused_plain(grays[0], *args)))
    ref = coarse_polyexp_fused_plain(grays, *args, out_dtype=torch.float32)
    ulps = max(((a.float() - b).abs() / bf16_ulp(b)).max().item()
               for a, b in zip(k7b, ref))
    log(f"  K4 {len(k4)} coarse levels in {coarse_polyexp_fused.launches} "
        f"launches: vs plain {e4:.3e} (bar 1e-3); K7b N=2 bf16 in "
        f"{coarse_polyexp_fused_batch.launches}: {ulps:.2f} ulp (bar 1)")
    assert len(k4) == 15 and coarse_polyexp_fused.launches == 2
    assert coarse_polyexp_fused_batch.launches == 2
    assert e4 < 1e-3 and ulps <= 1.0
    flow_pair(dev, clip, f, flow_expected(f, H, W),
              "levels 16, pyr_scale 0.8, fast_warp 8")


@contextlib.contextmanager
def plain_lk_route():
    """The Lucas-Kanade flows through the plain versions of K9, K10 and
    K12 on the card, patched into ops.lk: the plain route a fault's
    kernels are held against."""
    from kalman_hydra_tpu_torch.kernels.lk import lk_sparse_levels_plain
    from kalman_hydra_tpu_torch.kernels.pyramid import pyr_down_levels_plain
    from kalman_hydra_tpu_torch.kernels.scharr import scharr_gradients_plain
    from kalman_hydra_tpu_torch.ops import lk
    saved = lk.build_pyramid, lk.scharr_gradients_levels, lk.lk_sparse_levels
    lk.build_pyramid = lambda img, n: [img] + pyr_down_levels_plain(img,
                                                                    n - 1)
    lk.scharr_gradients_levels = lambda pyr: tuple(
        scharr_gradients_plain(a) for a in pyr)
    lk.lk_sparse_levels = lk_sparse_levels_plain
    try:
        yield
    finally:
        (lk.build_pyramid, lk.scharr_gradients_levels,
         lk.lk_sparse_levels) = saved


@phase("F5: lk_sparse and lk_dense at levels 10 (1080p) through "
       "pipeline.track_clip and api.flow")
def fault_f5(dev, clip, cfgs):
    """Sparse LK (path H's settings) and dense LK at 10 levels: K9 in
    three launches a pyramid, K10 in two (8 + 2 levels), K12 as two
    walks a step (levels 8-9, then 0-7, the guess carried between);
    the tracks and the flow against the plain route on the card."""
    from kalman_hydra_tpu_torch import api, kernels, pipeline
    from kalman_hydra_tpu_torch.config import FlowConfig
    cfg = dataclasses.replace(cfgs["H"], flow=dataclasses.replace(
        cfgs["H"].flow, levels=10))
    t = 3
    tr = drive("F5 lk_sparse", lambda: pipeline.track_clip(
        clip[:t], cfg, device=dev), per_frame_expected(cfg, H, W, t), {})
    check_tracks(tr, t, cfg.tracks.num_tracks)
    with plain_lk_route():
        kernels.reset_launches()
        ref = pipeline.track_clip(clip[:t], cfg, device=dev)
        assert not any(kernels.launch_counts().values())
    same_tracks(tr, ref, "lk_sparse levels 10, kernels vs plain route")
    f = FlowConfig(method="lk_dense", levels=10, fast_warp=8)
    kernels.reset_launches()
    got = api.flow(clip[0], clip[1], f, device=dev)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    with plain_lk_route():
        ref = api.flow(clip[0], clip[1], f, device=dev)
    epe = np.linalg.norm(got - ref, axis=-1)
    log(f"  lk_dense levels 10: launches {counts}; kernels vs plain mean "
        f"EPE {epe.mean():.3e} px (bar 1e-3)")
    assert counts == {k: v for k, v in flow_expected(f, H, W).items() if v}
    assert np.isfinite(got).all() and epe.mean() < 1e-3


POLY_N_CASES = ((9, 1.9), (11, 2.3), (13, 2.7))


@phase("F4: poly_n 9, 11, 13 through api.flow (K4, K3; K11 at "
       "pe_fused=False) and the batched kernels (K7b, K7a)")
def fault_f4(dev, clip, cfg):
    """The generic-n builds of K3/K7a and K4/K7b (f32 < 1e-3, bf16 within
    one ulp of their plain versions; K11 + K3 at pe_fused=False), then
    the main path's flow through api.flow at each n against the plain
    route; a poly_n past POLY_N_MAX is refused by check_slice."""
    from kalman_hydra_tpu_torch import pipeline
    from kalman_hydra_tpu_torch.config import RunConfig
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_polyexp_fused, coarse_polyexp_fused_batch,
        coarse_polyexp_fused_plain)
    from kalman_hydra_tpu_torch.kernels.polyexp import (
        POLY_N_MAX, poly_expansion_planar, poly_expansion_planar_batch,
        poly_expansion_planar_plain)
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    grays = grayscale_u8(torch.from_numpy(clip[:2]).to(dev))
    for n, sg in POLY_N_CASES:
        f = dataclasses.replace(cfg.flow, poly_n=n, poly_sigma=sg)
        args = (f.levels, f.pyr_scale, n, sg)
        e3 = max_err(poly_expansion_planar(grays[0], n, sg),
                     poly_expansion_planar_plain(grays[0], n, sg))
        e4 = max(max_err(a, b) for a, b in zip(
            coarse_polyexp_fused(grays[0], *args),
            coarse_polyexp_fused_plain(grays[0], *args)))
        u7a = (((poly_expansion_planar_batch(grays, n, sg, torch.bfloat16)
                 .float() - (r := poly_expansion_planar_plain(grays, n, sg)))
                .abs() / bf16_ulp(r)).max().item())
        u7b = max(((a.float() - b).abs() / bf16_ulp(b)).max().item()
                  for a, b in zip(
                      coarse_polyexp_fused_batch(grays, *args,
                                                 out_dtype=torch.bfloat16),
                      coarse_polyexp_fused_plain(grays, *args)))
        log(f"  poly_n {n}: K3 f32 {e3:.3e}, K4 f32 {e4:.3e} (bar 1e-3); "
            f"K7a bf16 {u7a:.2f} ulp, K7b bf16 {u7b:.2f} ulp (bar 1)")
        assert e3 < 1e-3 and e4 < 1e-3 and u7a <= 1.0 and u7b <= 1.0
        flow_pair(dev, clip, f, flow_expected(f, H, W),
                  f"poly_n {n}, fast_warp 8")
    f = dataclasses.replace(cfg.flow, poly_n=11, poly_sigma=2.3,
                            pe_fused=False)
    flow_pair(dev, clip, f, flow_expected(f, H, W),
              "poly_n 11 at pe_fused=False (K11, K3)")
    try:
        pipeline.check_slice(RunConfig(flow=dataclasses.replace(
            cfg.flow, poly_n=POLY_N_MAX + 2)))
        raise AssertionError("poly_n past POLY_N_MAX was not refused")
    except NotImplementedError as e:
        log(f"  poly_n {POLY_N_MAX + 2}: refused ({e})")
        assert "F4" in str(e)


WINSIZE_CASES = (63, 81, 101)
WINSIZE_TILES = (63, 81, 95, 99, 101)   # every TILES shape past 61, and M


@phase("F3: winsize 63, 81, 101 at fast_warp 0 and 8 through api.flow, "
       "and each kernel that takes the window vs its plain version")
def fault_f3(dev, clip, cfg):
    """Windows past 61 taps: 63, 81, 95 and 99 on the smaller tiles (16 x
    64, 16 x 32, 8 x 16, 8 x 8), 101 with M in device memory
    (kernels/flow_iter.py::tile_plan). K2, K8 (1080p), K13 (540x960, 3
    iterations), K5's walk (a 1080p pair's gated levels), K6 and
    K8-pairs (2 pairs of 270x480) against their plain versions (bar
    1e-4, the fused-iteration bar), then the main path's flow at 63, 81
    and 101 and fast_warp 8 (K5, K2) and 0 (K8) through api.flow against
    the plain route."""
    from kalman_hydra_tpu_torch.kernels.flow_iter import (
        flow_iter, flow_iter_pairs, flow_iter_pairs_plain, flow_iter_plain,
        flow_iters_pipelined, flow_iters_pipelined_plain, tile_plan)
    from kalman_hydra_tpu_torch.kernels.flow_level import (
        fits, flow_levels, flow_levels_plain, walk_fits)
    from kalman_hydra_tpu_torch.kernels.flow_update import (
        flow_update, flow_update_pairs, flow_update_pairs_plain,
        flow_update_plain)
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.farneback import polyexp_pyramid
    R0, R1, fl = (torch.from_numpy(a).to(dev) for a in witness_inputs(H, W))
    r0, r1, fh = (torch.from_numpy(a).to(dev)
                  for a in witness_inputs(H // 2, W // 2))
    Rs, _, fs = (torch.from_numpy(a).to(dev)
                 for a in witness_inputs(270, 480))
    stack = torch.stack([Rs, Rs.roll(3, -1), Rs.roll(-2, -2)])
    fb = torch.stack([fs, fs * 0.5])
    pyrs = [polyexp_pyramid(grayscale_u8(torch.from_numpy(clip[i]).to(dev)),
                            cfg.flow) for i in (0, 1)]
    # the exact gather on the clip's planes (1080p, and 3 frames of
    # 270x480), from a +-2 px prior, as check_k8 holds K8
    g = torch.Generator().manual_seed(8)
    e0, e1 = pyrs[0][-1], pyrs[1][-1]
    fe = (torch.rand(2, H, W, generator=g) * 4 - 2).to(dev)
    mid = len(pyrs[0]) // 2      # 270x480 at 1080p
    es = torch.stack([pyrs[0][mid], pyrs[1][mid], pyrs[0][mid]])
    feb = (torch.rand((2, 2) + tuple(es.shape[2:]), generator=g) * 4
           - 2).to(dev)
    gated = [i for i, R in enumerate(pyrs[0])
             if fits(R.shape[1], R.shape[2], 2)]
    a_s, b_s = [pyrs[0][i] for i in gated], [pyrs[1][i] for i in gated]
    f0 = torch.zeros((2,) + tuple(a_s[0].shape[1:]), device=dev)
    for ws in WINSIZE_TILES:
        plan = tile_plan(H, W, ws)
        errs = {
            "K2": max_err(flow_iter(R0, R1, fl, ws, 8),
                          flow_iter_plain(R0, R1, fl, ws, 8)),
            "K8": max_err(flow_update(e0, e1, fe, ws),
                          flow_update_plain(e0, e1, fe, ws)),
            "K13": max_err(flow_iters_pipelined(r0, r1, fh, ws, 8, 3),
                           flow_iters_pipelined_plain(r0, r1, fh, ws, 8, 3)),
            "K6": max_err(flow_iter_pairs(stack, fb, ws, 8),
                          flow_iter_pairs_plain(stack, fb, ws, 8)),
            "K8-pairs": max_err(flow_update_pairs(es, feb, ws),
                                flow_update_pairs_plain(es, feb, ws))}
        if walk_fits(ws):
            errs["K5"] = max_err(
                flow_levels(a_s, b_s, f0, ws, 8, 3, False, 0.5),
                flow_levels_plain(a_s, b_s, f0, ws, 8, 3, False, 0.5))
        log(f"  winsize {ws}: tile {plan.th}x{plan.tw} (shape "
            f"{plan.shape}; -1: M in device memory); vs plain "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + " (bar 1e-4)")
        assert max(errs.values()) < 1e-4
        for fw in (8, 0) if ws in WINSIZE_CASES else ():
            f = dataclasses.replace(cfg.flow, winsize=ws, fast_warp=fw)
            flow_pair(dev, clip, f, flow_expected(f, H, W),
                      f"winsize {ws}, fast_warp {fw}")


def pyr_conv(x: torch.Tensor):
    """cv2.pyrDown as ONE cuDNN convolution: the 5 x 5 binomial at stride
    2 on the reflect-padded image (the library yardstick of K9; timed
    here and used nowhere in the port)."""
    from kalman_hydra_tpu_torch.kernels.pyramid import PYR_TAPS
    k = torch.tensor(np.outer(PYR_TAPS, PYR_TAPS), device=x.device)
    xp = torch.nn.functional.pad(x[None, None], (2, 2, 2, 2),
                                 mode="reflect")
    return lambda: torch.nn.functional.conv2d(xp, k[None, None], stride=2)


ODD_SIZES = ((1079, 1919), (37, 53), (19, 27), (3, 4), (2, 2), (1, 5))


@phase("K9 pyr_down_levels")
def check_k9(dev, gray, results):
    """K9's one launch for a 1080p frame's four levels (1080x1920 down to
    68x120) and for the odd and tiny sizes, against the plain chain and
    against the per-level launches (pyr_down, the one-level call), bit
    for bit; the kernels line keeps the frame's one launch, against four
    cuDNN calls in the same turns."""
    from kalman_hydra_tpu_torch.kernels.pyramid import (
        pyr_down, pyr_down_levels, pyr_down_levels_plain)

    def errs(img, n):
        got = pyr_down_levels(img, n)
        chain = [img]
        for _ in range(n):
            chain.append(pyr_down(chain[-1]))
        return (max(max_err(a, b) for a, b in zip(
            got, pyr_down_levels_plain(img, n))),
            max(max_err(a, b) for a, b in zip(got, chain[1:])))
    e_plain, e_levels = errs(gray, 4)
    e7 = errs(gray, 7)           # two launches: 4 levels, then 3 more
    frame = [gray] + pyr_down_levels(gray, 4)
    lib_err = max(max_err(pyr_conv(a)()[0, 0], b)
                  for a, b in zip(frame, frame[1:]))
    g = torch.Generator().manual_seed(9)
    odd = {}
    for shp in ODD_SIZES:
        x = (torch.rand(shp, generator=g) * 255).to(dev)
        odd[shp] = errs(x, 4 if min(shp) > 2 else 1)
    log(f"  K9 1080p levels {[tuple(c.shape) for c in frame]}: one launch "
        f"vs plain {e_plain:.1e}, vs per-level launches {e_levels:.1e} (bar "
        f"0 for both); 7 levels (two launches) {e7[0]:.1e}, {e7[1]:.1e}; "
        f"cuDNN yardstick vs kernel {lib_err:.2e}; odd/tiny sizes (vs "
        f"plain, vs per level) "
        f"{ {k: '%.1e, %.1e' % v for k, v in odd.items()} }")
    err = max([e_plain, e7[0]] + [v[0] for v in odd.values()])
    assert err == 0 and max([e_levels, e7[1]]
                            + [v[1] for v in odd.values()]) == 0
    convs = [pyr_conv(c) for c in frame[:4]]
    ms = time_turns({
        "plain": lambda: pyr_down_levels_plain(gray, 4),
        "kernel": lambda: pyr_down_levels(gray, 4),
        "per_level": lambda: [pyr_down(c) for c in frame[:4]],
        "library": lambda: [f() for f in convs]})
    log(f"  K9 one 1080p frame's 4 levels: one launch {ms['kernel']:.4f} ms "
        f"a call ({ms['kernel dev']:.4f} on the device), 4 one-level "
        f"launches {ms['per_level']:.4f} ({ms['per_level dev']:.4f}), 4 "
        f"cuDNN calls {ms['library']:.4f} ({ms['library dev']:.4f})")
    px_out = sum(c.shape[0] * c.shape[1] for c in frame[1:])
    # separable need: 10 FLOPs per (output row x input column) for the
    # vertical taps, 10 per output pixel for the horizontal ones
    flops = sum(10 * b.shape[0] * a.shape[1]
                for a, b in zip(frame, frame[1:])) + 10 * px_out
    # the image read once, the four levels written once
    record(results, "pyr_down_levels", err, ms["kernel"], ms["plain"],
           4 * (H * W + px_out), flops, ms["library"], dev=ms)


@phase("K10 scharr_gradients_levels")
def check_k10(dev, gray, results):
    """K10's one launch over a 1080p pyramid's five levels against the
    one-level launches (bit for bit) and the plain version (bar 1e-3),
    and on tiny sizes; timed at the 1080p level against one cuDNN call
    with the two 3x3 kernels (the kernels line), and over the pyramid
    against five."""
    from kalman_hydra_tpu_torch.kernels.pyramid import pyr_down_levels
    from kalman_hydra_tpu_torch.kernels.scharr import (
        SCHARR_EDGE, SCHARR_SMOOTH, scharr_gradients, scharr_gradients_levels,
        scharr_gradients_plain)
    pyr = [gray] + pyr_down_levels(gray, 4)
    got = scharr_gradients_levels(pyr)
    e_one = max(max_err(a, b) for g2, lvl in zip(got, pyr)
                for a, b in zip(g2, scharr_gradients(lvl)))
    errs = [max(max_err(a, b) for a, b in zip(g2, scharr_gradients_plain(
        lvl))) for g2, lvl in zip(got, pyr)]
    g = torch.Generator().manual_seed(10)
    small = {}
    for shp in ((3, 4), (1, 1), (5, 7)) + ODD_SIZES:
        x = (torch.rand(shp, generator=g) * 255).to(dev)
        small[shp] = max(max_err(a, b) for a, b in zip(
            scharr_gradients(x), scharr_gradients_plain(x)))
    wts = torch.tensor(np.stack([np.outer(SCHARR_SMOOTH, SCHARR_EDGE),
                                 np.outer(SCHARR_EDGE, SCHARR_SMOOTH)]),
                       device=dev)[:, None]
    convs = [(lambda xp=torch.nn.functional.pad(
        a[None, None], (1, 1, 1, 1), mode="replicate"):
        torch.nn.functional.conv2d(xp, wts)) for a in pyr]
    lib = max(max_err(convs[0]()[0, i], got[0][i]) for i in (0, 1))
    log(f"  K10 levels {[tuple(a.shape) for a in pyr]}: one launch vs "
        f"one-level launches {e_one:.1e} (bar 0); vs plain per level "
        f"{['%.1e' % e for e in errs]} (bar 1e-3); tiny and odd sizes "
        f"{ {k: '%.1e' % v for k, v in small.items()} }; cuDNN yardstick "
        f"vs kernel {lib:.2e}")
    err = max(errs + list(small.values()))
    assert err < 1e-3 and e_one == 0
    ms5 = time_turns({
        "plain": lambda: [scharr_gradients_plain(a) for a in pyr],
        "kernel": lambda: scharr_gradients_levels(pyr),
        "per_level": lambda: [scharr_gradients(a) for a in pyr],
        "library": lambda: [f() for f in convs]})
    log(f"  K10 the 5-level pyramid: one launch {ms5['kernel']:.4f} ms a "
        f"call ({ms5['kernel dev']:.4f} on the device), 5 one-level "
        f"launches {ms5['per_level']:.4f} ({ms5['per_level dev']:.4f}), 5 "
        f"cuDNN calls {ms5['library']:.4f} ({ms5['library dev']:.4f})")
    ms = time_turns({"plain": lambda: scharr_gradients_plain(gray),
                     "kernel": lambda: scharr_gradients(gray),
                     "library": convs[0]})
    px = sum(a.shape[0] * a.shape[1] for a in pyr)
    log(f"  K10 the 5-level pyramid's bound {bound(px * 12, px * 12)[0]:.4f}"
        f" ms (bytes)")
    record(results, "scharr_gradients_levels", err, ms["kernel"],
           ms["plain"], H * W * 4 * 3, H * W * 12, ms["library"], dev=ms)


@phase("golden (api.flow, pipeline.track_clip vs tests/golden/oracle_v1.npz)")
def check_golden(dev):
    """The OpenCV oracle's committed outputs against the port on the card,
    at tests/integration/test_golden.py's bars: a 96x96 pair's Farneback
    flow at levels=3 (mean EPE < 0.05, < 0.01 inside an 8-pixel border)
    and a 6-frame clip's 8 tracks from the oracle's seeds (mean < 1e-2
    px). Only the npz is read: the card's host needs no cv2."""
    from kalman_hydra_tpu_torch import api, pipeline
    from kalman_hydra_tpu_torch.config import (FlowConfig, RunConfig,
                                               TrackConfig)
    npz = Path(__file__).resolve().parent / "tests/golden/oracle_v1.npz"
    with np.load(npz) as z:
        gold = {k: z[k] for k in z.files}
    flow = api.flow(gold["pair_a"], gold["pair_b"], FlowConfig(levels=3),
                    device=dev)
    epe = np.linalg.norm(flow - gold["farneback_flow"], axis=-1)
    cfg = RunConfig(flow=FlowConfig(levels=3),
                    tracks=TrackConfig(num_tracks=8, reinit=False))
    tr = pipeline.track_clip(gold["clip_frames"], cfg, gold["clip_seeds"],
                             device=dev)
    d = np.linalg.norm(tr.positions - gold["track_positions"], axis=-1)
    log(f"  golden flow: mean EPE {epe.mean():.5f} px (bar 0.05), inside "
        f"the 8-px border {epe[8:-8, 8:-8].mean():.5f} (bar 0.01); tracks: "
        f"mean {d.mean():.2e} px (bar 1e-2), max {d.max():.2e}")
    assert epe.mean() < 0.05 and epe[8:-8, 8:-8].mean() < 0.01
    assert d.mean() < 1e-2


# OC-flow's translating pairs (h, w, shift, seed): the first, held to the
# hard bars and reused by OC-LK, and bench_epe's 256 x 256
OC_SIZES = ((1080, 1920, (6.0, 3.0), 3), (256, 256, (3.0, -2.0), 0))
OC_TRACKS = 1024                            # K of OC-track's seeds
OC_GRID = 64                                # px between OC-LK's points
CONTRACT_EPE = 0.5                          # BASELINE.json:5, px


def cpu_model() -> str:
    """The host CPU's model as /proc/cpuinfo names it (its first "model
    name", else the vendor and family fields), with the architecture."""
    fields = {}
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            key, _, val = line.partition(":")
            fields.setdefault(key.strip(), val.strip())
    name = fields.get("model name", "unknown")
    if name == "unknown":
        name = " ".join(f"{k} {fields[k]}" for k in
                        ("vendor_id", "cpu family", "model")
                        if fields.get(k)) or "no model in /proc/cpuinfo"
    return f"{name} ({platform.machine()})"


def oracle_track(ref, clip, cfg, seeds, threads) -> tuple:
    """ref.pipeline.track_clip at `threads` cv2 threads: (trajectories,
    seconds of the call, its timing dict)."""
    import cv2
    cv2.setNumThreads(threads)
    timing: dict = {}
    t0 = time.perf_counter()
    tr = ref.pipeline.track_clip(clip, cfg, seeds, timing)
    return tr, time.perf_counter() - t0, timing


@phase("OC (the port on the card against its own OpenCV oracle, 1080p)")
def check_oracle(dev, clip, cfg_a, name):
    """The port's card paths against kalman_hydra_tpu_torch.ref (cv2 and
    NumPy on the host). Each card call's launches are counted against
    the kernels it must reach (the counts stay out of the kernels line).
    OC-flow: api.flow of translating_pair, rounded to uint8 as bench_epe
    does, at 1080x1920 (shift (6, 3), seed 3) and 256x256 (shift (3,
    -2)), at FlowConfig() (the exact warp) and at the main path's
    FlowConfig(fast_warp=8, bf16_poly=True), against cv2's Farneback at
    FlowConfig(): at 1080p mean EPE < 0.05 px, and < 0.01 (exact) or
    0.02 (fast) inside a 16-px border (test_parity_resolutions.py).
    OC-LK, the 1080p pair: ops.lk.lk_sparse at the lk_sparse defaults on
    a 64-px grid of interior points against ref.imgproc.lk_sparse
    (status agreement > 0.95, max |diff| < 0.02 px where both tracked);
    api.flow at lk_dense against ref.imgproc.lk_dense at stride 4 (mean
    |diff| < 0.05 px, test_lk.py's bar, at the oracle's status-ok points
    that lie as far inside the border as the coarsest level's window
    reaches at level 0: in that band the reference's own dense LK leaves
    cv2's per-point tracks as the port does; the mean over every point is
    printed).
    OC-track: pipeline.track_clip of the 1080p T=9 clip from 1024
    good_features seeds at main_path_config() and at RunConfig(), with
    tracks.reinit=False as the oracle keeps its seeds alive, against
    ref.pipeline.track_clip: mean position gap < 0.5 px (the contract).
    OC-rate: the oracle's frames/s on this host at main_path_config(),
    at 1 cv2 thread and at cv2's default count, against path A's
    (api.track_video, median of 3 warm runs), and their ratio (the
    contract: >= 5x). Without cv2 on the host, OC says so and runs
    nothing."""
    try:
        import cv2
    except ImportError as exc:
        log(f"  OC did not run: cv2 cannot be imported on this host "
            f"({exc}); no OpenCV figure was taken")
        return
    from kalman_hydra_tpu_torch import api, pipeline, ref
    from kalman_hydra_tpu_torch.config import (FlowConfig, RunConfig,
                                               TrackConfig)
    from kalman_hydra_tpu_torch.io.synthetic import translating_pair
    from kalman_hydra_tpu_torch.ops import lk
    threads = cv2.getNumThreads()
    cpu = cpu_model()
    log(f"  cv2 {cv2.__version__}, {threads} threads by default; host CPU "
        f"{cpu}, {len(os.sched_getaffinity(0))} cores usable; {name}")

    # OC-flow
    flows = {"exact": FlowConfig(),
             "fast": FlowConfig(fast_warp=8, bf16_poly=True)}
    pairs = []
    for h, w, shift, seed in OC_SIZES:
        a, b, _ = translating_pair(height=h, width=w, shift=shift, seed=seed)
        a8, b8 = (np.round(x).astype(np.uint8) for x in (a, b))
        pairs.append((a8, b8))
        want = ref.imgproc.farneback(a8, b8, FlowConfig())
        for label, f in flows.items():
            got = drive(f"OC-flow {h}x{w} {label}",
                        lambda: api.flow(a8, b8, f, device=dev),
                        dict(flow_expected(f, h, w), ekf_fused_step=0), {})
            epe = np.linalg.norm(got - want, axis=-1)
            mean, inner = epe.mean(), epe[16:-16, 16:-16].mean()
            log(f"  OC-flow {h}x{w} {label} vs cv2: mean EPE {mean:.5f} "
                f"px, inside the 16-px border {inner:.5f}, max "
                f"{epe.max():.4f}; {CONTRACT_EPE - mean:.5f} px under the "
                f"contract's {CONTRACT_EPE}")
            if len(pairs) == 1:             # the 1080p pair
                assert mean < 0.05, (label, mean)
                assert inner < (0.01 if label == "exact" else 0.02), \
                    (label, inner)

    # OC-LK
    a8, b8 = pairs[0]
    h, w = a8.shape
    fs = FlowConfig(method="lk_sparse")
    gx, gy = np.meshgrid(np.arange(OC_GRID, w - OC_GRID + 1, OC_GRID),
                         np.arange(OC_GRID, h - OC_GRID + 1, OC_GRID))
    pts = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    ta, tb = (torch.from_numpy(x).to(dev, torch.float32) for x in (a8, b8))
    # one step of a frame pair: both frames' pyramids, the first's Scharr
    e = per_frame_expected(RunConfig(flow=fs), h, w, 2)
    e["scharr_gradients_levels"] //= 2
    got_pts, got_st = drive(
        "OC-LK sparse", lambda: lk.lk_sparse(
            ta, tb, torch.from_numpy(pts).to(dev), fs), e, {})
    got_pts, got_st = got_pts.cpu().numpy(), got_st.cpu().numpy()
    want_pts, want_st = ref.imgproc.lk_sparse(a8, b8, pts, fs)
    want_st = want_st.astype(bool)
    agree = (want_st == got_st).mean()
    both = want_st & got_st
    d = np.abs(got_pts[both] - want_pts[both])
    log(f"  OC-LK sparse vs cv2 ({len(pts)} points, {fs.levels} levels, "
        f"window {fs.lk_winsize}): status agreement {agree:.4f} (bar "
        f"0.95); where both tracked ({int(both.sum())}) max |diff| "
        f"{d.max():.5f} px (bar 0.02), mean {d.mean():.6f}")
    assert agree > 0.95 and both.any() and d.max() < 0.02
    fd = FlowConfig(method="lk_dense")
    got = drive("OC-LK dense", lambda: api.flow(a8, b8, fd, device=dev),
                dict(flow_expected(fd, h, w), ekf_fused_step=0), {})
    want = ref.imgproc.lk_dense(a8, b8, fd, stride=4)
    ys, xs = np.mgrid[0:h:4, 0:w:4]
    grid = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    ok = ref.imgproc.lk_sparse(a8, b8, grid, fd)[1].reshape(ys.shape) > 0
    # the dense formulation's replicate border reaches as far as the
    # coarsest level's window does at level 0: the reference's own dense
    # LK leaves cv2's per-point tracks there as the port does
    margin = (fd.lk_winsize // 2) << (fd.levels - 1)
    edge = np.minimum(np.minimum(ys, h - 1 - ys), np.minimum(xs, w - 1 - xs))
    diff = np.abs(got[::4, ::4] - want)
    inside = ok & (edge >= margin)
    d, d_in = diff[ok], diff[inside]
    log(f"  OC-LK dense vs cv2 at stride 4, the oracle's status-ok grid "
        f"points {margin} px or more inside the border ({int(inside.sum())}"
        f" of {ok.size}): mean |diff| {d_in.mean():.5f} px (bar 0.05), max "
        f"{d_in.max():.4f}; all {int(ok.sum())} status-ok points: mean "
        f"{d.mean():.5f}, max {d.max():.4f}; within 16 px of the border: "
        f"mean {diff[ok & (edge < 16)].mean():.4f}")
    assert d_in.mean() < 0.05

    # OC-track, and OC-rate at main_path_config()
    seeds = ref.imgproc.good_features(ref.imgproc.grayscale(clip[0]),
                                      TrackConfig(), max_corners=OC_TRACKS)
    k, steps = len(seeds), len(clip) - 1
    oracle_fps = {}
    for label, c in (("main_path_config()", cfg_a),
                     ("RunConfig()", RunConfig())):
        c = c.replace(tracks=dataclasses.replace(c.tracks, num_tracks=k,
                                                 reinit=False))
        got = drive(f"OC-track {label}",
                    lambda: pipeline.track_clip(clip, c, seeds, device=dev),
                    per_frame_expected(c, H, W, T), {})
        timed = label == "main_path_config()"
        for n in ((1, threads) if timed else (threads,)):
            want, wall, tm = oracle_track(ref, clip, c, seeds, n)
            fps = steps / (tm["flow_s"] + tm["ekf_s"])
            if timed:
                oracle_fps[n] = fps
            log(f"  OC-rate: the oracle at {label}, {n} cv2 thread(s): "
                f"flow {tm['flow_s']:.3f} s, EKF {tm['ekf_s']:.3f} s, the "
                f"call {wall:.3f} s for {steps} frame steps: {fps:.4f} "
                f"frames/s (flow + EKF); Farneback alone "
                f"{steps / tm['flow_s']:.4f} frame pairs/s")
        gap = np.linalg.norm(got.positions - want.positions, axis=-1)
        log(f"  OC-track {label} (K={k}, 1080p T={len(clip)}) vs the "
            f"oracle: mean gap {gap.mean():.5f} px (bar {CONTRACT_EPE}), "
            f"max {gap.max():.4f}; live at the end on the card "
            f"{int(got.alive[-1].sum())}/{k} (test_pipeline.py's 96x96 "
            f"bars, not asserted here: mean < 1e-3, max < 1e-2)")
        assert np.isfinite(got.positions).all()
        assert gap.mean() < CONTRACT_EPE, (label, gap.mean())
    cv2.setNumThreads(threads)

    run = lambda: api.track_video(clip, cfg_a, device=dev)  # noqa: E731
    run()
    fps_a = steps / statistics.median(clip_seconds(run, 3))
    for n, fps in oracle_fps.items():
        log(f"  OC-rate: path A {fps_a:.2f} frames/s (1080p T={T} K={K}, "
            f"median of 3 warm runs; {name}) against the oracle's "
            f"{fps:.4f} at {n} cv2 thread(s) on {cpu}: {fps_a / fps:.1f}x "
            f"(contract >= 5x)")


def lk_border_points(h, w):
    """The nine border points of the reference's
    test_lk_sparse_kernel_border_points, placed on an h x w frame."""
    return torch.tensor([[1.0, 1.0], [w - 2.0, 1.0], [1.0, h - 2.0],
                         [w - 2.0, h - 2.0], [0.0, h / 2], [w - 1.0, h / 2],
                         [w / 2, 0.3], [w / 2 - 0.3, h - 1.0],
                         [w / 2, h / 2]])


# sha256 of the new points and status of the route that K12's walk
# replaced (commit 1d94c6b: one K12 launch a level, the torch glue of
# ops/lk.py between them) on k12_witness_inputs, 5 levels, K = 1024:
# "walk" keys the whole frame step (lk_sparse's loop; "far" starts the
# coarsest level 12 x -9 px off), "levels" keys each level's own K12 call
# on k12_level_args, coarsest first, with the guesses handed down or 12 x
# -9 px off at every level (check_k12's cases). Computed by
# tools/torch_level_lk_ab.py on that commit, on an NVIDIA H100 80GB HBM3.
K12_WITNESS = {
    "K12 walk halo0 handed":
        "d585a9a0ea69998f7be69a606ab55115693d746711354a9372400c135c4c9b0b",
    "K12 walk halo0 far":
        "d2822779c16a80b1560d58d9c16e6ec8d82bd1e10f4280907a002ac71e739bb9",
    "K12 walk halo8 handed":
        "6bc3b780c0f8fccd5adf06317d9e4353cf714b614a57a9829054cc8430b53e2f",
    "K12 walk halo8 far":
        "d82607809ff62eae7ef584b17f5b4a949beb3d3ec2c1a34b2bac1fee24abf27b",
    "K12 levels halo0 handed":
        "db07d3aad03bd9d85e470a57c1cc0c087f86b0ce26417bf254193e08ca64e0c3",
    "K12 levels halo0 far":
        "e55d07ca79cee1b9843f9bd44ca1dcc46e8666765bcdffecbb631947d9e7387e",
    "K12 levels halo8 handed":
        "698ed2464bd93a8384105b694f8421097fadf2705d68de510624c300fc0f8dd2",
    "K12 levels halo8 far":
        "e8481c2ed754037cc98ccb835a53f86f3a1c9a3ae80a32ccc5bd1ed4261d23fc",
}
K12_KEYS = [f"K12 {r} halo{h} {g}" for r in ("walk", "levels")
            for h in (0, 8) for g in ("handed", "far")]
K12_OFF = (12.0, -9.0)


def k12_witness_inputs(dev, clip):
    """(the lk_pyramid inputs: grays of frames 0 and 1 of `clip`, and the
    K points: 1015 uniform ones from numpy's legacy generator and the nine
    border points), f32 on dev."""
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    g0, g1 = (grayscale_u8(torch.from_numpy(clip[i]).to(dev))
              for i in (0, 1))
    rs = np.random.RandomState(12)
    pts = (rs.random_sample((K - 9, 2)) * [W - 1.0, H - 1.0]).astype(
        np.float32)
    pts = torch.cat([torch.from_numpy(pts), lk_border_points(H, W)])
    return g0, g1, pts.to(dev)


def k12_level_args(img_a, img_b, gx, gy, pts, guess, c):
    """One level's K12 arguments at FlowConfig c's LK settings
    (kernels.lk.level_args; on a checkout from before the walk, which
    tools/torch_level_lk_ab.py runs as the old side, ops.lk.lk_level_args
    built the same tuple)."""
    try:
        from kalman_hydra_tpu_torch.kernels.lk import level_args
    except ImportError:
        from kalman_hydra_tpu_torch.ops.lk import lk_level_args
        return lk_level_args(img_a, img_b, gx, gy, pts, guess, c)
    return level_args(img_a, img_b, gx, gy, pts, guess, c.lk_winsize,
                      c.lk_max_iter, c.lk_eps, c.lk_min_eig, c.lk_block_halo)


def k12_witness_hash(key, dev, inputs, cfg_h, walk) -> str:
    """The hash of one K12_KEYS case. `walk(pyr_a, grads, pyr_b, pts, c,
    guess)` runs a frame step (the checkout's walk, or the per-level
    route); "levels" cases call lk_level once a level."""
    from kalman_hydra_tpu_torch.kernels.lk import lk_level
    from kalman_hydra_tpu_torch.ops.lk import lk_pyramid
    _, route, halo, guesses = key.split()
    c = dataclasses.replace(cfg_h.flow, levels=5,
                            lk_block_halo=int(halo[4:]))
    g0, g1, pts = inputs
    pa, pb = lk_pyramid(g0, c), lk_pyramid(g1, c)
    off = torch.tensor(K12_OFF, device=dev)
    guess = pts * (1.0 / 2 ** (c.levels - 1))
    if route == "walk":
        return tensors_hash(walk(pa[0], pa[1], pb[0], pts, c,
                                 guess + off if guesses == "far" else guess))
    outs = []
    for lvl in range(c.levels - 1, -1, -1):
        args = k12_level_args(pa[0][lvl], pb[0][lvl], *pa[1][lvl],
                              pts * (1.0 / 2 ** lvl),
                              guess + off if guesses == "far" else guess, c)
        got, ok = lk_level(*args)
        outs += [got, ok]
        guess = (got - args[8]) * (2.0 if lvl else 1.0)
    return tensors_hash(outs)


def lk_route(pyr_a, grads, pyr_b, pts, c, guess):
    """A frame step of sparse LK as ops.lk.lk_sparse ran it before one
    launch walked the levels: per level one one-level K12 launch
    (lk_level) and the torch glue around it."""
    from kalman_hydra_tpu_torch.kernels.lk import lk_level
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    for lvl in range(c.levels - 1, -1, -1):
        gx, gy = grads[lvl]
        args = k12_level_args(pyr_a[lvl], pyr_b[lvl], gx, gy,
                              pts * (1.0 / (2 ** lvl)), guess, c)
        new, ok = lk_level(*args)
        guess = new - args[8]
        if lvl == 0:
            h, w = pyr_a[0].shape
            inb = ((guess[:, 0] >= 0) & (guess[:, 0] <= w - 1)
                   & (guess[:, 1] >= 0) & (guess[:, 1] <= h - 1))
            status = status & ok & inb
        else:
            guess = guess * 2.0
    return guess, status


@phase("K12 lk_sparse_levels (the walk) and lk_level (one level)")
def check_k12(dev, clip, cfg_h, results):
    """K12 at K = 1024 (1015 random points and the nine border points)
    over the five levels of a 1080p frame pair, at lk_block_halo 0 (the
    exact window) and 8 (the block window), with the guesses the level
    loop hands down, and again with guesses 12 x -9 px off, past the
    halo: the one-level launch against the plain version (bar 1e-3 px,
    status identical), the window's effect shown as the points whose
    answer moves by > 0.5 px between the two windows; then the walk (one
    launch a frame step, as lk_sparse runs it) at both halos from the
    handed-down guess and from one 12 x -9 px off at the coarsest level:
    against the per-level route on the card (one-level launches and the
    torch glue: bit for bit) and against the plain walk (bar 1e-3 px,
    status identical). The kernels line keeps the walk at halo 8 (path
    H); its bound counts, per
    level, the patches each point read at the iterations it took or the
    level's four planes, whichever is fewer bytes."""
    from kalman_hydra_tpu_torch.kernels.lk import (lk_level, lk_level_plain,
                                                   lk_sparse_levels,
                                                   lk_sparse_levels_plain)
    from kalman_hydra_tpu_torch.ops.lk import lk_pyramid
    f = cfg_h.flow
    win = f.lk_winsize
    g0, g1, pts = k12_witness_inputs(dev, clip)
    off = torch.tensor(K12_OFF, device=dev)
    worst, same, moved = 0.0, True, 0
    calls = {}
    for far in (False, True):
        answers = {}
        for halo in (0, f.lk_block_halo):
            c = dataclasses.replace(f, lk_block_halo=halo)
            pa, pb = lk_pyramid(g0, c), lk_pyramid(g1, c)
            guess = pts * (1.0 / 2 ** (f.levels - 1))
            outs = []
            for lvl in range(f.levels - 1, -1, -1):
                # the path's own K12 arguments, as the walk builds them
                args = k12_level_args(pa[0][lvl], pb[0][lvl], *pa[1][lvl],
                                      pts * (1.0 / 2 ** lvl),
                                      guess + off if far else guess, c)
                got, ok = lk_level(*args)
                ref, rok, iters = lk_level_plain(*args, with_iters=True)
                worst = max(worst, max_err(got, ref))
                same = same and bool(torch.equal(ok, rok))
                outs.append(got)
                if halo and not far:
                    calls[lvl] = (args, int(iters.sum()))
                guess = (got - args[8]) * (2.0 if lvl else 1.0)
            answers[halo] = torch.stack(outs)
        diff = (answers[0] - answers[f.lk_block_halo]).abs().amax(-1)
        moved_here = int((diff > 0.5).any(0).sum())
        moved = max(moved, moved_here)
        log(f"  K12 one-level K={K} guesses "
            f"{'12 x -9 px off' if far else 'handed down'}: max_abs_err so "
            f"far {worst:.3e} px (bar 1e-3), status identical {same}; "
            f"points the halo-{f.lk_block_halo} window moved by > 0.5 px: "
            f"{moved_here}")
    assert worst < 1e-3 and same and moved > 0

    def walk_args(c, p):
        pa, pb = lk_pyramid(g0, c), lk_pyramid(g1, c)
        return (pa[0][:c.levels], pb[0][:c.levels], pa[1][:c.levels], p,
                c.lk_winsize, c.lk_max_iter, c.lk_eps, c.lk_min_eig,
                c.lk_block_halo)
    bad = []
    for halo in (0, f.lk_block_halo):
        c = dataclasses.replace(f, lk_block_halo=halo)
        wa = walk_args(c, pts)
        for far in (False, True):
            guess = pts * (1.0 / 2 ** (c.levels - 1)) + (off if far else 0)
            got, st = lk_sparse_levels(*wa, guess=guess)
            route, rst = lk_route(wa[0], wa[2], wa[1], pts, c, guess)
            plain, pst = lk_sparse_levels_plain(*wa, guess=guess)
            nd = int((got != route).any(-1).sum())
            e_route, e_plain = max_err(got, route), max_err(got, plain)
            log(f"  K12 walk halo {halo} guesses "
                f"{'12 x -9 px off' if far else 'handed down'}: points "
                f"differing from the per-level route {nd} (max "
                f"{e_route:.1e} px), status identical "
                f"{bool(torch.equal(st, rst))}; vs plain {e_plain:.3e} px "
                f"(bar 1e-3), status identical {bool(torch.equal(st, pst))}")
            if not (e_route < 1e-3 and torch.equal(st, rst)
                    and e_plain < 1e-3 and torch.equal(st, pst)):
                bad.append((halo, far))
            worst = max(worst, e_plain)
    assert not bad, f"the walk disagrees on {bad}"
    wa = walk_args(f, pts)
    level_calls = [a for a, _ in calls.values()]
    route = lambda: lk_route(wa[0], wa[2], wa[1], pts, f,  # noqa: E731
                             pts * (1.0 / 2 ** (f.levels - 1)))
    ms = time_turns({
        "plain": lambda: lk_sparse_levels_plain(*wa),
        "kernel": lambda: lk_sparse_levels(*wa),
        "route": route,
        "levels": lambda: [lk_level(*a) for a in level_calls]})
    log(f"  K12 one frame pair, halo {f.lk_block_halo}, K={K}: walk "
        f"{ms['kernel']:.4f} ms a call, {ms['kernel dev']:.4f} on the "
        f"device; per-level route {ms['route']:.4f} ({ms['route dev']:.4f});"
        f" its five one-level launches alone {ms['levels']:.4f} "
        f"({ms['levels dev']:.4f})")
    for label, halo, k in (("W", f.lk_block_halo, 256), ("H0", 0, 256)):
        c = dataclasses.replace(f, lk_block_halo=halo)
        wk = walk_args(c, pts[:k].contiguous())
        t = time_turns({"kernel": lambda: lk_sparse_levels(*wk)})
        log(f"  K12 walk {label} (halo {halo}, K={k}): {t['kernel']:.4f} ms "
            f"a call, {t['kernel dev']:.4f} on the device")
    # bytes: per level the smaller of the patches its points read (the
    # template's three (win + 1)^2 blocks a point, one block of the next
    # image a Gauss-Newton step) and the level's four planes, each read
    # once; plus the points in and out and the status
    blk = 4 * (win + 1) ** 2
    nbytes = steps = 0
    for a, n in calls.values():
        plane = 4 * a[0].numel() * 4
        nbytes += min(K * 3 * blk + n * blk, plane)
        steps += n
    nbytes += K * (8 + 8 + 1)
    flops = len(calls) * K * 39 * win * win + steps * 16 * win * win
    log(f"  K12 one frame pair, halo {f.lk_block_halo}: {steps} Gauss-Newton "
        f"steps over {len(calls)} levels x {K} points")
    record(results, "lk_sparse_levels", worst, ms["kernel"], ms["plain"],
           nbytes, flops, dev=ms)
    results["lk_sparse_levels"].update(
        route_ms=ms["route"], route_device_ms=ms["route dev"],
        levels_ms=ms["levels"], levels_device_ms=ms["levels dev"])


@phase("K12 against the per-level route's outputs (bit for bit)")
def check_k12_witness(dev, clip, cfg_h):
    """The walk (and the one-level launch) against the route it replaced,
    one K12 launch a level and the torch glue: the points and status on
    every K12_WITNESS case hash to the old route's. A case whose bytes
    differ is reported point by point against the per-level route on the
    card and passes only if no point moved by 1e-3 px and no status
    changed (a float64 sum of another order could round one f32 sum the
    other way)."""
    from kalman_hydra_tpu_torch.kernels.lk import lk_sparse_levels
    inputs = k12_witness_inputs(dev, clip)

    def walk(pa, grads, pb, pts, c, guess):
        return lk_sparse_levels(pa[:c.levels], pb[:c.levels],
                                grads[:c.levels], pts, c.lk_winsize,
                                c.lk_max_iter, c.lk_eps, c.lk_min_eig,
                                c.lk_block_halo, guess=guess)
    bad = []
    for key, want in K12_WITNESS.items():
        same = k12_witness_hash(key, dev, inputs, cfg_h, walk) == want
        log(f"  {key}: {'same bytes' if same else 'DIFFERENT bytes'} as "
            f"the per-level route")
        if same:
            continue
        if key.split()[1] != "walk":
            bad.append(key)
            continue
        from kalman_hydra_tpu_torch.ops.lk import lk_pyramid
        _, _, halo, guesses = key.split()
        c = dataclasses.replace(cfg_h.flow, levels=5,
                                lk_block_halo=int(halo[4:]))
        g0, g1, pts = inputs
        pa, pb = lk_pyramid(g0, c), lk_pyramid(g1, c)
        guess = pts * (1.0 / 2 ** (c.levels - 1))
        if guesses == "far":
            guess = guess + torch.tensor(K12_OFF, device=dev)
        got, st = walk(pa[0], pa[1], pb[0], pts, c, guess)
        ref, rst = lk_route(pa[0], pa[1], pb[0], pts, c, guess)
        moved = (got - ref).abs().amax(-1)
        log(f"    {int((moved > 0).sum())} points differ, by up to "
            f"{moved.max().item():.2e} px; status identical "
            f"{bool(torch.equal(st, rst))}")
        if moved.max().item() >= 1e-3 or not torch.equal(st, rst):
            bad.append(key)
    assert not bad, f"K12 differs from the per-level route on {bad}"


@phase("K13 flow_iters_pipelined")
def check_k13(dev, clip, cfg, results):
    """K13 on the two 1080p levels above K5's gate (540x960 and
    1080x1920, path AP's), on the polyexp planes of frames 0 and 1 and a
    random prior flow of +-3 px, f32 and bf16 planes, 2 and 3
    iterations, box and Gaussian windows; and on random planes at 37x53,
    70x90, 1x5 (one short band), 20x30 (three bands, the last short) and
    1079x1919: against n_iters K2 launches (bar 0: K2's per-pixel code)
    and against the plain version (< 1e-4). Timed at bf16, 3 iterations
    against the 3 x K2 route; the kernels line keeps one frame pair's two
    calls."""
    from kalman_hydra_tpu_torch.kernels.flow_iter import (
        TILE, flow_iter, flow_iters_pipelined, flow_iters_pipelined_plain)
    from kalman_hydra_tpu_torch.kernels.flow_level import fits
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.farneback import polyexp_pyramid
    f = cfg.flow
    f32 = dataclasses.replace(f, bf16_poly=False)
    grays = [grayscale_u8(torch.from_numpy(clip[i]).to(dev)) for i in (0, 1)]
    pyrs = [polyexp_pyramid(gr, f32) for gr in grays]
    levels = [(R0, R1) for R0, R1 in zip(*pyrs)
              if not fits(R0.shape[1], R0.shape[2], 2)]
    g = torch.Generator().manual_seed(13)
    for shp in ((37, 53), (70, 90), (1, 5), (20, 30), (1079, 1919)):
        levels.append(tuple(torch.randn((5,) + shp, generator=g).to(dev)
                            for _ in range(2)))
    D, wins = f.fast_warp, f.winsize
    worst = worst_k2 = 0.0
    for R0f, R1f in levels:
        lh, lw = R0f.shape[1:]
        fl = (torch.rand(2, lh, lw, generator=g) * 6 - 3).to(dev)
        line = []
        for dt in (torch.float32, torch.bfloat16):
            a, b = R0f.to(dt), R1f.to(dt)
            for n in (2, 3):
                for gw in (False, True):
                    got = flow_iters_pipelined(a, b, fl, wins, D, n, gw)
                    e = max_err(got, flow_iters_pipelined_plain(
                        a, b, fl, wins, D, n, gw))
                    via = fl
                    for _ in range(n):
                        via = flow_iter(a, b, via, wins, D, gw)
                    e2 = max_err(got, via)
                    worst, worst_k2 = max(worst, e), max(worst_k2, e2)
                    line.append(f"{str(dt)[6:]}/{n}{'/g' if gw else ''} "
                                f"{e:.1e} ({e2:.0e})")
        log(f"  K13 {lh}x{lw} vs plain (vs n x K2): " + ", ".join(line))
    log(f"  K13 max_abs_err vs plain {worst:.3e} (bar 1e-4); vs n x K2 "
        f"{worst_k2:.3e} (bar 0: "
        f"{'bit-identical' if worst_k2 == 0 else 'NOT'})")
    assert worst < 1e-4 and worst_k2 == 0.0
    it = f.iterations
    tot = {"kernel": 0.0, "plain": 0.0, "k2": 0.0, "kernel dev": 0.0,
           "k2 dev": 0.0}
    nbytes = flops = 0
    taps = 2 * (wins // 2) + 1
    for R0f, R1f in levels[:2]:
        lh, lw = R0f.shape[1:]
        a, b = R0f.to(torch.bfloat16), R1f.to(torch.bfloat16)
        fl = (torch.rand(2, lh, lw, generator=g) * 6 - 3).to(dev)

        def k2_route(a=a, b=b, fl=fl):
            out = fl
            for _ in range(it):
                out = flow_iter(a, b, out, wins, D)
            return out
        ms = time_turns({
            "plain": lambda a=a, b=b, fl=fl: flow_iters_pipelined_plain(
                a, b, fl, wins, D, it),
            "kernel": lambda a=a, b=b, fl=fl: flow_iters_pipelined(
                a, b, fl, wins, D, it),
            "k2": k2_route})
        log(f"  K13 {lh}x{lw} bf16 {it} iterations: kernel "
            f"{ms['kernel']:.4f} ms ({ms['kernel dev']:.4f} on the device), "
            f"{it} x K2 {ms['k2']:.4f} ms ({ms['k2 dev']:.4f}), plain "
            f"{ms['plain']:.4f} ms")
        for k in tot:
            tot[k] += ms[k]
        how = ms["kernel how"]
        nbytes += lh * lw * (10 * 2 + 8 + 8)
        flops += it * lh * lw * fi_flops(taps)
    log(f"  K13 both levels on the device: tiles {TILE[0]}x{TILE[1]} "
        f"{tot['kernel dev']:.4f} ms; {it} x K2 {tot['k2 dev']:.4f} ms")
    record(results, "flow_iters_pipelined", worst, tot["kernel"],
           tot["plain"], nbytes, flops,
           dev=dict(tot, **{"kernel how": how}))
    results["flow_iters_pipelined"].update(
        k2_route_ms=tot["k2"], k2_route_device_ms=tot["k2 dev"])


@phase("K8-pairs flow_update_pairs")
def check_k8_pairs(dev, clip_b, cfg, results):
    """K8-pairs on path BX's planes (B's 720p clip at RunConfig()'s f32
    planes), 16 pairs of 17 frames and 16 pairs of two chained 9-frame
    clips (clip_len), the coarsest and the finest level, random +-2 px
    flows, the exact gather in the kernel: against per-pair K8 (bit for
    bit) and the plain version (< 1e-4); and at bf16 planes with M
    rounded to bf16 against the plain version. The kernels line keeps one
    call at the fine level."""
    from kalman_hydra_tpu_torch.kernels.flow_iter import pair_frames
    from kalman_hydra_tpu_torch.kernels.flow_update import (
        flow_update, flow_update_pairs, flow_update_pairs_plain)
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.farneback import polyexp_pyramid_batch
    f = cfg.flow
    grays = grayscale_u8(torch.from_numpy(clip_b).to(dev))
    g = torch.Generator().manual_seed(18)
    worst = worst_k8 = 0.0
    B = 16
    for bf16 in (False, True):
        fb = dataclasses.replace(f, bf16_poly=bf16)
        Rs = polyexp_pyramid_batch(torch.cat([grays, grays[:1]]), fb)
        for Rl in (Rs[0], Rs[-1]):
            lh, lw = Rl.shape[2:]
            for clip_len, N in ((0, T_B), (9, 2 * 9)):
                Rall = Rl[:N].contiguous()
                fl = (torch.rand(B, 2, lh, lw, generator=g) * 4 - 2).to(dev)
                got = flow_update_pairs(Rall, fl, f.winsize, False,
                                        clip_len, round_m=bf16)
                e = max_err(got, flow_update_pairs_plain(
                    Rall, fl, f.winsize, False, clip_len, bf16))
                worst = max(worst, e)
                line = f"vs plain {e:.3e}"
                if not bf16:
                    per = torch.stack([
                        flow_update(Rall[p], Rall[p + 1], fl[b], f.winsize)
                        for b, p in enumerate(pair_frames(B, clip_len))])
                    e2 = max_err(got, per)
                    worst_k8 = max(worst_k8, e2)
                    line += f", vs per-pair K8 {e2:.1e}"
                log(f"  K8-pairs {'bf16 (M rounded)' if bf16 else 'f32'} "
                    f"{lh}x{lw} N={N} B={B} clip_len={clip_len}: {line}")
    assert worst < 1e-4 and worst_k8 == 0.0
    Rs = polyexp_pyramid_batch(grays, f)
    Rall = Rs[-1]
    fl = (torch.rand(B, 2, H_B, W_B, generator=g) * 4 - 2).to(dev)
    ms = time_turns({
        "plain": lambda: flow_update_pairs_plain(Rall, fl, f.winsize),
        "kernel": lambda: flow_update_pairs(Rall, fl, f.winsize),
        "k8": lambda: [flow_update(Rall[b], Rall[b + 1], fl[b], f.winsize)
                       for b in range(B)]}, reps=5)
    log(f"  K8-pairs {H_B}x{W_B} f32 B={B}: kernel {ms['kernel']:.4f} ms "
        f"({ms['kernel dev']:.4f} on the device), {B} x K8 {ms['k8']:.4f} "
        f"ms ({ms['k8 dev']:.4f}), plain {ms['plain']:.4f} ms")
    taps = 2 * (f.winsize // 2) + 1
    # the stack's B + 1 frames of 5 f32 planes, read in place, and each
    # pair's flow in and out
    record(results, "flow_update_pairs", worst, ms["kernel"], ms["plain"],
           H_B * W_B * ((B + 1) * 5 * 4 + B * (8 + 8)),
           B * H_B * W_B * update_flops(taps), dev=ms)
    results["flow_update_pairs"].update(k8_route_ms=ms["k8"],
                                        k8_route_device_ms=ms["k8 dev"])


@phase("K6 flow_iter_pairs")
def check_k6(dev, clip_b, cfg, results):
    """K6 at 720p on the fine-level planes of the path-B clip: 16 pairs of
    17 frames, and 16 pairs of two chained 9-frame clips (clip_len); and
    on the coarsest level. Against the plain version (< 1e-4) and against
    per-pair K2 (bit for bit)."""
    from kalman_hydra_tpu_torch.kernels.flow_iter import (
        flow_iter, flow_iter_pairs, flow_iter_pairs_plain, pair_frames)
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.farneback import polyexp_pyramid_batch
    f = cfg.flow
    grays = grayscale_u8(torch.from_numpy(clip_b).to(dev))
    Rs = polyexp_pyramid_batch(torch.cat([grays, grays[:1]]), f)
    g = torch.Generator().manual_seed(6)
    worst = worst_k2 = 0.0
    for Rl in (Rs[0], Rs[-1]):
        lh, lw = Rl.shape[2:]
        for clip_len, N in ((0, T_B), (9, 2 * 9)):
            Rall = Rl[:N].contiguous()
            B = 16
            fl = (torch.rand(B, 2, lh, lw, generator=g) * 6 - 3).to(dev)
            got = flow_iter_pairs(Rall, fl, f.winsize, f.fast_warp, False,
                                  clip_len)
            e = max_err(got, flow_iter_pairs_plain(
                Rall, fl, f.winsize, f.fast_warp, False, clip_len))
            per = torch.stack([flow_iter(Rall[p], Rall[p + 1], fl[b],
                                         f.winsize, f.fast_warp)
                               for b, p in enumerate(pair_frames(B,
                                                                 clip_len))])
            e2 = max_err(got, per)
            worst, worst_k2 = max(worst, e), max(worst_k2, e2)
            log(f"  K6 {lh}x{lw} N={N} B={B} clip_len={clip_len}: vs plain "
                f"{e:.3e}, vs per-pair K2 {e2:.1e}")
    assert worst < 1e-4 and worst_k2 == 0.0
    Rall = Rs[-1][:T_B].contiguous()
    fl = (torch.rand(16, 2, H_B, W_B, generator=g) * 6 - 3).to(dev)
    ms = time_turns({
        "plain": lambda: flow_iter_pairs_plain(Rall, fl, f.winsize,
                                               f.fast_warp),
        "kernel": lambda: flow_iter_pairs(Rall, fl, f.winsize, f.fast_warp),
        "k2": lambda: [flow_iter(Rall[b], Rall[b + 1], fl[b], f.winsize,
                                 f.fast_warp) for b in range(16)]},
        reps=5)
    log(f"  K6 {H_B}x{W_B} bf16 B=16: kernel {ms['kernel']:.4f} ms "
        f"({ms['kernel dev']:.4f} on the device), 16 x K2 {ms['k2']:.4f} ms "
        f"({ms['k2 dev']:.4f}), plain {ms['plain']:.4f} ms")
    taps = 2 * (f.winsize // 2) + 1
    record(results, "flow_iter_pairs", worst, ms["kernel"], ms["plain"],
           T_B * 5 * H_B * W_B * 2 + 16 * H_B * W_B * 16,
           16 * H_B * W_B * fi_flops(taps), dev=ms)
    results["flow_iter_pairs"].update(k2_route_ms=ms["k2"],
                                      k2_route_device_ms=ms["k2 dev"])


@phase("K7a poly_expansion_planar_batch, K7b coarse_polyexp_fused_batch")
def check_k7(dev, clip_b, clips_c, cfg, results):
    """K7a and K7b at 720p N=17 and 1080p N=36: against the plain
    versions at K3's and K4's bars and against per-frame K3/K4 (bit for
    bit), and timed; the kernels line keeps 1080p N=36 (path C's
    shape)."""
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_polyexp_fused, coarse_polyexp_fused_batch,
        coarse_polyexp_fused_plain)
    from kalman_hydra_tpu_torch.kernels.polyexp import (
        poly_expansion_planar, poly_expansion_planar_batch,
        poly_expansion_planar_plain)
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.filters import pad1d
    from kalman_hydra_tpu_torch.ops.pyramid import gaussian_blur_level
    f = cfg.flow
    n, s = f.poly_n, f.poly_sigma
    e7a = e7b = 0.0
    for frames in (clip_b, clips_c.reshape((-1,) + clips_c.shape[2:])):
        grays = grayscale_u8(torch.from_numpy(frames).to(dev))
        N, h, w = grays.shape
        img0 = gaussian_blur_level(grays, f, k=0)
        for dt in (torch.float32, torch.bfloat16):
            got = poly_expansion_planar_batch(img0, n, s, dt)
            per = torch.stack([poly_expansion_planar(i, n, s, dt)
                               for i in img0])
            ref = poly_expansion_planar_plain(img0, n, s, dt).float()
            same = torch.equal(got, per)
            if dt == torch.float32:
                e = max_err(got, ref)
                e7a = max(e7a, e)
                line = f"f32 vs plain {e:.3e} (bar 1e-3)"
                assert e < 1e-3
            else:
                u = ((got.float() - ref).abs() / bf16_ulp(ref)).max().item()
                line = f"bf16 vs plain {u:.2f} ulp (bar 1)"
                assert u <= 1.0
            log(f"  K7a {h}x{w} N={N} {line}; vs per-frame K3 "
                f"{'bit-identical' if same else 'DIFFERENT'}")
            assert same
        args = (f.levels, f.pyr_scale, n, s)
        got = coarse_polyexp_fused_batch(grays, *args)
        ref = coarse_polyexp_fused_plain(grays, *args)
        per = [coarse_polyexp_fused(gr, *args) for gr in grays]
        errs = [max_err(a, b) for a, b in zip(got, ref)]
        same = all(torch.equal(got[li][i], per[i][li])
                   for i in range(N) for li in range(len(got)))
        e7b = max(e7b, *errs)
        log(f"  K7b {h}x{w} N={N} f32 vs plain per level "
            f"{['%.2e' % e for e in errs]} (bar 1e-3); vs per-frame K4 "
            f"{'bit-identical' if same else 'DIFFERENT'}")
        assert max(errs) < 1e-3 and same
        bf = torch.bfloat16
        pad = pad1d(pad1d(img0, n, n, -2, "replicate"), n, n, -1,
                    "replicate").contiguous()
        ms = time_turns({
            "plain": lambda: poly_expansion_planar_plain(img0, n, s, bf),
            "kernel": lambda: poly_expansion_planar_batch(img0, n, s, bf),
            "per_frame": lambda: [poly_expansion_planar(i, n, s, bf)
                                  for i in img0],
            "library": polyexp_conv(pad, n, s)}, reps=3)
        log(f"  K7a {h}x{w} N={N}: kernel {ms['kernel']:.4f} ms, {N} x K3 "
            f"{ms['per_frame']:.4f} ms")
        record(results, "poly_expansion_planar_batch", e7a, ms["kernel"],
               ms["plain"], N * h * w * (4 + 5 * 2),
               N * h * w * pe_flops(n), ms["library"], dev=ms)
        ms = time_turns({
            "plain": lambda: coarse_polyexp_fused_plain(grays, *args,
                                                        out_dtype=bf),
            "kernel": lambda: coarse_polyexp_fused_batch(grays, *args,
                                                         out_dtype=bf),
            "per_frame": lambda: [coarse_polyexp_fused(gr, *args,
                                                       out_dtype=bf)
                                  for gr in grays]}, reps=3)
        log(f"  K7b {h}x{w} N={N}: kernel {ms['kernel']:.4f} ms, {N} x K4 "
            f"{ms['per_frame']:.4f} ms")
        record(results, "coarse_polyexp_fused_batch", e7b, ms["kernel"],
               ms["plain"], N * k4_bytes(h, w, f, 2),
               N * k4_flops(h, w, f), dev=ms)


def takes_k1(cfg) -> bool:
    """K1 runs the position update with a shared Q; a per-track Q
    (adaptive_q) or a nonlinear measurement takes the plain update."""
    return cfg.ekf.measurement == "position" and cfg.ekf.adaptive_q <= 0


def per_frame_expected(cfg, h, w, t) -> dict:
    """Launches of a per-frame run of t frames at h x w, from the plan and
    K5's own gate: per frame one pyramid (K4 + K3, or K11 + K3 on every
    level at pe_fused=False); per step each level runs `iterations` K8
    (exact warp), one K5 (fast warp under the gate), one K13
    (fi_pipeline, iterations >= 2) or `iterations` K2, and one K1 where
    `takes_k1`. measurement="photometric" computes no flow and launches
    nothing, nor does "render" (the mesh-render channel); "flow_render"
    takes the flow's launches and the implicit-flow update (no K1).
    Lucas-Kanade: see the branches below."""
    from kalman_hydra_tpu_torch import kernels
    from kalman_hydra_tpu_torch.kernels.flow_level import (MAX_LEVELS, fits,
                                                           walk_fits)
    from kalman_hydra_tpu_torch.kernels.level_image import (
        MAX_LEVELS as LEVEL_IMAGE_LEVELS)
    from kalman_hydra_tpu_torch.ops.pyramid import farneback_levels
    f = cfg.flow
    e = dict.fromkeys(kernels.WRAPPERS, 0)
    if cfg.ekf.measurement in ("photometric", "render"):
        return e
    if f.method in ("lk_sparse", "lk_dense"):
        from kalman_hydra_tpu_torch.kernels.lk import MAX_LEVELS as LK_LEVELS
        from kalman_hydra_tpu_torch.kernels.pyramid import LAUNCH_LEVELS
        from kalman_hydra_tpu_torch.kernels.scharr import \
            MAX_LEVELS as SCHARR_LEVELS
        k9 = -(-(f.levels - 1) // LAUNCH_LEVELS)    # K9 launches a pyramid
        k10 = -(-f.levels // SCHARR_LEVELS)         # K10 launches
        k12 = -(-f.levels // LK_LEVELS)             # K12 walks a step
    if f.method == "lk_sparse":
        # one lk_pyramid per frame (frame 0's is cached): K9 and K10
        # launches; K12's walks a step over every level; the position
        # update is plain torch, not K1
        e.update(pyr_down_levels=k9 * t, scharr_gradients_levels=k10 * t,
                 lk_sparse_levels=k12 * (t - 1))
        return e
    if f.method == "lk_dense":
        # per step both frames' pyramids and the previous frame's Scharr
        # planes of every level (K10), then K1
        e.update(pyr_down_levels=2 * k9 * (t - 1),
                 scharr_gradients_levels=k10 * (t - 1),
                 ekf_fused_step=(t - 1) * takes_k1(cfg))
        return e
    plan = farneback_levels(h, w, f.levels, f.pyr_scale)
    coarse = -(-(len(plan) - 1) // LEVEL_IMAGE_LEVELS)  # K4/K11 launches
    walked = 0
    for (_k, lh, lw, _s, _ks) in plan:
        if f.fast_warp <= 0:
            e["flow_update"] += f.iterations * (t - 1)
        elif f.fi_level_fused and walk_fits(f.winsize) and \
                fits(lh, lw, 2 if f.bf16_poly else 4):
            walked += 1     # one walk for each MAX_LEVELS of them
            e["flow_levels"] = -(-walked // MAX_LEVELS) * (t - 1)
        elif f.fi_pipeline and f.iterations >= 2:
            e["flow_iters_pipelined"] += t - 1
        else:
            e["flow_iter"] += f.iterations * (t - 1)
    if f.pe_fused:
        e.update(poly_expansion_planar=t, coarse_polyexp_fused=coarse * t)
    else:
        e.update(poly_expansion_planar=t * len(plan),
                 coarse_level_images=coarse * t)
    e["ekf_fused_step"] = (t - 1) * takes_k1(cfg)
    return e


def pair_expected(cfg, h, w, clips, t) -> dict:
    """Launches of a pair-batched run over `clips` clips of t frames: one
    K7b and one K7a for all frames, one K6 (fast warp) or K8-pairs (exact
    warp) per level iteration, and K1 once per step of each clip where
    `takes_k1` (the clips are filtered in turn; clips=0 for flow
    alone)."""
    from kalman_hydra_tpu_torch import kernels
    from kalman_hydra_tpu_torch.ops.pyramid import farneback_levels
    f = cfg.flow
    e = dict.fromkeys(kernels.WRAPPERS, 0)
    flow_kernel = "flow_iter_pairs" if f.fast_warp > 0 else \
        "flow_update_pairs"
    e.update({"poly_expansion_planar_batch": 1,
              "coarse_polyexp_fused_batch": 1,
              flow_kernel: len(farneback_levels(h, w, f.levels, f.pyr_scale))
              * f.iterations,
              "ekf_fused_step": clips * (t - 1) * takes_k1(cfg)})
    return e


def drive(name, fn, expect, counts_by_path):
    """Reset every launch counter, run fn, read the counters: they must
    equal `expect`."""
    from kalman_hydra_tpu_torch import kernels
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    counts_by_path[name] = counts
    log(f"  {name} launches {({k: v for k, v in counts.items() if v})} "
        f"(expected {({k: v for k, v in expect.items() if v})})")
    assert counts == expect
    return out


def check_tracks(tr, t, k):
    assert tr.positions.shape == (t, k, 2) and tr.alive.shape == (t, k)
    assert np.isfinite(tr.positions).all() and np.isfinite(tr.nis).all()
    live = int(tr.alive[-1].sum())
    log(f"  outputs finite; live tracks at the last frame: {live}/{k}")
    assert live > 0


def same_tracks(a, b, what):
    err = np.abs(a.positions - b.positions).max()
    same = bool((a.alive == b.alive).all() and
                (a.track_id == b.track_id).all())
    sm = ("" if a.smoothed is None else
          f"; smoothed {np.abs(a.smoothed - b.smoothed).max():.3e} px")
    log(f"  {what}: max |pos diff| {err:.3e} px (bar 1e-3); alive and "
        f"track_id identical: {same}{sm}")
    assert err < 1e-3 and same
    assert (a.smoothed is None) == (b.smoothed is None)
    if a.smoothed is not None:
        assert np.abs(a.smoothed - b.smoothed).max() < 1e-3


@contextlib.contextmanager
def per_level_route():
    """The Lucas-Kanade pyramids as they ran before one launch a
    pyramid: K9 and K10 once a level, through their one-level calls
    (pyr_down, scharr_gradients), patched into ops.lk for the comparison
    of routes alone; the same kernels, so the same values."""
    from kalman_hydra_tpu_torch.kernels.pyramid import pyr_down
    from kalman_hydra_tpu_torch.kernels.scharr import scharr_gradients
    from kalman_hydra_tpu_torch.ops import lk

    def build(img, levels):
        pyr = [img]
        for _ in range(levels - 1):
            pyr.append(pyr_down(pyr[-1]))
        return pyr
    saved = lk.build_pyramid, lk.scharr_gradients_levels
    lk.build_pyramid = build
    lk.scharr_gradients_levels = lambda pyr: tuple(scharr_gradients(a)
                                                   for a in pyr)
    try:
        yield
    finally:
        lk.build_pyramid, lk.scharr_gradients_levels = saved


def route_compare(label, fn, cfg, expect, tr, steps, name, reps=2):
    """The per-level route against one launch a pyramid: its launches
    (K9 levels - 1 and K10 levels a pyramid), its tracks equal to `tr`
    (0 px; alive, track_id and any smoothed positions identical), and
    frames/s of both in 8 alternating turns of `reps` runs (new, old,
    old, new, ...), medians and ranges reported. A record of the routes,
    not a claim: these paths are host-bound."""
    from kalman_hydra_tpu_torch.kernels.pyramid import LAUNCH_LEVELS
    lv = cfg.flow.levels
    k9 = -(-(lv - 1) // LAUNCH_LEVELS)
    old = dict(expect)
    old["pyr_down_levels"] = expect["pyr_down_levels"] // k9 * (lv - 1)
    old["scharr_gradients_levels"] = expect["scharr_gradients_levels"] * lv
    with per_level_route():
        tr_old = drive(f"{label} per-level route", fn, old, {})
    same = (np.array_equal(tr.positions, tr_old.positions)
            and np.array_equal(tr.alive, tr_old.alive)
            and np.array_equal(tr.track_id, tr_old.track_id)
            and (tr.smoothed is None) == (tr_old.smoothed is None)
            and (tr.smoothed is None
                 or np.array_equal(tr.smoothed, tr_old.smoothed)))
    log(f"  {label}: per-level route's tracks identical to one launch a "
        f"pyramid (positions, alive, track_id): {same}")
    assert same
    ts = {"new": [], "old": []}
    for route in ("new", "old", "old", "new") * 2:
        if route == "old":
            with per_level_route():
                ts[route] += clip_seconds(fn, reps)
        else:
            ts[route] += clip_seconds(fn, reps)
    fps = {k: steps / statistics.median(v) for k, v in ts.items()}
    rng = {k: f"{steps / max(v):.2f}-{steps / min(v):.2f}"
           for k, v in ts.items()}
    log(f"  {label} frames/s in turns: one launch a pyramid {fps['new']:.2f}"
        f" ({rng['new']}), per-level launches {fps['old']:.2f} "
        f"({rng['old']}) (medians and ranges of {4 * reps} runs each; "
        f"{name})")
    return fps


def clip_seconds(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


@phase("path A (api.track_video, 1080p T=9 K=1024, fi_level_fused=True)")
def path_a(dev, clip, cfg, counts_by_path):
    from kalman_hydra_tpu_torch import api
    tr = drive("A", lambda: api.track_video(clip, cfg, device=dev),
               per_frame_expected(cfg, H, W, T), counts_by_path)
    check_tracks(tr, T, K)


def plain_pyramid(g, f):
    """A frame's polyexp pyramid, coarsest first, composed from the
    kernels' plain versions only, as ops.farneback.polyexp_pyramid
    composes the kernels."""
    from kalman_hydra_tpu_torch.kernels.level_image import (
        coarse_level_images_plain, coarse_polyexp_fused_plain)
    from kalman_hydra_tpu_torch.kernels.polyexp import \
        poly_expansion_planar_plain
    from kalman_hydra_tpu_torch.ops.pyramid import gaussian_blur_level
    dt = torch.bfloat16 if f.bf16_poly else torch.float32
    n, s = f.poly_n, f.poly_sigma
    img0 = gaussian_blur_level(g, f, k=0)
    if not f.pe_fused:
        return [poly_expansion_planar_plain(i, n, s, dt) for i in
                coarse_level_images_plain(g, f.levels, f.pyr_scale)
                + [img0]]
    return (coarse_polyexp_fused_plain(g, f.levels, f.pyr_scale, n, s, dt)
            + [poly_expansion_planar_plain(img0, n, s, dt)])


def plain_levels(Rs_a, Rs_b, f):
    """Flow (h, w, 2) from two pyramids through the kernels' plain
    versions only, as ops.farneback.farneback_from_pyramids composes the
    kernels."""
    from kalman_hydra_tpu_torch.kernels.flow_iter import flow_iter_plain
    from kalman_hydra_tpu_torch.kernels.flow_update import flow_update_plain
    from kalman_hydra_tpu_torch.ops.pyramid import resize_linear
    flow = None
    for R0, R1 in zip(Rs_a, Rs_b):
        lh, lw = R0.shape[1:]
        flow = (torch.zeros((2, lh, lw), device=R0.device) if flow is None
                else resize_linear(flow, lh, lw) * (1.0 / f.pyr_scale))
        for _ in range(f.iterations):
            if f.fast_warp <= 0:
                flow = flow_update_plain(R0, R1, flow, f.winsize,
                                         f.gaussian_win)
            else:
                flow = flow_iter_plain(R0, R1, flow, f.winsize, f.fast_warp,
                                       f.gaussian_win)
    return flow.movedim(0, -1)


def plain_flow(g0, g1, f):
    """Frame-pair flow (H, W, 2) composed from the kernels' plain versions
    only, as ops.farneback composes the kernels."""
    return plain_levels(plain_pyramid(g0, f), plain_pyramid(g1, f), f)


@phase("flow pair vs plain functions on the card")
def flow_vs_plain(dev, clip, cfgs):
    """The frame 0 -> 1 flow through the kernels against the composition
    of their plain versions, for each path's flow settings."""
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.farneback import (
        farneback_from_pyramids, polyexp_pyramid)
    g0, g1 = (grayscale_u8(torch.from_numpy(clip[i]).to(dev))
              for i in (0, 1))
    for label, cfg in cfgs.items():
        flows = [farneback_from_pyramids(polyexp_pyramid(g0, cfg.flow),
                                         polyexp_pyramid(g1, cfg.flow),
                                         cfg.flow),
                 plain_flow(g0, g1, cfg.flow)]
        epe = torch.linalg.vector_norm(flows[0] - flows[1], dim=-1)
        mag = torch.linalg.vector_norm(flows[1], dim=-1).mean().item()
        log(f"  path {label} frame 0->1 flow, kernels vs plain: mean EPE "
            f"{epe.mean().item():.3e} px (bar 1e-3), max "
            f"{epe.max().item():.3e} px; mean |flow| {mag:.3f} px")
        assert epe.mean().item() < 1e-3


def small_configs(cfg, pair_cfg, cfgs) -> dict:
    """The configurations held card against CPU at 128x160 T=5, K=32: the
    main and pair paths cut to 3 levels, and configurations (a), (c), (d)
    and (e) of tests/test_torch_default_path.py and test_torch_smooth.py:
    RunConfig() itself, pe_fused=False, temporal_init + init_velocity at
    both warps, and smoothing, monolithic and fixed-lag; Lucas-Kanade:
    sparse at halo 0 and 8, dense per frame and pair-batched; and paths
    AP (at fi_level_fused=False, so that K13 runs on every level), BX (f32
    and bf16 planes), I, P and W, cut to 3 levels and K=32."""
    from kalman_hydra_tpu_torch.config import (EkfConfig, FlowConfig,
                                               RunConfig, SmoothConfig,
                                               TrackConfig)
    out = {}
    for name, c in (("main path", cfg), ("pair path", pair_cfg)):
        out[name] = c.replace(
            flow=dataclasses.replace(c.flow, levels=3),
            tracks=dataclasses.replace(c.tracks, num_tracks=32,
                                       corner_pool=256, reinit_every=2))
    base = RunConfig(tracks=TrackConfig(num_tracks=32))
    warm = dataclasses.replace(base.tracks, init_velocity=True)
    out.update({
        "(a) RunConfig()": base,
        "(c) pe_fused=False": base.replace(flow=FlowConfig(pe_fused=False)),
        "(d) warm, exact warp": base.replace(
            flow=FlowConfig(temporal_init=True), tracks=warm),
        "(d) warm, fast_warp=8 fused": base.replace(
            flow=FlowConfig(temporal_init=True, fast_warp=8,
                            fi_level_fused=True), tracks=warm),
        "(e) RTS": base.replace(smooth=SmoothConfig(enabled=True)),
        "(e) fixed lag 2": base.replace(
            smooth=SmoothConfig(enabled=True, lag=2)),
        "lk_sparse halo 0": base.replace(
            flow=FlowConfig(method="lk_sparse")),
        "lk_sparse halo 8 corr_conv, 6-state": base.replace(
            flow=FlowConfig(method="lk_sparse", lk_block_halo=8,
                            lk_solver="corr_conv"),
            ekf=EkfConfig(state_dim=6)),
        "lk_dense fast_warp 8": base.replace(
            flow=FlowConfig(method="lk_dense", fast_warp=8)),
        "lk_dense pair-batched": base.replace(
            flow=FlowConfig(method="lk_dense", fast_warp=8),
            pair_batch=True),
        "BX bf16 planes": cfgs["BX"].replace(
            flow=FlowConfig(bf16_poly=True), tracks=base.tracks),
    })
    for name in ("AP", "BX", "I", "I ukf", "P", "P2", "W"):
        c = cfgs[name]
        flow = dataclasses.replace(c.flow, levels=3)
        if name == "AP":
            flow = dataclasses.replace(flow, fi_level_fused=False)
        out[name] = c.replace(flow=flow, tracks=dataclasses.replace(
            c.tracks, num_tracks=32, corner_pool=256))
    return out


@phase("small clips: CUDA path vs CPU path (per-frame, pair-batched, "
       "default, warm starts, smoothing, LK, K13, the exact pair path, "
       "the measurement channels, track_precomputed_flow)")
def small_vs_cpu(dev, cfg, pair_cfg, cfgs):
    from kalman_hydra_tpu_torch import api, pipeline
    from kalman_hydra_tpu_torch.io.synthetic import moving_blob_clip
    clip, _ = moving_blob_clip(num_frames=5, height=128, width=160,
                               num_points=8, seed=0)
    for name, small in small_configs(cfg, pair_cfg, cfgs).items():
        same_tracks(api.track_video(clip, small, device=dev),
                    api.track_video(clip, small, device="cpu"),
                    f"128x160 T=5 K=32 {name}: cuda vs cpu")
    # Q: the filter over the CPU's flows from the CPU's seeds, on both
    small = small_configs(cfg, pair_cfg, cfgs)["AP"]
    flows = api.flow_sequence(clip, small, device="cpu")
    seeds = api.track_video(clip, small, device="cpu").positions[0]
    same_tracks(pipeline.track_precomputed_flow(flows, seeds, small,
                                                device=dev),
                pipeline.track_precomputed_flow(flows, seeds, small,
                                                device="cpu"),
                "128x160 T=5 K=32 Q (track_precomputed_flow): cuda vs cpu")


@phase("path A throughput, fi_level_fused False and True in turns")
def throughput_a(dev, clip, cfg, name):
    from kalman_hydra_tpu_torch import api
    cfgs = {False: cfg.replace(flow=dataclasses.replace(
        cfg.flow, fi_level_fused=False)), True: cfg}
    # the unfused graph's own dispatch (K2 on every level, K5 never); its
    # counts stay out of the kernels line, which reads paths A, B and C
    drive("A unfused", lambda: api.track_video(clip, cfgs[False], device=dev),
          per_frame_expected(cfgs[False], H, W, T), {})
    times = {False: [], True: []}
    for fused in (False, True, True, False, False, True):
        times[fused] += clip_seconds(
            lambda: api.track_video(clip, cfgs[fused], device=dev), 1)
    med = {}
    for fused, ts in times.items():
        med[fused] = statistics.median(ts)
        log(f"  fi_level_fused={fused}: clip times "
            f"{['%.4f' % t for t in ts]} s; median {med[fused]:.4f} s -> "
            f"{(T - 1) / med[fused]:.2f} frames/s (1080p, T={T}, K={K}; "
            f"{name})")
    return med[True]


@phase("path B (api.track_video, 720p T=17 K=1024, pair_path_config)")
def path_b(dev, clip_b, pair_cfg, counts_by_path, name):
    from kalman_hydra_tpu_torch import api
    tr = drive("B", lambda: api.track_video(clip_b, pair_cfg, device=dev),
               pair_expected(pair_cfg, H_B, W_B, 1, T_B), counts_by_path)
    check_tracks(tr, T_B, K)
    per_frame = pair_cfg.replace(pair_batch=False, flow=dataclasses.replace(
        pair_cfg.flow, fi_level_fused=False))
    same_tracks(tr, api.track_video(clip_b, per_frame, device=dev),
                "pair path vs per-frame path (fi_level_fused=False)")
    ts = clip_seconds(lambda: api.track_video(clip_b, pair_cfg, device=dev))
    med = statistics.median(ts)
    log(f"  clip times {['%.4f' % t for t in ts]} s; median {med:.4f} s -> "
        f"{(T_B - 1) / med:.2f} frames/s (720p, T={T_B}, K={K}; {name})")
    return med


@phase("path C (api.track_videos, 4 x 1080p T=9 K=1024, pair_batch)")
def path_c(dev, clips_c, cfg_c, counts_by_path, name):
    from kalman_hydra_tpu_torch import api
    trs = drive("C", lambda: api.track_videos(clips_c, cfg_c, device=dev),
                pair_expected(cfg_c, H, W, N_CLIPS, T), counts_by_path)
    assert len(trs) == N_CLIPS
    for b, tr in enumerate(trs):
        check_tracks(tr, T, K)
        same_tracks(tr, api.track_video(clips_c[b], cfg_c, device=dev),
                    f"clip {b}: multi-clip vs the pair path on it alone")
    ts = clip_seconds(lambda: api.track_videos(clips_c, cfg_c, device=dev))
    med = statistics.median(ts)
    log(f"  batch times {['%.4f' % t for t in ts]} s; median {med:.4f} s "
        f"-> {N_CLIPS * (T - 1) / med:.2f} frames/s ({N_CLIPS} clips of "
        f"1080p, T={T}, K={K}; {name})")
    return med


def per_frame_fps(label, fn, steps, name) -> float:
    """Median clip time of 3 warm runs of fn (`steps` frame steps); prints
    frames/s beside the card."""
    ts = clip_seconds(fn)
    med = statistics.median(ts)
    log(f"  path {label} clip times {['%.4f' % t for t in ts]} s; median "
        f"{med:.4f} s -> {steps / med:.2f} frames/s ({name})")
    return med


@phase("path D (api.track_video with no config: RunConfig(), 1080p T=9)")
def path_d(dev, clip, counts_by_path, name):
    """The reference's default end to end: the exact warp (K8 on every
    level iteration), f32 planes, the 4-state filter, 256 tracks, a fresh
    corner pool every frame."""
    from kalman_hydra_tpu_torch import api
    from kalman_hydra_tpu_torch.config import RunConfig
    tr = drive("D", lambda: api.track_video(clip, device=dev),
               per_frame_expected(RunConfig(), H, W, T), counts_by_path)
    check_tracks(tr, T, RunConfig().tracks.num_tracks)
    return per_frame_fps("D", lambda: api.track_video(clip, device=dev),
                         T - 1, f"1080p, T={T}, K=256; {name}")


@phase("path D2 (RunConfig() with pe_fused=False, 1080p T=5)")
def path_d2(dev, clip, cfg_d2, counts_by_path, name):
    from kalman_hydra_tpu_torch import api
    clip = clip[:T_D2]
    tr = drive("D2", lambda: api.track_video(clip, cfg_d2, device=dev),
               per_frame_expected(cfg_d2, H, W, T_D2), counts_by_path)
    check_tracks(tr, T_D2, cfg_d2.tracks.num_tracks)
    return per_frame_fps("D2", lambda: api.track_video(clip, cfg_d2,
                                                       device=dev),
                         T_D2 - 1, f"1080p, T={T_D2}, K=256; {name}")


@phase("path E (bench's temporal warm-1 stage, 1080p T=9 K=1024)")
def path_e(dev, clip, cfg_e, counts_by_path, name):
    from kalman_hydra_tpu_torch import api
    tr = drive("E", lambda: api.track_video(clip, cfg_e, device=dev),
               per_frame_expected(cfg_e, H, W, T), counts_by_path)
    check_tracks(tr, T, K)
    return per_frame_fps("E", lambda: api.track_video(clip, cfg_e,
                                                      device=dev),
                         T - 1, f"1080p, T={T}, K={K}; {name}")


@phase("path F (bench cfg5 through api.smooth, 480x854 T=33)")
def path_f(dev, clip_f, cfg_f, counts_by_path, name):
    """RTS-smoothed tracks on the pair-batched path; `smoothed` held
    against models.rts run on the CPU over the card's own filter
    history."""
    from kalman_hydra_tpu_torch import api, pipeline
    from kalman_hydra_tpu_torch.models import dynamics
    from kalman_hydra_tpu_torch.models.rts import rts_smooth, segment_breaks
    tr = drive("F", lambda: api.smooth(clip_f, cfg_f, device=dev),
               pair_expected(cfg_f, H_F, W_F, 1, T_F), counts_by_path)
    check_tracks(tr, T_F, cfg_f.tracks.num_tracks)
    outs = {k: v.cpu() for k, v in pipeline.track_arrays(
        pipeline.upload(clip_f, dev), cfg_f, with_history=True).items()}
    xs, _ = rts_smooth(dynamics.transition(cfg_f.ekf), outs["x_filt"],
                       outs["P_filt"], outs["x_pred"], outs["P_pred"],
                       breaks=segment_breaks(outs["track_id"],
                                             outs["alive"]))
    e_cpu = np.abs(xs[..., 0:2].numpy() - tr.smoothed).max()
    e_run = np.abs(outs["smoothed"].numpy() - tr.smoothed).max()
    moved = np.abs(tr.smoothed - tr.positions)[tr.alive].mean()
    log(f"  smoothed vs models.rts on the CPU over the card's history: "
        f"max {e_cpu:.3e} px (bar 1e-3); vs a second card run "
        f"{e_run:.3e} px; mean |smoothed - filtered| {moved:.3f} px")
    assert e_cpu < 1e-3 and e_run < 1e-3
    return per_frame_fps("F", lambda: api.smooth(clip_f, cfg_f, device=dev),
                         T_F - 1, f"480x854, T={T_F}, K=256; {name}")


@phase("path G (bench cfg2's pixel-KF stage through api.flow_sequence, "
       "480x854 T=33)")
def path_g(dev, clip_f, cfg_g, counts_by_path, name):
    """Pair-batched flow of every frame pair, per-pixel KF smoothed; held
    against models.pixel_ekf on the CPU over the card's raw flows."""
    from kalman_hydra_tpu_torch import api
    from kalman_hydra_tpu_torch.models.pixel_ekf import smooth_flow_sequence
    sm = drive("G", lambda: api.flow_sequence(clip_f, cfg_g, smooth=True,
                                              device=dev),
               pair_expected(cfg_g, H_F, W_F, 0, T_F), counts_by_path)
    raw = api.flow_sequence(clip_f, cfg_g, device=dev)
    assert sm.shape == raw.shape == (T_F - 1, H_F, W_F, 2)
    assert np.isfinite(sm).all()
    ref = smooth_flow_sequence(torch.from_numpy(raw)).numpy()
    err = np.abs(sm - ref).max()
    log(f"  smoothed flows vs models.pixel_ekf on the CPU over the card's "
        f"raw flows: max {err:.3e} px (bar 1e-4); mean |raw flow| "
        f"{np.linalg.norm(raw, axis=-1).mean():.3f} px")
    assert err < 1e-4
    return per_frame_fps("G", lambda: api.flow_sequence(
        clip_f, cfg_g, smooth=True, device=dev), T_F - 1,
        f"frame pairs/s, 480x854, T={T_F}; {name}")


@phase("path H (bench --sparse through api.track_video, 1080p T=9 K=1024)")
def path_h(dev, clip, cfg_h, counts_by_path, name):
    """Sparse LK with the block window (lk_block_halo 8): K9 and K10 per
    frame, K12 per level per step, the plain position update."""
    from kalman_hydra_tpu_torch import api
    fn = lambda: api.track_video(clip, cfg_h, device=dev)   # noqa: E731
    e = per_frame_expected(cfg_h, H, W, T)
    tr = drive("H", fn, e, counts_by_path)
    check_tracks(tr, T, K)
    med = per_frame_fps("H", fn, T - 1, f"1080p, T={T}, K={K}; {name}")
    route_compare("H", fn, cfg_h, e, tr, T - 1, name)
    return med


@phase("path H0 (api.track_video, RunConfig(flow=FlowConfig(method="
       "'lk_sparse')), 1080p T=9)")
def path_h0(dev, clip, cfg_h0, counts_by_path, name):
    """The reference's sparse-LK defaults: K12's exact window."""
    from kalman_hydra_tpu_torch import api
    k = cfg_h0.tracks.num_tracks
    fn = lambda: api.track_video(clip, cfg_h0, device=dev)   # noqa: E731
    e = per_frame_expected(cfg_h0, H, W, T)
    tr = drive("H0", fn, e, counts_by_path)
    check_tracks(tr, T, k)
    med = per_frame_fps("H0", fn, T - 1, f"1080p, T={T}, K={k}; {name}")
    route_compare("H0", fn, cfg_h0, e, tr, T - 1, name)
    return med


def torch_ops(fn) -> int:
    """The number of ATen operators `fn` dispatches (each a kernel launch
    on the card, but for views and metadata): a count, not a time."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


@phase("path J (BASELINE config 1: dense LK, 256x256 T=33, per frame)")
def path_j(dev, clip_j, cfg_j, counts_by_path, name):
    """Dense LK (K9, K10 and plain torch) feeding K1, held against the
    pair-batched route on the card (the same flows, looped over pairs);
    the ATen operators of one frame pair's dense LK are counted."""
    from kalman_hydra_tpu_torch import api
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.lk import lk_dense
    k = cfg_j.tracks.num_tracks
    fn = lambda: api.track_video(clip_j, cfg_j, device=dev)   # noqa: E731
    e = per_frame_expected(cfg_j, H_J, W_J, T_J)
    tr = drive("J", fn, e, counts_by_path)
    check_tracks(tr, T_J, k)
    same_tracks(tr, api.track_video(clip_j, cfg_j.replace(pair_batch=True),
                                    device=dev),
                "per-frame path vs pair-batched path")
    g0, g1 = (grayscale_u8(torch.from_numpy(clip_j[i]).to(dev))
              for i in (0, 1))
    log(f"  J: one frame pair's lk_dense dispatches "
        f"{torch_ops(lambda: lk_dense(g0, g1, cfg_j.flow))} ATen operators")
    med = per_frame_fps("J", fn, T_J - 1, f"256x256, T={T_J}, K={k}; {name}")
    route_compare("J", fn, cfg_j, e, tr, T_J - 1, name, reps=1)
    return med


@phase("path AP (api.track_video, 1080p T=9 K=1024, fi_pipeline=True)")
def path_ap(dev, clip, cfg_ap, counts_by_path, name):
    """The headline graph with fi_pipeline (bench KH_FI_PIPE=1): K5 on
    the four coarse levels, one K13 launch on each of the two above the
    gate, no K2; held against path A's trajectories (the same values)."""
    from kalman_hydra_tpu_torch import api
    tr = drive("AP", lambda: api.track_video(clip, cfg_ap, device=dev),
               per_frame_expected(cfg_ap, H, W, T), counts_by_path)
    assert counts_by_path["AP"]["flow_iter"] == 0
    check_tracks(tr, T, K)
    cfg_a = cfg_ap.replace(flow=dataclasses.replace(cfg_ap.flow,
                                                    fi_pipeline=False))
    same_tracks(tr, api.track_video(clip, cfg_a, device=dev),
                "path AP vs path A (K13 vs 3 x K2 on the fine levels)")
    return per_frame_fps("AP", lambda: api.track_video(clip, cfg_ap,
                                                       device=dev),
                         T - 1, f"1080p, T={T}, K={K}; {name}")


@phase("path BX (api.track_video, RunConfig(pair_batch=True), 720p T=17)")
def path_bx(dev, clip_b, cfg_bx, counts_by_path, name):
    """The reference's defaults pair-batched: the exact gather of all 16
    pairs and one K8-pairs launch per level iteration; held against the
    per-frame path (RunConfig(): K8 per pair, the same values at f32)."""
    from kalman_hydra_tpu_torch import api
    k = cfg_bx.tracks.num_tracks
    tr = drive("BX", lambda: api.track_video(clip_b, cfg_bx, device=dev),
               pair_expected(cfg_bx, H_B, W_B, 1, T_B), counts_by_path)
    check_tracks(tr, T_B, k)
    same_tracks(tr, api.track_video(clip_b, cfg_bx.replace(
        pair_batch=False), device=dev),
        "pair path (K8-pairs) vs per-frame path (K8)")
    return per_frame_fps("BX", lambda: api.track_video(clip_b, cfg_bx,
                                                       device=dev),
                         T_B - 1, f"720p, T={T_B}, K={k}; {name}")


@phase("path I (AP with the implicit-flow IEKF, then the UKF, 1080p T=9)")
def path_i(dev, clip, cfgs_i, counts_by_path, name):
    """The 6-state implicit-flow IEKF (iekf_iters 2) and the UKF over
    AP's flow: AP's flow launches, no K1 (a nonlinear measurement takes
    the plain update, as in the reference)."""
    from kalman_hydra_tpu_torch import api
    med = None
    for label, c in cfgs_i.items():
        tr = drive(label, lambda c=c: api.track_video(clip, c, device=dev),
                   per_frame_expected(c, H, W, T), counts_by_path)
        check_tracks(tr, T, K)
        m = per_frame_fps(label, lambda c=c: api.track_video(
            clip, c, device=dev), T - 1, f"1080p, T={T}, K={K}; {name}")
        med = med or m
    return med


@phase("path P (RunConfig() photometric, then flow_photometric + "
       "adaptive_q + seed_in_body, 1080p T=9)")
def path_p(dev, clip, cfgs_p, counts_by_path, name):
    """measurement="photometric": Gauss-Newton on the frames, no flow and
    no kernel launch; then flow_photometric with adaptive_q 0.3 and
    seed_in_body: D's flow launches (K8 after the exact gather, K3, K4),
    no K1 (per-track Q)."""
    from kalman_hydra_tpu_torch import api
    med = None
    for label, c in cfgs_p.items():
        k = c.tracks.num_tracks
        tr = drive(label, lambda c=c: api.track_video(clip, c, device=dev),
                   per_frame_expected(c, H, W, T), counts_by_path)
        check_tracks(tr, T, k)
        m = per_frame_fps(label, lambda c=c: api.track_video(
            clip, c, device=dev), T - 1, f"1080p, T={T}, K={k}; {name}")
        med = med or m
    return med


@phase("path W (docs/WALKTHROUGH.md section 3, 1080p T=9)")
def path_w(dev, clip, cfg_w, counts_by_path, name):
    """Sparse LK (lk_block_halo 8), 6-state, adaptive_q 0.3, fixed-lag 8:
    H's launches (K9, K10, K12), the plain update; smoothed positions
    finite."""
    from kalman_hydra_tpu_torch import api
    k = cfg_w.tracks.num_tracks
    fn = lambda: api.track_video(clip, cfg_w, device=dev)   # noqa: E731
    e = per_frame_expected(cfg_w, H, W, T)
    tr = drive("W", fn, e, counts_by_path)
    check_tracks(tr, T, k)
    assert tr.smoothed is not None and np.isfinite(tr.smoothed).all()
    med = per_frame_fps("W", fn, T - 1, f"1080p, T={T}, K={k}; {name}")
    route_compare("W", fn, cfg_w, e, tr, T - 1, name)
    return med


@phase("path Q (pipeline.track_precomputed_flow over AP's 8 flows)")
def path_q(dev, clip, cfg_ap, counts_by_path, name):
    """The filter alone over AP's own frame-pair flows from AP's 1024
    seeds: K1 once a step; held against the same call on the CPU."""
    from kalman_hydra_tpu_torch import api, pipeline
    flows = api.flow_sequence(clip, cfg_ap, device=dev)
    seeds = api.track_video(clip, cfg_ap, device=dev).positions[0]
    cfg_q = cfg_ap.replace(tracks=dataclasses.replace(cfg_ap.tracks,
                                                      reinit=False))
    e = per_frame_expected(cfg_q, H, W, T)
    e = {k: (v if k == "ekf_fused_step" else 0) for k, v in e.items()}
    tr = drive("Q", lambda: pipeline.track_precomputed_flow(
        flows, seeds, cfg_q, device=dev), e, counts_by_path)
    check_tracks(tr, T, K)
    same_tracks(tr, pipeline.track_precomputed_flow(flows, seeds, cfg_q,
                                                    device="cpu"),
                "track_precomputed_flow, card vs CPU")
    return per_frame_fps("Q", lambda: pipeline.track_precomputed_flow(
        flows, seeds, cfg_q, device=dev), T - 1,
        f"steps/s, 1080p flows, K={K}; {name}")


T_MEM = 65                                 # path S-mem's long stream
MEM_BAR = 8 * 2**20                        # a 1080p RGB frame is 6.2 MB


def stream_dir() -> Path:
    """Scratch for the streamed paths' files, in the git-ignored build/
    of this checkout (deleted at the end of the run)."""
    d = Path(__file__).resolve().parent / "build" / "chip_smoke_stream"
    d.mkdir(parents=True, exist_ok=True)
    return d


def identical(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("positions", "alive", "nis", "track_id"))


def path_stream(label, ref, dev, npy, clip, cfg, counts_by_path):
    """A path's config (None: RunConfig()) streamed from the .npy clip
    through api.track_video(streaming=True): the launches of the
    per-frame path, the same tracks as the path's array run (< 1e-3 px,
    alive and track_id identical)."""
    from kalman_hydra_tpu_torch import api
    from kalman_hydra_tpu_torch.config import RunConfig

    @phase(f"path {label} (api.track_video(clip.npy, streaming=True), "
           f"{ref}'s config, 1080p T={T})")
    def run():
        c = cfg or RunConfig()
        tr = drive(label, lambda: api.track_video(
            str(npy), cfg, streaming=True, device=dev),
            per_frame_expected(c, H, W, T), counts_by_path)
        check_tracks(tr, T, c.tracks.num_tracks)
        arr = api.track_video(clip, cfg, device=dev)
        same_tracks(tr, arr, f"{label} streamed vs {ref}'s array run")
        log(f"  {label} bit-identical to {ref}'s array run: "
            f"{identical(tr, arr)}")
    return run()


def walk(clip, n):
    """n frames walking the clip forward and back (0..8, 7..0, 1..)."""
    i, step = 0, 1
    for _ in range(n):
        yield clip[i]
        if not 0 <= i + step < len(clip):
            step = -step
        i += step


def peak_bytes(dev, fn) -> int:
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)


@phase(f"path S-mem (A's config streamed over {T} and {T_MEM} frames: peak "
       "card memory)")
def path_s_mem(dev, clip, cfg):
    """O(1) card memory in the stream's length: the 65-frame stream's
    peak within MEM_BAR of the 9-frame one's; track_clip's peak on the
    same 65 frames for contrast."""
    from kalman_hydra_tpu_torch import pipeline
    peaks, runs = {}, {}
    for n in (T, T_MEM):
        peaks[n] = peak_bytes(dev, lambda: runs.__setitem__(
            n, pipeline.track_stream(walk(clip, n), cfg, device=dev)))
        check_tracks(runs[n], n, K)
    frames = np.stack(list(walk(clip, T_MEM)))
    clip_peak = peak_bytes(dev, lambda: pipeline.track_clip(
        frames, cfg, device=dev))
    mib = {n: v / 2**20 for n, v in peaks.items()}
    log(f"  peak card memory (max_memory_allocated): {T} frames streamed "
        f"{mib[T]:.1f} MiB, {T_MEM} frames streamed {mib[T_MEM]:.1f} MiB "
        f"(gap {mib[T_MEM] - mib[T]:.2f} MiB, bar "
        f"{MEM_BAR / 2**20:.0f} MiB); track_clip of the {T_MEM} frames "
        f"{clip_peak / 2**20:.1f} MiB")
    assert peaks[T_MEM] - peaks[T] < MEM_BAR


@phase("path S-ckpt (checkpoint every frame over 5 frames, then a resume "
       "over all 9: A's and W's configs)")
def path_s_ckpt(dev, clip, cfgs):
    """The resumed rows (frames 5-8) against the uninterrupted stream's
    tail: < 1e-4 px (smoothed positions too), alive and track_id
    identical."""
    from kalman_hydra_tpu_torch import pipeline
    for label in ("A", "W"):
        cfg = cfgs[label]
        ck = str(stream_dir() / f"ckpt_{label}.npz")
        full = pipeline.track_stream(iter(clip), cfg, device=dev)
        pipeline.track_stream(iter(clip[:5]), cfg, checkpoint_path=ck,
                              checkpoint_every=1, device=dev)
        res = pipeline.track_stream(iter(clip), cfg, checkpoint_path=ck,
                                    resume=True, device=dev)
        n = res.positions.shape[0]
        tail = {f: getattr(full, f)[-n:] for f in
                ("positions", "alive", "nis", "track_id", "smoothed")
                if getattr(full, f) is not None}
        err = np.abs(res.positions - tail["positions"]).max()
        sm = (0.0 if res.smoothed is None
              else np.abs(res.smoothed - tail["smoothed"]).max())
        same = bool(np.array_equal(res.alive, tail["alive"])
                    and np.array_equal(res.track_id, tail["track_id"]))
        bits = same and all(np.array_equal(getattr(res, f), tail[f])
                            for f in ("positions", "nis"))
        log(f"  {label}: resumed {n} rows vs the uninterrupted tail: max "
            f"|pos diff| {err:.3e} px, smoothed {sm:.3e} px (bar 1e-4); "
            f"alive and track_id identical: {same}; bit-identical: {bits}")
        assert n == T - 5 and err < 1e-4 and sm < 1e-4 and same
        assert (res.smoothed is None) == (full.smoothed is None)


@phase(f"path S-F (F's config, RTS, streamed per frame, {H_F}x{W_F} "
       f"T={T_F})")
def path_s_f(dev, clip_f, cfg_f, counts_by_path):
    """The stream keeps the filter history in host memory and smooths it
    chunk by chunk; its smoothed positions within 1e-3 px of track_clip's
    (one RTS on the card) at pair_batch=False."""
    from kalman_hydra_tpu_torch import api, pipeline
    tr = drive("S-F", lambda: api.track_video(clip_f, cfg_f, streaming=True,
                                              device=dev),
               per_frame_expected(cfg_f, H_F, W_F, T_F), counts_by_path)
    check_tracks(tr, T_F, cfg_f.tracks.num_tracks)
    ref = pipeline.track_clip(clip_f, cfg_f.replace(pair_batch=False),
                              device=dev)
    same_tracks(tr, ref, "S-F streamed vs track_clip at pair_batch=False")


@phase("path S-cli (cli track --stream --checkpoint, then --resume, "
       "1080p T=5)")
def path_s_cli(dev, clip, cfg):
    """The CLI on A's config (--config): both runs exit 0 and write their
    .report.json."""
    from kalman_hydra_tpu_torch import cli
    d = stream_dir()
    npy, cfg_json, ck = d / "cli_clip.npy", d / "cli_cfg.json", \
        d / "cli_ckpt.npz"
    np.save(npy, clip[:5])
    cfg_json.write_text(cfg.to_json())
    for i, extra in enumerate(([], ["--resume"])):
        out = d / f"cli_tracks_{i}.npz"
        rc = cli.main(["track", str(npy), "--out", str(out), "--config",
                       str(cfg_json), "--stream", "--checkpoint", str(ck),
                       "--checkpoint-every", "2", "--device", str(dev)]
                      + extra)
        report = json.loads(out.with_suffix(".report.json").read_text())
        log(f"  cli track --stream{' --resume' if extra else ''}: exit "
            f"{rc}; report: {report['frames']} frames, live fraction "
            f"{report['live_fraction_last']:.3f}")
        assert rc == 0 and report["frames"] == (1 if extra else 5)


@phase("decoders on this host (cv2, the native loader) against the .npy")
def check_decoders(clip):
    """Both are optional, as in the reference: where both are present the
    clip goes through each as MJPG (lossy), and each must give its 9
    frames within a mean |diff| of 4 of the .npy frames and of 2 of each
    other (the reference's bar between two decoders)."""
    import importlib.util
    from kalman_hydra_tpu_torch.io import native_loader
    from kalman_hydra_tpu_torch.io.video import FrameStream
    have_cv2 = importlib.util.find_spec("cv2") is not None
    have_native = native_loader.available()
    log(f"  cv2 available: {have_cv2}; native loader available: "
        f"{have_native}")
    if not (have_cv2 and have_native):
        return
    import cv2
    avi = str(stream_dir() / "clip.avi")
    wr = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"), 30, (W, H))
    for f in clip:
        wr.write(np.ascontiguousarray(f))
    wr.release()
    py = FrameStream(avi).read_all()
    ns = native_loader.NativeFrameStream(avi)
    nat = ns.read_all()
    ns.close()
    d_py = np.abs(py.astype(np.int16) - clip).mean()
    d_nat = np.abs(nat.astype(np.int16) - py).mean()
    log(f"  MJPG through cv2: mean |diff| vs the .npy {d_py:.3f}; native "
        f"vs cv2 {d_nat:.3f}")
    assert py.shape == nat.shape == clip.shape
    assert d_py < 4 and d_nat < 2


@phase("path S-fps (S and A's array run, frames/s in turns)")
def path_s_fps(dev, npy, clip, cfg, name):
    """Median of 3 warm runs of each, in turns (A, S, S, A, A, S). A
    record, not a claim. Returns S's median clip time."""
    from kalman_hydra_tpu_torch import api
    fns = {"A (array)": lambda: api.track_video(clip, cfg, device=dev),
           "S (streamed .npy)": lambda: api.track_video(
               str(npy), cfg, streaming=True, device=dev)}
    a, s = fns
    ts = {k: [] for k in fns}
    for k in (a, s, s, a, a, s):
        ts[k] += clip_seconds(fns[k], 1)
    for k, v in ts.items():
        log(f"  {k}: clip times {['%.4f' % t for t in v]} s; median "
            f"{statistics.median(v):.4f} s -> "
            f"{(T - 1) / statistics.median(v):.2f} frames/s (1080p, T={T}, "
            f"K={K}; {name})")
    return statistics.median(ts[s])


def profile_path(label, fn, steps, trace_path, clip_s):
    """Device busy time, idle share and the top device consumers of one
    warm run of `fn` (a path's clip or clip batch, `steps` frame steps);
    the Chrome trace goes to trace_path (none if it is None).

    The profiler slows the host loop, so the idle share is taken against
    the unprofiled median time `clip_s` of this process (the metric's own
    wall) and, as a second reading, against the span from the first to
    the last device event of the profiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    @phase(f"profile path {label} (one warm run under torch.profiler)")
    def run():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev_events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and e.name != "Activity Buffer Request"]   # CUPTI's
        copies = [e for e in dev_events if e.name.startswith("Mem")]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in dev_events)
        busy, end = 0.0, -1.0
        for a, b in spans:               # union of device intervals (us)
            if b > end:
                busy += b - max(a, end)
                end = b
        busy /= 1e3
        span = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
        copy_ms = sum(e.time_range.elapsed_us() for e in copies) / 1e3
        unprof = clip_s * 1e3 if clip_s else float("nan")
        nk = len(dev_events) - len(copies)
        log(f"  path {label} profiled: wall {wall:.3f} ms under the "
            f"profiler, {unprof:.3f} ms unprofiled (median above); device "
            f"busy {busy:.3f} ms = kernels {busy - copy_ms:.3f} ms in {nk} "
            f"launches ({nk / steps:.0f}/frame step) + copies "
            f"{copy_ms:.3f} ms in {len(copies)}")
        log(f"  path {label} device idle share: {1 - busy / unprof:.3f} of "
            f"the unprofiled time; {1 - busy / span:.3f} of the "
            f"device-event span ({span:.3f} ms)")
        log(prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=20,
                                      max_name_column_width=60))
        if trace_path:
            prof.export_chrome_trace(trace_path)
            log(f"  chrome trace written to {trace_path}")
        return 1 - busy / unprof
    return run()


# ------------------------------------------------ mesh render (P11b), P14

H_R480, W_R480 = 480, 640                  # path R-480 (fps_render_480p_v64)
V_R, V_R480 = 256, 64                      # mesh vertices (bench --render)
BODY = dict(stretch=(0.12, -0.08), omega=0.35,   # deforming_body_clip's
            velocity=(0.6, 0.3))                 # defaults
# R and RF at 1080p: the default deformation scaled by 480/1080, so that
# the mesh moves as many px a frame as R-480's does. The default moves
# the 1080p mesh (near the body's top: segment_body grows its region at
# most 64 px from its seed) ~8 px a frame, past the Gauss-Newton's reach
# (5 sweeps of <= 2 px); path R-bench runs it. The reference loses the
# mesh there as the port does (tools/torch_render_reach.py on the CPU:
# 33.18 px median error at frame 8 in both).
STRETCH_R = (0.12 * 480 / 1080, -0.08 * 480 / 1080)
TRUTH_SLACK = 0.05                         # px, card's median error vs CPU's
# R-bench, card vs CPU once the mesh is lost: the rounding of the EKF's
# products (cuBLAS against the CPU's) grows there. Read 7.385e-3 px on
# the H100; the port's CPU run and the reference's part by 3.513e-2 px
# on the same clip (tools/torch_render_reach.py). A fault moves px.
R_BENCH_BAR = 5e-2
# R-mesh: max_shear = lam1 / lam2 with lam2^2 = (tr - disc) / 2. tr and
# disc carry ~lam1^2 * eps each, so lam2^2, and with it the shear, moves
# by ~eps * shear^2 (relative) for each ulp of their difference.
SHEAR_ULPS = 4


def body_clip(h, w, stretch=BODY["stretch"]):
    from kalman_hydra_tpu_torch.io.synthetic import deforming_body_clip
    frames, _, _ = deforming_body_clip(num_frames=T, height=h, width=w,
                                       seed=0, **dict(BODY, stretch=stretch))
    return frames


def mesh_truth(mesh, h, w, stretch) -> np.ndarray:
    """(T, V, 2) true positions of the mesh's vertices under the clip's
    forward map x(q, t) = c0 + v t + A(t) (q - c0), A(t) = diag(1 + sx
    sin(w t), 1 + sy sin(w t)) (tests/unit/test_render.py::_mesh_truth)."""
    sx, sy = stretch
    om = BODY["omega"]
    v = np.float32(BODY["velocity"])
    c0 = np.float32([w * 0.5, h * 0.5])
    out = np.empty((T, len(mesh.vertices), 2), np.float32)
    for t in range(T):
        a = np.float32([1 + sx * np.sin(om * t), 1 + sy * np.sin(om * t)])
        out[t] = c0 + v * t + (mesh.vertices - c0) * a[None, :]
    return out


def tracks_hash(tr) -> str:
    import hashlib
    m = hashlib.sha256()
    for a in (tr.positions, tr.alive, tr.nis, tr.track_id):
        m.update(np.ascontiguousarray(a).tobytes())
    return m.hexdigest()[:16]


def mesh_config(measurement, flow=None):
    """api.track_mesh's own default (measurement "render", q 0.5, no
    reinit), with `measurement` and, for flow_render, A's FlowConfig."""
    from kalman_hydra_tpu_torch.config import (EkfConfig, FlowConfig,
                                               RunConfig, TrackConfig)
    return RunConfig(flow=flow or FlowConfig(),
                     ekf=EkfConfig(measurement=measurement, q=0.5),
                     tracks=TrackConfig(reinit=False))


def median_error(tr, truth) -> float:
    """The median vertex error (px) at the last frame."""
    return float(np.median(np.linalg.norm(tr.positions[-1] - truth[-1],
                                          axis=-1)))


def mesh_path(label, dev, clip, stretch, cfg, v, counts_by_path, name,
              profile):
    """api.track_mesh on the card: its launches (none of K1-K13 for
    render; A's flow kernels and no K1 for flow_render), finite tracks,
    two runs with equal hashes, the mesh and tracks of the same call on
    the CPU (positions < 1e-3 px, alive and track_id identical), the
    median vertex error against the clip's truth no worse than the CPU's
    + TRUTH_SLACK (`stretch`: the clip's); frames/s of the API call and
    of the tracking alone (track_clip with the template), and the device
    idle share of one warm run of each. Returns (mesh, tracks, template)
    or None."""
    from kalman_hydra_tpu_torch import api, pipeline
    from kalman_hydra_tpu_torch.models.render import make_template
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    h, w = clip.shape[1:3]

    @phase(f"path {label} (api.track_mesh, {cfg.ekf.measurement}, "
           f"{h}x{w} T={T} V={v})")
    def run():
        fn = lambda: api.track_mesh(clip, cfg, n_vertices=v,  # noqa: E731
                                    device=dev)
        mesh, tr = drive(label, fn, per_frame_expected(cfg, h, w, T),
                         counts_by_path)
        check_tracks(tr, T, v)
        again = fn()[1]
        log(f"  {label} two card runs: hashes {tracks_hash(tr)} "
            f"{tracks_hash(again)}")
        assert tracks_hash(tr) == tracks_hash(again)
        t0 = time.perf_counter()
        mesh_c, tr_c = api.track_mesh(clip, cfg, n_vertices=v, device="cpu")
        log(f"  {label} on the CPU: {time.perf_counter() - t0:.2f} s")
        assert np.array_equal(mesh.vertices, mesh_c.vertices)
        assert np.array_equal(mesh.triangles, mesh_c.triangles)
        same_tracks(tr, tr_c, f"{label} card vs CPU")
        truth = mesh_truth(mesh, h, w, stretch)
        e_card, e_cpu = median_error(tr, truth), median_error(tr_c, truth)
        log(f"  {label} median vertex error at frame {T - 1} against the "
            f"clip's truth: card {e_card:.4f} px, CPU {e_cpu:.4f} px (bar: "
            f"the CPU's + {TRUTH_SLACK})")
        assert e_card <= e_cpu + TRUTH_SLACK
        gray0 = grayscale_u8(torch.from_numpy(clip[0]).to(dev))
        tmpl = make_template(gray0, mesh, device=dev)
        P = int(tmpl.tvals.shape[0])
        run_cfg = cfg.replace(tracks=dataclasses.replace(
            cfg.tracks, num_tracks=v))
        track = lambda: pipeline.track_clip(  # noqa: E731
            clip, run_cfg, mesh.vertices, False, tmpl, device=dev)
        assert identical(track(), tr)
        what = f"{h}x{w}, T={T}, V={v}, P={P}; {name}"
        api_s = per_frame_fps(f"{label} (api.track_mesh)", fn, T - 1, what)
        trk_s = per_frame_fps(f"{label} (track_clip, template given)",
                              track, T - 1, what)
        trace = (None if not profile else str(Path(profile).with_name(
            f"{Path(profile).stem}_{label}{Path(profile).suffix}")))
        profile_path(label, fn, T - 1, trace, api_s)
        profile_path(f"{label} tracking", track, T - 1, None, trk_s)
        return mesh, tr, tmpl
    return run()


@phase(f"path R-bench (api.track_mesh, render, 1080p T={T} V={V_R}, the "
       "default deformation)")
def path_r_bench(dev, clip):
    """bench --render's clip at 1080p: the default deformation, which the
    render channel (the reference's algorithm, op for op; the reference
    itself loses the mesh there too) does not follow. Two card runs with
    equal hashes; the mesh identical to the CPU's; the card's positions
    within R_BENCH_BAR px of the CPU's, alive and track_id identical.
    Printed: the card's and the CPU's median errors against the truth."""
    from kalman_hydra_tpu_torch import api
    cfg = mesh_config("render")
    mesh, tr = api.track_mesh(clip, cfg, n_vertices=V_R, device=dev)
    again = api.track_mesh(clip, cfg, n_vertices=V_R, device=dev)[1]
    log(f"  R-bench two card runs: hashes {tracks_hash(tr)} "
        f"{tracks_hash(again)}")
    assert tracks_hash(tr) == tracks_hash(again)
    mesh_c, tr_c = api.track_mesh(clip, cfg, n_vertices=V_R, device="cpu")
    truth = mesh_truth(mesh, H, W, BODY["stretch"])
    errs = np.median(np.linalg.norm(tr.positions - truth, axis=-1), axis=1)
    gap = float(np.abs(tr.positions - tr_c.positions).max())
    same_ids = (np.array_equal(tr.alive, tr_c.alive)
                and np.array_equal(tr.track_id, tr_c.track_id))
    log(f"  R-bench mesh identical to the CPU's: "
        f"{np.array_equal(mesh.vertices, mesh_c.vertices)}; median vertex "
        f"error a frame on the card "
        f"{[round(float(e), 3) for e in errs]} px, at frame {T - 1} on the "
        f"CPU {median_error(tr_c, truth):.4f} px; card vs CPU max |pos "
        f"diff| {gap:.3e} px (bar {R_BENCH_BAR}), alive and track_id "
        f"identical {same_ids}; live {int(tr.alive[-1].sum())}/{V_R}")
    assert np.array_equal(mesh.vertices, mesh_c.vertices)
    assert np.array_equal(mesh.triangles, mesh_c.triangles)
    assert gap < R_BENCH_BAR and same_ids


@phase(f"path R-S (api.track_mesh(streaming=True), render, 1080p T={T} "
       f"V={V_R})")
def path_r_s(dev, clip, r_tracks, counts_by_path, name):
    """R streamed (frame 0 apart, frames 1.. one at a time): no kernel
    launch, and R's array run bit for bit (positions, alive, nis,
    track_id), as S is to A."""
    from kalman_hydra_tpu_torch import api
    cfg = mesh_config("render")
    fn = lambda: api.track_mesh(clip, cfg, n_vertices=V_R,  # noqa: E731
                                streaming=True, device=dev)
    _, tr = drive("R-S", fn, per_frame_expected(cfg, H, W, T),
                  counts_by_path)
    same = identical(tr, r_tracks)
    log(f"  R-S bit-identical to R's array run: {same} (hash "
        f"{tracks_hash(tr)})")
    assert same
    s = per_frame_fps("R-S (api.track_mesh, streaming)", fn, T - 1,
                      f"1080p, T={T}, V={V_R}; {name}")
    profile_path("R-S", fn, T - 1, None, s)


@phase("path R-mesh (models.mesh strain of R's trajectories on the card)")
def path_r_mesh(dev, mesh, tr):
    """mesh_strain_sequence and mesh_strain_sequence_dynamic (at the
    default threshold 1.5 and at 1.05, where it remeshes) over R's
    trajectories on the card against the CPU: the same remesh events;
    F, area_ratio and the dynamic run's shear and quality < 1e-5
    (relative, or absolute below 1); max_shear < 1e-5 on the triangles
    whose shear is below 10, and above it < SHEAR_ULPS * eps_f32 *
    shear^2: there the reference's formula loses digits (lam2^2 = (tr -
    disc) / 2 cancels; 0.35% at a shear of a few hundred, seen on the
    card)."""
    from kalman_hydra_tpu_torch.models import mesh as M

    def rel(x, y):
        return float((np.abs(x - y) / np.maximum(np.abs(y), 1.0)).max())
    a = M.mesh_strain_sequence(mesh, tr.positions, device=dev)
    b = M.mesh_strain_sequence(mesh, tr.positions, device="cpu")
    for k in a:
        i = np.unravel_index(np.argmax(np.abs(a[k] - b[k])), a[k].shape)
        log(f"  R-mesh {k}: max |card - CPU| {np.abs(a[k] - b[k]).max():.3e}"
            f" at {tuple(int(j) for j in i)} (card {a[k][i]:.6e}, CPU "
            f"{b[k][i]:.6e})")
    ok = b["max_shear"] < 10.0
    err = max(rel(a["F"], b["F"]), rel(a["area_ratio"], b["area_ratio"]),
              rel(a["max_shear"][ok], b["max_shear"][ok]))
    s_hi = b["max_shear"][~ok].astype(np.float64)
    d_hi = np.abs(a["max_shear"][~ok] - b["max_shear"][~ok]) / s_hi
    ulps = d_hi / (np.finfo(np.float32).eps * s_hi ** 2)
    worst = float(ulps.max()) if ulps.size else 0.0
    exx = float(np.median(a["F"][-1, :, 0, 0] - 1.0))
    sx = STRETCH_R[0] * np.sin(BODY["omega"] * (T - 1))
    log(f"  R-mesh strain card vs CPU: max relative diff {err:.3e} (bar "
        f"1e-5); max_shear of the {int((~ok).sum())} triangle-frames of "
        f"{ok.size} with a shear past 10: largest relative diff "
        f"{float(d_hi.max()) if d_hi.size else 0.0:.3e}, at most "
        f"{worst:.3e} x eps_f32 x shear^2 (bar {SHEAR_ULPS}); median e_xx "
        f"at frame {T - 1} {exx:+.4f} (clip's {sx:+.4f})")
    assert err < 1e-5 and worst < SHEAR_ULPS
    for thr in (1.5, 1.05):
        t0 = time.perf_counter()
        a = M.mesh_strain_sequence_dynamic(mesh, tr.positions,
                                           shear_threshold=thr, device=dev)
        card_s = time.perf_counter() - t0
        b = M.mesh_strain_sequence_dynamic(mesh, tr.positions,
                                           shear_threshold=thr, device="cpu")
        err = max(rel(a[k], b[k])
                  for k in ("max_shear_p95", "quality_min", "quality_mean"))
        log(f"  R-mesh dynamic (threshold {thr}): events card {a['events']} "
            f"CPU {b['events']}; max relative diff {err:.3e}; {card_s:.3f} s on "
            "the card")
        assert a["events"] == b["events"] and err < 1e-5


PORT_KERNELS = ("ekf_kernel", "flow_walk_kernel", "level_polyexp_kernel",
                "polyexp_tiled_kernel", "pairs_tile_kernel",
                "flow_iters_pipe_kernel", "lk_kernel", "pyr_levels_kernel",
                "scharr_levels_kernel")       # csrc's __global__ names


@phase("P14 trace (utils.profiling.trace around one warm A step)")
def check_p14_trace(dev, clip, cfg):
    """trace() around one warm frame step of A writes a Chrome trace that
    names the port's kernels."""
    from kalman_hydra_tpu_torch import pipeline
    from kalman_hydra_tpu_torch.utils import profiling
    d = stream_dir() / "p14_trace"
    shutil.rmtree(d, ignore_errors=True)
    carry = pipeline.init_from_frame(torch.from_numpy(clip[0]).to(dev), cfg)
    step = pipeline.make_step(cfg, dev)
    carry, _ = step(carry, torch.from_numpy(clip[1]).to(dev))
    frame = torch.from_numpy(clip[2]).to(dev)
    torch.cuda.synchronize()
    with profiling.trace(str(d)):
        step(carry, frame)
    files = list(d.iterdir())
    events = json.loads(files[0].read_text()).get("traceEvents", [])
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    ours = sorted({k for n in names for k in PORT_KERNELS
                   if re.search(rf"(^|[\s:]){k}([<(]|$)", n)})
    log(f"  trace of one warm A step: {files[0].name}, {len(events)} "
        f"events, {len(names)} distinct device kernels; the port's: {ours}")
    assert ours


@phase("P14 cost (utils.profiling.cost of a 1024² f32 matmul)")
def check_p14_cost(dev):
    """cost() of a 1024² f32 matmul on the card counts >= 2 * 1024³ *
    0.5 FLOPs and reports the card's peak allocation."""
    from kalman_hydra_tpu_torch.utils import profiling
    a = torch.randn(1024, 1024, device=dev)
    c = profiling.cost(torch.mm, a, a)
    log(f"  cost of a 1024² f32 matmul: {c}")
    assert c["cost"]["flops"] >= 2 * 1024 ** 3 * 0.5


@phase("P14 debug_checks (a small A run, 270x480 T=5)")
def check_p14_debug(dev):
    """debug_checks() on a small A run (A's config, 270x480, T=5)
    launches what the run launches without it and gives the same
    tracks; a NaN in frame 2 of its float copy raises FloatingPointError
    naming the stage and the frame, before any kernel sees it."""
    from kalman_hydra_tpu_torch import api, pipeline
    from kalman_hydra_tpu_torch.utils import debug
    small = blob_clip(5, 270, 480)
    small_cfg = pipeline.main_path_config(256)
    expect = per_frame_expected(small_cfg, 270, 480, 5)
    runs = {}
    for on in (False, True):
        ctx = debug.debug_checks() if on else contextlib.nullcontext()
        with ctx:
            runs[on] = drive(f"small A, debug_checks {'on' if on else 'off'}",
                             lambda: api.track_video(small, small_cfg,
                                                     device=dev),
                             expect, {})
    log(f"  small A launches a step: {sum(expect.values()) / 4:.2f} with "
        f"debug_checks off and on; tracks identical: "
        f"{identical(runs[False], runs[True])}")
    assert identical(runs[False], runs[True])
    bad = small.astype(np.float32)
    bad[2, 100, 200, 1] = np.nan
    try:
        with debug.debug_checks():
            api.track_video(bad, small_cfg, device=dev)
    except FloatingPointError as e:
        log(f"  NaN in frame 2: FloatingPointError: {e}")
        assert "frame 2" in str(e) and "grayscale" in str(e)
    else:
        raise AssertionError("debug_checks let a NaN frame through")


# ------------------------------------------------ parallel paths (P13)

N_BANDS = 4                                # K2-band: 1080p in 4 bands
BAND_WINSIZES = (15, 81, 101)              # 32 x 64 tile, 16 x 32, M in
#                                            device memory (tile_plan)
SF_SHARDS = (4, 8)                         # path SF's one-card meshes
# SF against its plain route, max EPE: 10x K2's 1e-4 a launch, for the
# coarse levels and 3 band iterations compounding (3.6e-4 px on an H100)
SF_PLAIN_MAX = 1e-3


def band_slabs(xs, n, rpad, h):
    """farneback_sharded's slab layout of (c, h, w) tensors: band i's rows
    i h / n - rpad ... (i + 1) h / n + rpad - 1, the rows past the image
    replicating its edge rows; each slab contiguous."""
    hb = h // n
    out = []
    for i in range(n):
        idx = torch.arange(i * hb - rpad, (i + 1) * hb + rpad,
                           device=xs[0].device).clamp(0, h - 1)
        out.append(tuple(x.index_select(1, idx) for x in xs))
    return out


@phase("K2-band flow_iter with row0 (K2's band mode, 1080p in 4 bands)")
def check_k2_band(dev, cfg, results):
    """K2's band mode on 1080x1920 planes cut into 4 bands in the
    reference's slab layout (band rows +- RPAD, RPAD = winsize // 2 +
    fast_warp + 1), at winsize 15, 81 and 101 (one per tile route), f32
    and bf16 planes, a Gaussian window at 15, a random +-10 px prior:
    (a) each band launch against its plain band version (< 1e-4, K2's
    bar), (b) each band's interior against the full-frame K2 launch's rows
    (< 1e-5; 0 expected: the same values at the same image pixels), (c)
    one launch a band a call. Timed (random +-3 px prior, bf16, winsize
    15) per call and on the device: one interior band, the 4 bands, and
    one full-frame K2, in turns."""
    from kalman_hydra_tpu_torch import kernels
    from kalman_hydra_tpu_torch.kernels.flow_iter import (
        flow_iter, flow_iter_plain, tile_plan)
    f = cfg.flow
    D = f.fast_warp
    hb = H // N_BANDS
    g = torch.Generator().manual_seed(5)
    R0 = torch.randn(5, H, W, generator=g).to(dev)
    R1 = torch.randn(5, H, W, generator=g).to(dev)
    fl = (torch.rand(2, H, W, generator=g) * 20 - 10).to(dev)
    worst_plain = worst_full = 0.0
    for ws in BAND_WINSIZES:
        rpad = ws // 2 + D + 1
        plan = tile_plan(hb + 2 * rpad, W, ws)
        for dt, gw in ((torch.float32, False), (torch.bfloat16, False)) + (
                ((torch.float32, True),) if ws == f.winsize else ()):
            a, b = R0.to(dt), R1.to(dt)
            full = flow_iter(a, b, fl, ws, D, gw)
            e_plain = e_full = 0.0
            for i, (sa, sb, sf) in enumerate(band_slabs((a, b, fl), N_BANDS,
                                                        rpad, H)):
                row0 = i * hb - rpad
                out = flow_iter(sa, sb, sf, ws, D, gw, row0, H)
                e_plain = max(e_plain, max_err(out, flow_iter_plain(
                    sa, sb, sf, ws, D, gw, row0, H)))
                e_full = max(e_full, max_err(out[:, rpad:rpad + hb],
                                             full[:, i * hb:(i + 1) * hb]))
            worst_plain = max(worst_plain, e_plain)
            worst_full = max(worst_full, e_full)
            log(f"  K2-band winsize {ws} (tile shape {plan.shape}: "
                f"{plan.th}x{plan.tw}), {str(dt)[6:]}{'/g' if gw else ''}: "
                f"vs plain {e_plain:.1e}, interior vs full-frame K2 "
                f"{e_full:.1e}")
    log(f"  K2-band max_abs_err vs plain {worst_plain:.3e} (bar 1e-4); "
        f"band interiors vs full-frame K2 {worst_full:.3e} (bar 1e-5)")
    assert worst_plain < 1e-4 and worst_full < 1e-5
    rpad = f.winsize // 2 + D + 1
    a, b = R0.to(torch.bfloat16), R1.to(torch.bfloat16)
    fl3 = (torch.rand(2, H, W, generator=g) * 6 - 3).to(dev)
    slabs = band_slabs((a, b, fl3), N_BANDS, rpad, H)

    def bands():
        return [flow_iter(*s, f.winsize, D, False, i * hb - rpad, H)
                for i, s in enumerate(slabs)]
    expect = dict.fromkeys(kernels.WRAPPERS, 0)
    expect["flow_iter_band"] = N_BANDS
    drive("K2-band (one call of the 4 bands)", bands, expect, {})
    one = slabs[1]
    ms = time_turns({
        "plain": lambda: flow_iter_plain(*one, f.winsize, D, False,
                                         hb - rpad, H),
        "kernel": lambda: flow_iter(*one, f.winsize, D, False, hb - rpad,
                                    H),
        "bands": bands,
        "full": lambda: flow_iter(a, b, fl3, f.winsize, D)})
    rows = hb + 2 * rpad
    log(f"  K2-band time ({rows}x{W} slab of a {H}x{W} image, bf16, "
        f"winsize {f.winsize}): one band {ms['kernel']:.4f} ms per call, "
        f"{ms['kernel dev']:.4f} on the device; the {N_BANDS} bands "
        f"{ms['bands']:.4f}, {ms['bands dev']:.4f}; full-frame K2 "
        f"{ms['full']:.4f}, {ms['full dev']:.4f}")
    taps = 2 * (f.winsize // 2) + 1
    record(results, "flow_iter_band", worst_plain, ms["kernel"],
           ms["plain"], rows * W * (10 * 2 + 8 + 8),
           rows * W * fi_flops(taps), dev=ms)
    results["flow_iter_band"].update(
        interior_vs_full=worst_full, bands_ms=ms["bands"],
        bands_device_ms=ms["bands dev"], full_ms=ms["full"],
        full_device_ms=ms["full dev"])


def sharded_flow_expected(f, h, w, n) -> dict:
    """Launches of one farneback_sharded call on an n-shard one-card
    mesh: the coarse levels of both frames once (K4 or K11 and K3 on each,
    and the coarse levels' flow: K5, K13 or K2, as per_frame_expected
    counts them for one frame pair); K3 on each shard's two slabs; and
    `iterations` band launches a shard (the fine level, which at this
    size never passes K5's gate)."""
    from kalman_hydra_tpu_torch.config import RunConfig
    from kalman_hydra_tpu_torch.kernels.flow_level import fits
    from kalman_hydra_tpu_torch.ops.pyramid import farneback_levels
    _k, lh, lw, _s, _ks = farneback_levels(h, w, f.levels,
                                           f.pyr_scale)[-1]
    assert not fits(lh, lw, 2 if f.bf16_poly else 4)
    e = per_frame_expected(RunConfig(flow=f), h, w, 2)
    e["ekf_fused_step"] = 0
    if f.fi_pipeline and f.iterations >= 2:
        e["flow_iters_pipelined"] -= 1
    else:
        e["flow_iter"] -= f.iterations
    e["poly_expansion_planar"] += 2 * (n - 1)
    e["flow_iter_band"] = n * f.iterations
    return e


@contextlib.contextmanager
def plain_sf_route():
    """farneback_sharded through the plain versions of its kernels on the
    card, patched into parallel.spatial (the coarse pyramids and levels,
    K3 on the slabs, K2's band mode): the plain route SF is held
    against."""
    from kalman_hydra_tpu_torch.kernels.flow_iter import flow_iter_plain
    from kalman_hydra_tpu_torch.kernels.polyexp import \
        poly_expansion_planar_plain
    from kalman_hydra_tpu_torch.parallel import spatial
    names = ("polyexp_pyramid", "farneback_from_pyramids",
             "poly_expansion_planar", "flow_iter")
    saved = [getattr(spatial, k) for k in names]
    spatial.polyexp_pyramid = lambda img, f, fine=True: tuple(
        plain_pyramid(img, f)[:None if fine else -1])
    spatial.farneback_from_pyramids = plain_levels
    spatial.poly_expansion_planar = lambda img, n, s, out_dtype: \
        poly_expansion_planar_plain(img, n, s, out_dtype)
    spatial.flow_iter = flow_iter_plain
    try:
        yield
    finally:
        for k, v in zip(names, saved):
            setattr(spatial, k, v)


def sharded_vs_flat(label, got, ref, inner, outer, core=None):
    """A sharded flow against the one-card flow: rows >= 8 px from the
    border below `inner`, every row below `outer`, and with `core` rows 48
    ... H - 49 below it (Farneback's band interiors are the full frame's
    rows: 0 expected; the image's top and bottom edges reach ~30 rows in
    3 iterations); maxima printed, with the row of the largest."""
    d = np.abs(got - ref)
    row = int(np.unravel_index(np.argmax(d), d.shape)[0])
    mid = d[48:-48].max()
    log(f"  {label} vs api.flow: rows >= 8 px from the border max "
        f"{d[8:-8, 8:-8].max():.3e} px (bar {inner}), all rows "
        f"{d.max():.3e} px (bar {outer}) at row {row}; rows 48 ... "
        f"{d.shape[0] - 49} {mid:.3e} px (bar {core})")
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert d[8:-8, 8:-8].max() < inner and d.max() < outer
    assert core is None or mid < core


def sf_pair():
    from kalman_hydra_tpu_torch.io.synthetic import translating_pair
    return translating_pair(height=H, width=W, shift=(3.0, -2.0), seed=0)


@phase("path SF (parallel.spatial.farneback_sharded, 1080p, meshes of 4 "
       "and 8 shards of the one card)")
def path_sf(dev, cfg, counts_by_path, name):
    """farneback_sharded on A's FlowConfig (5 levels, winsize 15,
    fast_warp 8, bf16 planes) over 1080x1920 translating_pair, on meshes
    of 4 and 8 shards of the one card, and at bf16_poly=False on 4:
    against api.flow on the same config (bf16: rows >= 8 px from the
    border < 0.05 px, all < 0.15; f32: 5e-3, 0.1; rows 48 ... 1031 <
    1e-5); against its plain route on the card (mean EPE < 1e-3 px, max
    < SF_PLAIN_MAX); the call's wall against
    api.flow's in turns (no claim: the same work on one card)."""
    from kalman_hydra_tpu_torch import api, kernels
    from kalman_hydra_tpu_torch.parallel import Mesh
    from kalman_hydra_tpu_torch.parallel.spatial import farneback_sharded
    a, b, truth = sf_pair()
    f = cfg.flow
    ref = api.flow(a, b, f, device=dev)
    got = {}
    for n in SF_SHARDS:
        mesh = Mesh([dev] * n, ("space",))
        got[n] = drive(f"SF-{n}", lambda: farneback_sharded(a, b, f, mesh),
                       sharded_flow_expected(f, H, W, n), counts_by_path)
        sharded_vs_flat(f"SF-{n} (bf16 planes)", got[n], ref, 0.05, 0.15,
                        1e-5)
    epe = np.linalg.norm(got[4] - truth, axis=-1)[16:-16, 16:-16].mean()
    log(f"  SF-4 mean EPE against the pair's true shift (16 px in): "
        f"{epe:.4f} px")
    f32 = dataclasses.replace(f, bf16_poly=False)
    mesh4 = Mesh([dev] * 4, ("space",))
    got32 = drive("SF-4 f32", lambda: farneback_sharded(a, b, f32, mesh4),
                  sharded_flow_expected(f32, H, W, 4), counts_by_path)
    sharded_vs_flat("SF-4 (f32 planes)", got32,
                    api.flow(a, b, f32, device=dev), 5e-3, 0.1, 1e-5)
    with plain_sf_route():
        kernels.reset_launches()
        plain = farneback_sharded(a, b, f, mesh4)
        assert not any(kernels.launch_counts().values())
    epe = np.linalg.norm(got[4] - plain, axis=-1)
    log(f"  SF-4 kernels vs the plain route on the card: mean EPE "
        f"{epe.mean():.3e} px (bar 1e-3), max {epe.max():.3e} px (bar "
        f"{SF_PLAIN_MAX})")
    assert epe.mean() < 1e-3 and epe.max() < SF_PLAIN_MAX
    ts = {"SF-4": [], "api.flow": []}
    fns = {"SF-4": lambda: farneback_sharded(a, b, f, mesh4),
           "api.flow": lambda: api.flow(a, b, f, device=dev)}
    for k in ("SF-4", "api.flow", "api.flow", "SF-4") * 2:
        ts[k] += clip_seconds(fns[k], 2)
    log("  wall per call in turns (medians of 8): " + ", ".join(
        f"{k} {statistics.median(v) * 1e3:.2f} ms" for k, v in ts.items())
        + f" ({name})")
    for k, fn in fns.items():
        profile_path(k, fn, 1, None, statistics.median(ts[k]))


@phase("path SL (parallel.spatial.lk_dense_sharded, 1080p, 2 shards)")
def path_sl(dev, counts_by_path):
    """lk_dense_sharded at the reference's LK defaults (levels 3) on a
    2-shard one-card mesh over 1080x1920 translating_pair (plain torch:
    no kernel, as the reference's is XLA): against api.flow at
    method="lk_dense" (K9, K10 and plain torch), rows >= 8 px from the
    border < 1e-3, all < 0.1."""
    from kalman_hydra_tpu_torch import api, kernels
    from kalman_hydra_tpu_torch.config import FlowConfig
    from kalman_hydra_tpu_torch.parallel import Mesh
    from kalman_hydra_tpu_torch.parallel.spatial import lk_dense_sharded
    a, b, _ = sf_pair()
    f = FlowConfig(method="lk_dense", levels=3)
    got = drive("SL", lambda: lk_dense_sharded(
        a, b, f, Mesh([dev] * 2, ("space",))),
        dict.fromkeys(kernels.WRAPPERS, 0), counts_by_path)
    sharded_vs_flat("SL", got, api.flow(a, b, f, device=dev), 1e-3, 0.1)


def dp_compare(label, trs, ref, bar):
    err = max(float(np.abs(a.positions - b.positions).max())
              for a, b in zip(trs, ref))
    same = all(np.array_equal(a.alive, b.alive)
               and np.array_equal(a.track_id, b.track_id)
               for a, b in zip(trs, ref))
    log(f"  {label} vs track_clips_batch: max |pos diff| {err:.3e} px (bar "
        f"{bar}); alive and track_id identical: {same}")
    assert len(trs) == len(ref) and err < bar and same


def dp_turns(label, fns, steps, name) -> dict:
    """frames/s of each function in turns (a, b, b, a, ...), medians of
    4 runs each; a record, not a claim. Returns the median seconds."""
    ts = {k: [] for k in fns}
    order = list(fns)
    for k in (order + order[::-1]) * 2:
        ts[k] += clip_seconds(fns[k], 1)
    log(f"  {label} frames/s in turns: " + ", ".join(
        f"{k} {steps / statistics.median(v):.2f}" for k, v in ts.items())
        + f" (medians of 4; {name})")
    return {k: statistics.median(v) for k, v in ts.items()}


@phase("path DP (parallel.track_clips_sharded, 4 x 1080p T=9 K=1024 on 4 "
       "shards of the one card, reduce_metrics)")
def path_dp(dev, clips_c, cfg, counts_by_path, name):
    """C's 4 clips at main_path_config() over a 4-shard one-card mesh with
    reduce_metrics, against track_clips_batch on the card (positions <
    1e-5 px, 0 expected; alive and track_id identical); the metrics
    against NumPy means of the returned trajectories (< 1e-6 relative);
    frames/s of both in turns."""
    from kalman_hydra_tpu_torch.parallel import (Mesh, track_clips_batch,
                                                 track_clips_sharded)
    mesh = Mesh([dev] * 4)
    e = {k: 4 * v for k, v in per_frame_expected(cfg, H, W, T).items()}
    trs, metrics = drive("DP", lambda: track_clips_sharded(
        clips_c, cfg, mesh, None, True), e, counts_by_path)
    ref = drive("DP batch", lambda: track_clips_batch(clips_c, cfg,
                                                      device=dev), e, {})
    for tr in trs:
        check_tracks(tr, T, K)
    dp_compare("DP", trs, ref, 1e-5)
    nis = np.stack([t.nis for t in trs]).astype(np.float64)
    alive = np.stack([t.alive for t in trs]).astype(np.float64)
    want = {"mean_nis": nis.mean(), "live_fraction": alive.mean(axis=(0, 2))}
    rel = {k: float(np.abs(metrics[k] - v).max() / np.abs(v).max())
           for k, v in want.items()}
    log(f"  DP metrics: mean_nis {float(metrics['mean_nis']):.6f}, "
        f"live_fraction {np.round(metrics['live_fraction'], 4).tolist()}; "
        f"relative diff vs NumPy means {rel} (bar 1e-6)")
    assert metrics["live_fraction"].shape == (T,)
    assert max(rel.values()) < 1e-6
    sharded = lambda: track_clips_sharded(clips_c, cfg, mesh)  # noqa: E731
    med = dp_turns("DP", {"sharded": sharded,
                          "batch": lambda: track_clips_batch(
                              clips_c, cfg, device=dev)},
                   N_CLIPS * (T - 1), name)
    profile_path("DP", sharded, N_CLIPS * (T - 1), None, med["sharded"])


@phase("path DP-C (parallel.track_clips_sharded, pair_path_config(), 2 "
       "shards of 2 clips)")
def path_dp_c(dev, clips_c, pair_cfg, counts_by_path):
    """C's 4 clips at pair_path_config() (each shard chains its 2 clips
    through shared launches: K7b, K7a, K6, then K1 a step) against
    track_clips_batch (all 4 chained), as DP."""
    from kalman_hydra_tpu_torch.parallel import (Mesh, track_clips_batch,
                                                 track_clips_sharded)
    e = {k: 2 * v for k, v in pair_expected(pair_cfg, H, W, 2, T).items()}
    trs = drive("DP-C", lambda: track_clips_sharded(
        clips_c, pair_cfg, Mesh([dev] * 2)), e, counts_by_path)
    ref = drive("DP-C batch", lambda: track_clips_batch(
        clips_c, pair_cfg, device=dev),
        pair_expected(pair_cfg, H, W, N_CLIPS, T), {})
    dp_compare("DP-C", trs, ref, 1e-5)


@phase("path DP-R (parallel.track_clips_sharded, render, R-480's clip and "
       "template, 4 clips on 4 shards)")
def path_dp_r(dev, counts_by_path):
    """R-480's clip (480x640, T=9) 4 times with its mesh (V=64) and one
    render template, copied to the card once, on 4 shards: against
    track_clips_batch (< 5e-4 px, alive identical; no kernel)."""
    from kalman_hydra_tpu_torch import pipeline
    from kalman_hydra_tpu_torch.models.mesh import mesh_from_mask
    from kalman_hydra_tpu_torch.models.render import make_template
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.segment import segment_body
    from kalman_hydra_tpu_torch.parallel import (Mesh, track_clips_batch,
                                                 track_clips_sharded)
    clip = body_clip(H_R480, W_R480)
    gray0 = grayscale_u8(pipeline.upload(clip[0], dev))
    mesh = mesh_from_mask(segment_body(gray0).cpu().numpy(),
                          n_points=V_R480, seed=0)
    tmpl = make_template(gray0, mesh, device="cpu")
    cfg = mesh_config("render")
    cfg = cfg.replace(tracks=dataclasses.replace(
        cfg.tracks, num_tracks=mesh.vertices.shape[0]))
    clips = np.stack([clip] * 4)
    trs = drive("DP-R", lambda: track_clips_sharded(
        clips, cfg, Mesh([dev] * 4), mesh.vertices, render_tmpl=tmpl),
        dict.fromkeys(per_frame_expected(cfg, H_R480, W_R480, T), 0),
        counts_by_path)
    ref = track_clips_batch(clips, cfg, mesh.vertices, tmpl, device=dev)
    dp_compare("DP-R", trs, ref, 5e-4)


@phase("path DP-D (api.track_videos(sharded=True), no config, the "
       "default mesh)")
def path_dp_d(dev, clips_c, counts_by_path):
    """Two of C's clips through api.track_videos(sharded=True) with no
    config (RunConfig(): K8, K3, K4, K1) on the default mesh (every
    card: one here) against sharded=False: bit for bit."""
    from kalman_hydra_tpu_torch import api
    from kalman_hydra_tpu_torch.config import RunConfig
    e = {k: 2 * v for k, v in per_frame_expected(RunConfig(), H, W,
                                                 T).items()}
    trs = drive("DP-D", lambda: api.track_videos(clips_c[:2], sharded=True,
                                                 device=dev),
                e, counts_by_path)
    ref = api.track_videos(clips_c[:2], device=dev)
    same = all(identical(a, b) for a, b in zip(trs, ref))
    log(f"  DP-D bit for bit track_videos(sharded=False): {same}")
    assert len(trs) == 2 and same


@phase("api.flow_sharded (Farneback, FlowConfig(fast_warp=8), the default "
       "mesh)")
def path_flow_sharded(dev, counts_by_path):
    """api.flow_sharded with its default config (f32 planes) on the
    default mesh (one shard here: the whole frame is one band) against
    api.flow: rows >= 8 px from the border < 5e-3, all < 0.1, rows 48
    ... 1031 < 1e-5."""
    from kalman_hydra_tpu_torch import api
    from kalman_hydra_tpu_torch.config import FlowConfig
    a, b, _ = sf_pair()
    f = FlowConfig(fast_warp=8)
    got = drive("api.flow_sharded", lambda: api.flow_sharded(
        a, b, device=dev), sharded_flow_expected(f, H, W, 1),
        counts_by_path)
    sharded_vs_flat("api.flow_sharded", got, api.flow(a, b, f, device=dev),
                    5e-3, 0.1, 1e-5)


_KERNELS = {   # wrapper: (CUDA source, TPU entry point it replaces, in
    #           kalman_hydra_tpu/kernels/ unless a path is given)
    "ekf_fused_step": ("ekf.cu", "ekf_pallas.py:171"),
    "flow_iter": ("flow_iter.cu", "flow_iter_pallas.py:802"),
    "poly_expansion_planar": ("polyexp.cu", "polyexp_pallas.py:140"),
    "coarse_polyexp_fused": ("level_image.cu", "level_image_pallas.py:195"),
    "flow_levels": ("flow_level.cu", "flow_level_pallas.py:226"),
    "flow_iter_pairs": ("flow_iter.cu", "flow_iter_pallas.py:530"),
    "poly_expansion_planar_batch": ("polyexp.cu", "polyexp_pallas.py:218"),
    "coarse_polyexp_fused_batch": ("level_image.cu",
                                   "level_image_pallas.py:246"),
    "flow_update": ("flow_update.cu", "flow_update_pallas.py:105"),
    "coarse_level_images": ("level_image.cu", "level_image_pallas.py:306"),
    "pyr_down_levels": ("pyramid.cu", "pyramid_pallas.py:76"),
    "scharr_gradients_levels": ("scharr.cu", "scharr_pallas.py:71"),
    "lk_sparse_levels": ("lk.cu", "lk_pallas.py:256"),
    "flow_iters_pipelined": ("flow_iters_pipe.cu",
                             "flow_iter_pallas.py:717"),
    # the port's own pair variant of K8: no Pallas kernel, it replaces the
    # reference's vmapped plain-XLA exact-warp pair update
    "flow_update_pairs": ("flow_update.cu",
                          "kalman_hydra_tpu/ops/farneback.py:633"),
    # K2's band mode (row0/img_h), the same CUDA kernel as K2
    "flow_iter_band": ("flow_iter.cu", "flow_iter_pallas.py:802"),
}


def path_configs(pipeline) -> dict:
    """The port's configurations of paths A-J (D is RunConfig() itself):
    D2 is RunConfig() at pe_fused=False; E bench's temporal warm-1 stage
    (bench.py:718-722); F bench cfg5 (bench.py:842-858, 4-state filter,
    levels 3, fast_warp 8, bf16, K=256, RTS, pair-batched); G bench
    cfg2's pixel-KF stage (bench.py:554-563, fast_warp 8, bf16,
    pair-batched); H bench --sparse (bench.py:656-662 with its config at
    :181-241: lk_sparse, 5 levels, lk_block_halo 8, corr_conv, 6-state,
    K=1024, corner_pool 1024, reinit_every 1); H0 the reference's
    lk_sparse defaults; J BASELINE config 1 (bench.py:781-793: lk_dense,
    fast_warp 8, 4-state, K=256, corner_pool 256, reinit_every 1); AP
    A with fi_pipeline (bench.py:88, KH_FI_PIPE=1); BX RunConfig() with
    pair_batch; I (and "I ukf") AP with the 6-state implicit-flow IEKF at
    iekf_iters 2 (the UKF); P RunConfig() with measurement="photometric",
    P2 with "flow_photometric", adaptive_q 0.3 and seed_in_body; W
    docs/WALKTHROUGH.md section 3 verbatim (lk_sparse, lk_block_halo 8,
    6-state, adaptive_q 0.3, position, fixed-lag 8, impl "pallas")."""
    from kalman_hydra_tpu_torch.config import (EkfConfig, FlowConfig,
                                               RunConfig, SmoothConfig,
                                               TrackConfig)
    cfg = pipeline.main_path_config(num_tracks=K)
    cfg_ap = cfg.replace(flow=dataclasses.replace(cfg.flow, fi_pipeline=True))
    iekf = EkfConfig(state_dim=6, measurement="implicit_flow", iekf_iters=2)
    return {
        "A": cfg,
        "B": pipeline.pair_path_config(num_tracks=K),
        "C": cfg.replace(pair_batch=True),
        "D": RunConfig(),
        "D2": RunConfig(flow=FlowConfig(pe_fused=False)),
        "E": cfg.replace(flow=dataclasses.replace(
            cfg.flow, iterations=1, temporal_init=True)),
        "F": RunConfig(flow=FlowConfig(levels=3, fast_warp=8,
                                       bf16_poly=True),
                       tracks=TrackConfig(num_tracks=256, reinit_every=1),
                       smooth=SmoothConfig(enabled=True), impl="pallas",
                       pair_batch=True),
        "G": RunConfig(flow=FlowConfig(fast_warp=8, bf16_poly=True),
                       impl="pallas", pair_batch=True),
        "H": RunConfig(flow=FlowConfig(method="lk_sparse", fast_warp=8,
                                       lk_block_halo=8,
                                       lk_solver="corr_conv"),
                       ekf=EkfConfig(state_dim=6),
                       tracks=TrackConfig(num_tracks=K, corner_pool=K,
                                          reinit_every=1),
                       impl="pallas"),
        "H0": RunConfig(flow=FlowConfig(method="lk_sparse")),
        "J": RunConfig(flow=FlowConfig(method="lk_dense", fast_warp=8),
                       ekf=EkfConfig(state_dim=4),
                       tracks=TrackConfig(num_tracks=256, corner_pool=256,
                                          reinit_every=1),
                       impl="pallas"),
        "AP": cfg_ap,
        "BX": RunConfig(pair_batch=True),
        "I": cfg_ap.replace(ekf=iekf),
        "I ukf": cfg_ap.replace(ekf=dataclasses.replace(
            iekf, filter_type="ukf")),
        "P": RunConfig(ekf=EkfConfig(measurement="photometric")),
        "P2": RunConfig(ekf=EkfConfig(measurement="flow_photometric",
                                      adaptive_q=0.3),
                        tracks=TrackConfig(seed_in_body=True)),
        "W": RunConfig(flow=FlowConfig(method="lk_sparse", lk_block_halo=8),
                       ekf=EkfConfig(state_dim=6, adaptive_q=0.3,
                                     measurement="position"),
                       smooth=SmoothConfig(enabled=True, lag=8),
                       impl="pallas"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="TRACE_JSON", default=None,
                    help="also profile one warm run of paths A-D, H, AP, "
                         "BX and S and write each Chrome trace beside this "
                         "name (_A ... _D, _H, _AP, _BX, _S; R and RF, "
                         "profiled in every run, add _R and _RF)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import kalman_hydra_tpu_torch as kht
    here = Path(__file__).resolve().parent
    if Path(kht.__file__).resolve().parents[1] != here:
        print(f"chip_smoke: the port must come from this checkout ({here}),"
              f" not {kht.__file__}", file=sys.stderr)
        return 2
    from kalman_hydra_tpu_torch import kernels, pipeline
    from kalman_hydra_tpu_torch.kernels import _build
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8

    t_start = time.perf_counter()
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

    cfgs = path_configs(pipeline)
    cfg, pair_cfg = cfgs["A"], cfgs["B"]
    t0 = time.perf_counter()
    clip = blob_clip(T, H, W)
    clip_b = blob_clip(T_B, H_B, W_B)
    clips_c = np.stack([blob_clip(T, H, W, seed=s) for s in range(N_CLIPS)])
    clip_f = blob_clip(T_F, H_F, W_F)
    clip_j = blob_clip(T_J, H_J, W_J)
    log(f"clips {clip.shape}, {clip_b.shape}, {clips_c.shape}, "
        f"{clip_f.shape}, {clip_j.shape} made in "
        f"{time.perf_counter() - t0:.1f} s")
    gray = grayscale_u8(torch.from_numpy(clip[0]).to(dev))

    results: dict = {}
    counts_by_path: dict = {}
    check_launches(dev, clip, clip_b, cfg, cfgs["H"])
    check_k1(dev, results)
    check_k3(dev, gray, cfg, results)
    check_k4(dev, gray, cfg, results)
    check_k7b_witness(dev)
    check_k2(dev, cfg, results)
    check_k2_witness(dev)
    check_k5(dev, clip, cfg, results)
    check_k5_witness(dev)
    check_k6(dev, clip_b, pair_cfg, results)
    check_k7(dev, clip_b, clips_c, cfg, results)
    check_k7a_witness(dev)
    check_k8(dev, clip, cfgs["D"], results)
    check_k8_witness(dev)
    check_k11(dev, gray, cfgs["D2"], results)
    check_k9(dev, gray, results)
    check_k10(dev, gray, results)
    check_k12(dev, clip, cfgs["H"], results)
    check_k12_witness(dev, clip, cfgs["H"])
    check_k13(dev, clip, cfgs["AP"], results)
    check_k8_pairs(dev, clip_b, cfgs["BX"], results)
    check_k11_witness(dev)
    check_k1_witness(dev)
    fault_f2(dev, clip, cfg)
    fault_f5(dev, clip, cfgs)
    fault_f4(dev, clip, cfg)
    fault_f3(dev, clip, cfg)
    check_golden(dev)
    check_oracle(dev, clip, cfg, name)
    path_a(dev, clip, cfg, counts_by_path)
    flow_vs_plain(dev, clip, {k: cfgs[k]
                              for k in ("A", "D", "D2", "E", "AP")})
    small_vs_cpu(dev, cfg, pair_cfg, cfgs)
    walls = {"A": throughput_a(dev, clip, cfg, name),
             "B": path_b(dev, clip_b, pair_cfg, counts_by_path, name),
             "C": path_c(dev, clips_c, cfgs["C"], counts_by_path, name),
             "D": path_d(dev, clip, counts_by_path, name),
             "D2": path_d2(dev, clip, cfgs["D2"], counts_by_path, name),
             "E": path_e(dev, clip, cfgs["E"], counts_by_path, name),
             "F": path_f(dev, clip_f, cfgs["F"], counts_by_path, name),
             "G": path_g(dev, clip_f, cfgs["G"], counts_by_path, name),
             "H": path_h(dev, clip, cfgs["H"], counts_by_path, name),
             "H0": path_h0(dev, clip, cfgs["H0"], counts_by_path, name),
             "J": path_j(dev, clip_j, cfgs["J"], counts_by_path, name),
             "AP": path_ap(dev, clip, cfgs["AP"], counts_by_path, name),
             "BX": path_bx(dev, clip_b, cfgs["BX"], counts_by_path, name),
             "I": path_i(dev, clip, {k: cfgs[k] for k in ("I", "I ukf")},
                         counts_by_path, name),
             "P": path_p(dev, clip, {k: cfgs[k] for k in ("P", "P2")},
                         counts_by_path, name),
             "W": path_w(dev, clip, cfgs["W"], counts_by_path, name),
             "Q": path_q(dev, clip, cfgs["AP"], counts_by_path, name)}
    npy = stream_dir() / "clip.npy"
    np.save(npy, clip)
    path_stream("S", "A", dev, npy, clip, cfg, counts_by_path)
    path_stream("S-D", "D", dev, npy, clip, None, counts_by_path)
    path_stream("S-H", "H", dev, npy, clip, cfgs["H"], counts_by_path)
    path_s_mem(dev, clip, cfg)
    path_s_ckpt(dev, clip, cfgs)
    path_s_f(dev, clip_f, cfgs["F"], counts_by_path)
    path_s_cli(dev, clip, cfg)
    check_decoders(clip)
    walls["S"] = path_s_fps(dev, npy, clip, cfg, name)
    clip_r = body_clip(H, W, STRETCH_R)
    r = mesh_path("R", dev, clip_r, STRETCH_R, mesh_config("render"), V_R,
                  counts_by_path, name, args.profile)
    mesh_path("R-480", dev, body_clip(H_R480, W_R480), BODY["stretch"],
              mesh_config("render"), V_R480, counts_by_path, name, None)
    mesh_path("RF", dev, clip_r, STRETCH_R,
              mesh_config("flow_render", cfg.flow), V_R, counts_by_path,
              name, args.profile)
    path_r_bench(dev, body_clip(H, W))
    if r is not None:
        path_r_s(dev, clip_r, r[1], counts_by_path, name)
        path_r_mesh(dev, r[0], r[1])
    else:
        FAILURES.append("paths R-S and R-mesh (R failed)")
    check_p14_trace(dev, clip, cfg)
    check_p14_cost(dev)
    check_p14_debug(dev)
    check_k2_band(dev, cfg, results)
    path_sf(dev, cfg, counts_by_path, name)
    path_sl(dev, counts_by_path)
    path_dp(dev, clips_c, cfg, counts_by_path, name)
    path_dp_c(dev, clips_c, pair_cfg, counts_by_path)
    path_dp_r(dev, counts_by_path)
    path_dp_d(dev, clips_c, counts_by_path)
    path_flow_sharded(dev, counts_by_path)
    if args.profile:
        from kalman_hydra_tpu_torch import api
        runs = {"A": (lambda: api.track_video(clip, cfg, device=dev), T - 1),
                "B": (lambda: api.track_video(clip_b, pair_cfg, device=dev),
                      T_B - 1),
                "C": (lambda: api.track_videos(clips_c, cfgs["C"],
                                               device=dev),
                      N_CLIPS * (T - 1)),
                "D": (lambda: api.track_video(clip, device=dev), T - 1),
                "H": (lambda: api.track_video(clip, cfgs["H"], device=dev),
                      T - 1),
                "AP": (lambda: api.track_video(clip, cfgs["AP"],
                                               device=dev), T - 1),
                "BX": (lambda: api.track_video(clip_b, cfgs["BX"],
                                               device=dev), T_B - 1),
                "S": (lambda: api.track_video(str(npy), cfg, streaming=True,
                                              device=dev), T - 1)}
        trace = Path(args.profile)
        for label, (fn, steps) in runs.items():
            profile_path(label, fn, steps, str(trace.with_name(
                f"{trace.stem}_{label}{trace.suffix}")), walls[label])
    shutil.rmtree(stream_dir())
    ref = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "kalman_hydra_tpu"))
    if ref:
        log(f"chip_smoke: the JAX side was imported: {ref[:5]}")
        FAILURES.append("imports only the port")

    rows = []
    for kname, (cu, tpu) in _KERNELS.items():
        r = results.get(kname, {})
        launches = sum(c.get(kname, 0) for c in counts_by_path.values())
        if kname in kernels.WRAPPERS and launches == 0:
            FAILURES.append(f"{kname} never launched on its path")
        rows.append({"name": kname, "route": "cuda",
                     "source": f"kalman_hydra_tpu_torch/csrc/{cu}",
                     "replaces": tpu if "/" in tpu
                     else f"kalman_hydra_tpu/kernels/{tpu}",
                     "launches": launches,
                     "max_abs_err": r.get("max_abs_err"),
                     "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"),
                     "bound_by": r.get("bound_by"),
                     "library_ms": r.get("library_ms"),
                     "device_ms": r.get("device_ms"),
                     "device_how": r.get("device_how"),
                     "library_device_ms": r.get("library_device_ms")})
    if set(_KERNELS) != set(kernels.WRAPPERS):
        FAILURES.append("the kernels line does not list every wrapper")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
        "build included")
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
