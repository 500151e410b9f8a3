"""Level counts past a launch's table: K4, K7b and K11 at more coarse
levels than one launch takes (the 16-level pyramid at pyr_scale 0.8, 15
coarse levels at 1080p), and the Lucas-Kanade pyramid at 10 levels (K9,
K10 and K12's walk, each chaining launches).

Each plan runs through its wrapper's CUDA branch on CPU tensors with the
library call stubbed (recorded, or standing in with the plain version),
as test_torch_walk.py's walk tests do; the Farneback setting runs end to
end against the JAX package (Pallas in interpret mode) on the CPU. The
kernels themselves run on the card, in chip_smoke.py's F2 and F5
phases."""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalman_hydra_tpu.config import FlowConfig
from kalman_hydra_tpu.io.synthetic import translating_pair
from kalman_hydra_tpu.ops import farneback as FB
from kalman_hydra_tpu_torch.config import FlowConfig as TFlowConfig
from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.kernels import level_image as li
from kalman_hydra_tpu_torch.kernels import lk as klk
from kalman_hydra_tpu_torch.kernels import scharr as ks
from kalman_hydra_tpu_torch.ops import farneback as TFB
from kalman_hydra_tpu_torch.ops import pyramid as tpyr


def _record(monkeypatch, levels_arg: int, dims_arg: int):
    """Stub the library: every C call returns 0 and is recorded with its
    level count and its (levels, 12) dims table, read during the call."""
    calls = []

    def function(fname, *argtypes):
        def fn(*args):
            nl = args[levels_arg]
            dims = np.ctypeslib.as_array((ctypes.c_int * (12 * nl))
                                         .from_address(args[dims_arg]))
            calls.append((fname, args, dims.reshape(nl, 12).copy()))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    return calls


def _check_runs(calls, plan, runs):
    """One call a run of at most MAX_LEVELS levels, in plan order, each
    run's block0 from 0 and its blocks the run's own."""
    assert [len(d) for _, _, d in calls] == runs
    assert all(n <= li.MAX_LEVELS for n in runs)
    i = 0
    for _, _, dims in calls:
        block0 = 0
        for row in dims:
            lv = plan.levels[i]
            assert list(row) == [lv.lh, lv.lw, lv.ho, lv.wo, lv.tv, lv.th,
                                 lv.tile_h, lv.tile_w, lv.tiles_x, block0,
                                 lv.group, lv.split]
            assert block0 % plan.cluster == 0
            block0 += lv.blocks
            i += 1
    assert i == len(plan.levels)


@pytest.mark.parametrize("levels,pyr_scale,runs", (
    (16, 0.8, [12, 3]), (5, 0.5, [5])))
@pytest.mark.parametrize("frames", (1, 2))
def test_k4_k7b_launch_each_run_of_levels(monkeypatch, levels, pyr_scale,
                                          runs, frames):
    """K4 (one frame) and K7b (two): 15 coarse levels at 1080p and
    pyr_scale 0.8 make two launches, 12 levels and 3; the main path's 5
    one; each launch's table and blocks are its run's, and the wrapper
    counts every launch."""
    calls = _record(monkeypatch, 4, 6)
    imgs = torch.zeros(frames, 1080, 1920)
    outs, launches = li._launch(imgs, levels, pyr_scale, 5, 1.1,
                                torch.bfloat16)
    plan = li.fused_plan(1080, 1920, levels, pyr_scale, 5, frames)
    assert launches == len(runs) == len(calls)
    _check_runs(calls, plan, runs)
    for (_, args, dims), run_blocks in zip(calls, [
            sum(lv.blocks for lv in plan.levels[i:i + li.MAX_LEVELS])
            for i in range(0, len(plan.levels), li.MAX_LEVELS)]):
        assert args[11] == run_blocks and args[1] == frames
    assert [o.shape for o in outs] == [(frames, 5, lv.lh, lv.lw)
                                       for lv in plan.levels]


@pytest.mark.parametrize("levels,pyr_scale,runs", (
    (16, 0.8, [12, 3]), (5, 0.5, [5])))
def test_k11_launches_each_run_of_levels(monkeypatch, levels, pyr_scale,
                                         runs):
    """K11: one launch for every coarse level of a frame (the 5 of 1080p
    at 5 levels), two for 15; its plan is the fused plan at n = 0 (no
    padding, no polyexp) and each launch takes the plan's blocks."""
    calls = _record(monkeypatch, 3, 5)
    outs, launches = li._launch_images(torch.zeros(1080, 1920), levels,
                                       pyr_scale)
    plan = li.fused_plan(1080, 1920, levels, pyr_scale, 0, 1,
                         li.IMG_SPLIT_MAX)
    assert launches == len(runs)
    _check_runs(calls, plan, runs)
    for lv, out in zip(plan.levels, outs):
        assert (lv.ho, lv.wo) == (lv.lh, lv.lw) and out.shape == (lv.lh,
                                                                  lv.lw)
    for _, args, _ in calls:
        assert args[7:9] == (plan.cluster, plan.smem)


def test_farneback_at_16_levels_and_pyr_scale_0_8_matches_reference():
    """The F2 setting end to end: Farneback at levels 16, pyr_scale 0.8,
    fast_warp 8, one iteration a level (the plan's min_size clamp keeps 5
    levels at 96x96) against the reference's impl="pallas" in interpret
    mode: < 1e-3 px."""
    a, b, _ = translating_pair(height=96, width=96, shift=(2.0, -1.5),
                               seed=0)
    kw = dict(levels=16, pyr_scale=0.8, fast_warp=8, iterations=1)
    ref = np.asarray(FB.farneback(jnp.asarray(a), jnp.asarray(b),
                                  FlowConfig(**kw), impl="pallas",
                                  interpret=True))
    got = TFB.farneback(torch.from_numpy(a).float(),
                        torch.from_numpy(b).float(), TFlowConfig(**kw))
    assert len(tpyr.farneback_levels(96, 96, 16, 0.8)) == 5
    assert np.abs(got.numpy() - ref).max() < 1e-3


def _lk_pyramid(rng, levels):
    a = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    b = np.roll(a, (1, 2), (0, 1))
    pa = tpyr.build_pyramid(torch.from_numpy(a), levels)
    pb = tpyr.build_pyramid(torch.from_numpy(b), levels)
    grads = tuple(ks.scharr_gradients_plain(x) for x in pa)
    return pa, pb, grads


@pytest.mark.parametrize("levels,runs", ((10, [2, 8]), (8, [8]),
                                         (17, [1, 8, 8])))
def test_lk_walks_cover_the_levels_coarsest_first(monkeypatch, rng, levels,
                                                  runs):
    """K12 past 8 levels: one walk for each 8 levels, coarsest first, the
    finest level's answer x2 handed on; with each walk run by its plain
    version, the route equals the level loop over every level bit for
    bit, points and status, and counts one launch a walk."""
    pa, pb, grads = _lk_pyramid(rng, levels)
    pts = torch.from_numpy(rng.uniform(5, 90, (24, 2)).astype(np.float32))
    seen = []

    def walk(a, b, g, p, *rest):
        seen.append(len(a))
        assert len(a) <= klk.MAX_LEVELS
        return klk.lk_sparse_levels_plain(a, b, g, p, *rest)
    monkeypatch.setattr(klk, "_launch_walk", walk)
    klk.lk_sparse_levels.launches = 0
    args = (21, 10, 0.01, 1e-4, 8)
    got, st = klk._walks(pa, pb, grads, pts, *args, None)
    ref, rst = klk.lk_sparse_levels_plain(pa, pb, grads, pts, *args)
    assert seen == runs and klk.lk_sparse_levels.launches == len(runs)
    assert torch.equal(got, ref) and torch.equal(st, rst)


def test_scharr_launches_each_8_levels(monkeypatch, rng):
    """K10 over a 10-level LK pyramid: two launches, 8 levels and 2, the
    gradients of every level in order."""
    pa, _, grads = _lk_pyramid(rng, 10)
    seen = []

    def launch(pyr):
        seen.append(len(pyr))
        assert len(pyr) <= ks.MAX_LEVELS
        return tuple(ks.scharr_gradients_plain(x) for x in pyr)
    monkeypatch.setattr(ks, "_launch", launch)
    got = ks._launches(pa)
    assert seen == [8, 2] and len(got) == 10
    for (gx, gy), (rx, ry) in zip(got, grads):
        assert torch.equal(gx, rx) and torch.equal(gy, ry)
