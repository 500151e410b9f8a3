"""Farneback windows past 61 taps: the routes tile_plan gives them (a
smaller tile at winsize 63 and 81, M in device memory from 101), planned
through the wrappers' CUDA branches on CPU tensors with the library call
recorded (K2/K6, K13, K5's walk; K8's in test_torch_fused_iter.py), K13
at a window no tile holds running K2's route, and the fast-warp setting
end to end against the JAX package (Pallas in interpret mode) at small
size. test_torch_fault_window_exact.py holds the exact-warp settings and
K2 and K8 alone. The kernels themselves run on the card, in
chip_smoke.py's F3 phase."""

from __future__ import annotations

import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalman_hydra_tpu.config import FlowConfig
from kalman_hydra_tpu.io.synthetic import translating_pair
from kalman_hydra_tpu.ops import farneback as FB
from kalman_hydra_tpu_torch.config import FlowConfig as TFlowConfig
from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.ops import farneback as TFB

fi = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_iter")
fu = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_update")
kfl = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_level")

WIDE = (63, 81, 101)


def _record_calls(monkeypatch):
    calls = []

    def function(fname, *argtypes):
        def fn(*args):
            calls.append((fname, argtypes, args))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(fi, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(kfl, "_sm_count", lambda dev: 132)
    return calls


def _taps_at(ptr, taps):
    return np.ctypeslib.as_array((ctypes.c_float * taps).from_address(ptr))


@pytest.mark.parametrize("winsize", WIDE)
def test_k2_and_k6_plan_a_wide_window(monkeypatch, winsize):
    """K2/K6's launch at a wide window: the plan's tile (shape) and its
    shared memory, the taps in host and device memory, and the M and Mv
    scratch ((2, pairs, 5, h, w)) only where no tile holds M."""
    calls = _record_calls(monkeypatch)
    h, w = 37, 53
    R = torch.zeros(4, 5, h, w)
    fi._launch(R, R[1], torch.zeros(3, 2, h, w), 0, winsize, 8, False, 0, h)
    (fname, _, args), = calls
    plan = fi.tile_plan(h, w, winsize)
    (_, _, _, pairs, _, _, hh, ww, D, row0, img_h, wts, dwts, taps, post,
     shape, smem, scratch, _, _) = args
    assert fname == "kh_flow_iter" and (pairs, hh, ww, D) == (3, h, w, 8)
    assert (row0, img_h) == (0, h)
    assert (shape, smem, taps) == (plan.shape, plan.smem, plan.taps)
    want, wpost = fi.window_weights(winsize, False)
    assert post == wpost
    assert np.array_equal(_taps_at(wts, taps), want)
    assert np.array_equal(_taps_at(dwts, taps), want)
    assert (scratch is None) == (plan.shape != fi.MEM)
    assert plan.shape == {63: 1, 81: 2, 101: fi.MEM}[winsize]


@pytest.mark.parametrize("winsize", (15, 63, 81))
def test_k13_plans_a_wide_window(monkeypatch, winsize):
    """K13 on a smaller tile: the plan's tile and shared memory, and a
    skew of at least the bands a tile's flow reaches (db = cdiv(bw, th):
    2 at winsize 63 and 3 at 81 on 16-row tiles), so that every wait is
    on a smaller ticket (pipe_items, pipe_waits)."""
    calls = _record_calls(monkeypatch)
    h, w = 150, 200
    R = torch.zeros(5, h, w)
    fi._launch_pipe(R, R, torch.zeros(2, h, w), winsize, 8, 3, False)
    (fname, _, args), = calls
    plan = fi.tile_plan(h, w, winsize)
    skew, shape, smem = args[12], args[13], args[14]
    assert fname == "kh_flow_iters_pipe"
    assert (shape, smem) == (plan.shape, plan.smem)
    db = fi.pipe_db(plan)
    assert db == {15: 1, 63: 2, 81: 3}[winsize]
    assert skew >= min(db, plan.rows)
    items = fi.pipe_items(3, plan.rows, plan.cols, skew)
    ticket = {it: q for q, it in enumerate(items)}
    dt = fi.pipe_dt(plan, 8)
    for (j, b, t), q in ticket.items():
        for it in fi.pipe_waits(j, b, t, plan.rows, plan.cols, dt, db):
            assert ticket[it] < q


def test_k13_runs_k2s_route_where_no_tile_holds_the_window(monkeypatch):
    """At winsize 101 no tile holds M: K13's route is n_iters iterations
    with M in device memory (K2's full-frame launch, row0 = 0 and img_h =
    h, each from the last one's flow); at 81 it is one K13 launch."""
    calls = _record_calls(monkeypatch)
    h, w = 37, 53
    R = torch.zeros(5, h, w)
    flows = [torch.full((1, 2, h, w), float(i)) for i in range(1, 4)]
    seen = []

    def k2(R0, R1, flow_b, ppc, winsize, max_disp, gaussian, row0, img_h):
        seen.append((float(flow_b[0, 0, 0, 0]), winsize, max_disp, row0,
                     img_h))
        return flows[len(seen) - 1]
    monkeypatch.setattr(fi, "_launch", k2)
    out = fi._pipe_route(R, R, torch.zeros(2, h, w), 101, 8, 3, False)
    assert seen == [(0.0, 101, 8, 0, h), (1.0, 101, 8, 0, h),
                    (2.0, 101, 8, 0, h)]
    assert torch.equal(out, flows[2][0]) and not calls
    fi._pipe_route(R, R, torch.zeros(2, h, w), 81, 8, 3, False)
    assert [c[0] for c in calls] == ["kh_flow_iters_pipe"]
    assert len(seen) == 3


@pytest.mark.parametrize("winsize", (15, 63, 81, 99, 101))
def test_walk_takes_the_largest_tile_that_holds_the_window(monkeypatch,
                                                           winsize):
    """K5's walk: up to winsize 81 the 16 x 32 tile's shared memory as
    before; at 99 only 8 x 8 tiles hold M, and the launch plans them
    alone; from 101 no walk tile does (walk_fits), and ops.farneback
    sends those levels to K2's route."""
    if not kfl.walk_fits(winsize):
        assert winsize >= 101
        with pytest.raises(ValueError):
            kfl.walk_plan([(34, 60)], winsize, 8, 3)
        return
    calls = _record_calls(monkeypatch)
    shapes = [(34, 60), (68, 120), (135, 240)]
    R = [torch.zeros(5, h, w) for h, w in shapes]
    kfl._launch(R, R, torch.zeros(2, *shapes[0]), winsize, 8, 3, False, 0.5)
    (fname, _, args), = calls
    smem, dwts, taps = args[12], args[7], args[8]
    plan = kfl.walk_plan(shapes, winsize, 8, 3)
    first = min(L.shape for L in plan)
    assert smem == kfl.walk_smem(winsize) >= max(
        fi.tile_smem(*kfl.WALK_TILES[L.shape], taps) for L in plan)
    assert smem + fi.STATIC_SMEM <= fi.SMEM_LIMIT
    assert (dwts is None) == (taps <= fi.MAX_TAPS)
    if winsize == 99:
        assert first == 2 and all(L.shape == 2 for L in plan)


def _pair():
    a, b, _ = translating_pair(height=96, width=128, shift=(2.0, -1.5),
                               seed=0)
    return a, b


@pytest.mark.parametrize("winsize", WIDE)
def test_wide_window_fast_warp_flow_matches_reference(winsize):
    """The F3 setting at fast_warp 8 end to end (2 levels, the whole-level
    kernel's gate included) against the reference's impl="pallas" in
    interpret mode: < 1e-3 px."""
    a, b = _pair()
    kw = dict(levels=2, winsize=winsize, fast_warp=8)
    ref = np.asarray(FB.farneback(jnp.asarray(a), jnp.asarray(b),
                                  FlowConfig(**kw), impl="pallas",
                                  interpret=True))
    got = TFB.farneback(torch.from_numpy(a).float(),
                        torch.from_numpy(b).float(), TFlowConfig(**kw))
    assert np.abs(got.numpy() - ref).max() < 1e-3
