"""The fused Farneback iteration of K2, K6, K8, K8-pairs and K13
(csrc/flow_tile.cuh): the wrappers' tile and shared-memory plan, their C
calls, K13's work order and wait set, and a NumPy model of K8's exact
gather (csrc/flow_iter.cuh::exact_warp) against its plain version.

The CUDA kernels run only on the card, where chip_smoke.py holds them to
their plain versions and to the routes they replaced bit for bit; these
tests pin, on the CPU, the Python side the wrappers pass to the kernels."""

import ctypes
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.kernels.flow_iter import (
    MAX_TAPS, MEM, SMEM_LIMIT, STATIC_SMEM, TILE, TILES, pipe_dt, pipe_items,
    pipe_skew, pipe_waits, tile_plan, tile_smem)

# the modules (the package's `flow_iter` and `flow_update` are the
# wrapper functions)
fi = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_iter")
fu = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_update")
CSRC = Path(fi.__file__).resolve().parent.parent / "csrc"

SHAPES = ((1, 5), (20, 30), (37, 53), (1079, 1919))


def _smem(winsize):
    th, tw = TILE
    bw = winsize // 2
    return 4 * 5 * (th + 2 * bw) * ((tw + 2 * bw) | 1)


@pytest.mark.parametrize("winsize", (5, 15, 31))
@pytest.mark.parametrize("h,w", SHAPES)
def test_tile_plan_counts_and_shared_memory(h, w, winsize):
    plan = tile_plan(h, w, winsize)
    th, tw = TILE
    bw = winsize // 2
    assert (plan.th, plan.tw, plan.taps) == (th, tw, 2 * bw + 1)
    assert plan.rows == -(-h // th) and plan.cols == -(-w // tw)
    assert (plan.rows - 1) * th < h <= plan.rows * th
    assert (plan.cols - 1) * tw < w <= plan.cols * tw
    stride = (tw + 2 * bw) | 1
    assert stride % 2 == 1 and stride >= tw + 2 * bw
    assert plan.smem == _smem(winsize)
    assert plan.smem + STATIC_SMEM <= SMEM_LIMIT == 232_448
    # the flow's staging (2 planes of th x (tw + 1)) fits in M's buffer
    assert 4 * 2 * th * (tw + 1) <= plan.smem
    # K13 reads bands b - 1 ... b + 1 only
    assert plan.th >= bw


# the tile each window past MAX_TAPS takes ((0, 0): M in device memory)
WIDE_TILES = {62: (16, 64), 63: (16, 64), 65: (16, 64), 81: (16, 32),
              101: (0, 0), 121: (0, 0), 201: (0, 0), 1001: (0, 0),
              2001: (0, 0)}


@pytest.mark.parametrize("winsize", (1, 3, 5, 15, 31, 43, 59, 61, 62, 63,
                                     65, 101, 121, 201, 1001, 2001))
def test_tile_plan_raises_for_a_window_that_does_not_fit(winsize):
    """No window raises any more: every one plans a route. Up to
    MAX_TAPS taps the 32 x 64 tile with its old shared memory (so the old
    bytes); past it the first of TILES whose M fits one block, no larger
    one fitting; where none fits (winsize >= 101), M in device memory."""
    taps = 2 * (winsize // 2) + 1
    plan = tile_plan(37, 53, winsize)
    assert plan.taps == taps
    fit = [tile_smem(th, tw, taps) + STATIC_SMEM <= SMEM_LIMIT
           for th, tw in TILES]
    if taps <= MAX_TAPS:
        assert (plan.shape, plan.th, plan.tw) == (0, *TILE)
        assert plan.smem == _smem(taps) and fit[0]
    elif plan.shape == MEM:
        assert not any(fit) and WIDE_TILES[winsize] == (0, 0)
        assert (plan.th, plan.tw, plan.rows, plan.cols, plan.smem) == \
            (0, 0, 0, 0, 0)
    else:
        assert (plan.th, plan.tw) == TILES[plan.shape] == WIDE_TILES[winsize]
        assert plan.shape > 0 and fit[plan.shape]
        assert not any(fit[:plan.shape])
        assert plan.smem == tile_smem(plan.th, plan.tw, taps)
        assert plan.rows == -(-37 // plan.th) and \
            plan.cols == -(-53 // plan.tw)


@pytest.mark.parametrize("h,w", ((0, 5), (5, 0), (0, 0), (-1, 4),
                                 (3, -2)))
def test_tile_plan_refuses_an_empty_level(h, w):
    with pytest.raises(ValueError, match="empty"):
        tile_plan(h, w, 15)


def test_tile_plan_fits_every_window_the_kernels_take():
    for winsize in range(1, MAX_TAPS + 1):
        assert tile_plan(1080, 1920, winsize).smem == _smem(winsize)


def _cuh_int(name):
    src = (CSRC / "flow_tile.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _c_select(expr, s):
    """The value of a chain of C selects `s <op> k ? v : ...` at s."""
    while "?" in expr:
        cond, val, expr = re.match(r"(.+?) \? (\d+) : (.+)", expr).groups()
        lhs, op, k = cond.split()
        if {"==": s == int(k), "<=": s <= int(k), "<": s < int(k)}[op]:
            return int(val)
    return int(expr)


def test_the_plan_uses_the_tile_the_kernels_build():
    """TILE and MAX_TAPS are flow_tile.cuh's kTileH, kTileW and kMaxTaps,
    TILES its kShapes tiles (tile_h_of, tile_w_of), and the flow's
    staging (2 planes of th x (tw + 1)) fits in M's buffer at the smallest
    window."""
    assert TILE == (_cuh_int("kTileH"), _cuh_int("kTileW")) == TILES[0]
    assert MAX_TAPS == _cuh_int("kMaxTaps")
    assert len(TILES) == _cuh_int("kShapes")
    src = (CSRC / "flow_tile.cuh").read_text()
    for fn, col in (("tile_h_of", 0), ("tile_w_of", 1)):
        body = re.search(rf"int {fn}\(int s\) \{{\s*return ([^;]+);",
                         src).group(1)
        for s_, t in enumerate(TILES):
            assert _c_select(" ".join(body.split()), s_) == t[col]
    for th, tw in TILES:
        assert 4 * 2 * th * (tw + 1) <= tile_smem(th, tw, 1)
    assert 4 * 2 * TILE[0] * (TILE[1] + 1) <= tile_plan(1, 1, 1).smem


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float}


def _c_signature(source, name):
    """Argument types of `KH_API int name(...)` in csrc/<source>."""
    src = (CSRC / source).read_text()
    args = re.search(rf"KH_API int {name}\(([^)]*)\)", src).group(1)
    return [_C_TYPES[re.sub(r"\s+\w+$", "", a.strip())]
            for a in args.split(",")]


@pytest.mark.parametrize("name,source", [
    ("kh_flow_iter", "flow_iter.cu"),
    ("kh_flow_iters_pipe", "flow_iters_pipe.cu")])
def test_the_wrappers_call_the_c_interface_as_declared(monkeypatch, name,
                                                       source):
    """The argument types each wrapper declares and the values it passes
    match the C signature, and the shared memory it passes is its plan's:
    the launch runs on CPU tensors with the library call recorded."""
    calls = []

    def function(fname, *argtypes):
        def fn(*args):
            calls.append((fname, argtypes, args))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(fi, "_sm_count", lambda dev: 132)
    h, w = 37, 53
    R = torch.zeros(5, h, w)
    fl = torch.zeros(2, h, w)
    if name == "kh_flow_iter":
        fi._launch(R, R, fl[None], 0, 15, 8, False, 0, h)
    else:
        fi._launch_pipe(R, R, fl, 15, 8, 3, False)
    (fname, argtypes, args), = calls
    assert fname == name
    assert list(argtypes) == _c_signature(source, name)
    assert len(args) == len(argtypes)
    assert tile_plan(h, w, 15).smem in args


def _record_calls(monkeypatch):
    """Replace the library with a recorder: each C call returns 0 and
    lands in the returned list as (name, argtypes, args)."""
    calls = []

    def function(fname, *argtypes):
        def fn(*args):
            calls.append((fname, argtypes, args))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    return calls


@pytest.mark.parametrize("gaussian", (False, True))
@pytest.mark.parametrize("winsize", (5, 15, 31, 63, 101))
@pytest.mark.parametrize("name", ("kh_flow_update", "kh_flow_update_pairs"))
def test_k8_wrappers_call_the_c_interface_as_declared(monkeypatch, name,
                                                      winsize, gaussian):
    """K8's and K8-pairs' launchers, run on CPU tensors with the library
    call recorded, declare the argument types of csrc/flow_update.cu's
    signature, pass the planes unwarped, their plan's tile and shared
    memory, and K8's own taps (update_weights) in host memory; past 61
    taps also in device memory, and from winsize 101 (M in device memory)
    the M and Mv scratch, which a tile plan does without."""
    calls = _record_calls(monkeypatch)
    h, w = 37, 53
    if name == "kh_flow_update":
        R0 = torch.zeros(5, h, w, dtype=torch.bfloat16)
        fu._launch(R0, R0.clone(), torch.zeros(2, h, w), winsize, gaussian)
    else:
        Rall = torch.zeros(6, 5, h, w)
        fu._launch_pairs(Rall, torch.zeros(4, 2, h, w), winsize, gaussian,
                         3, True)
    (fname, argtypes, args), = calls
    assert fname == name
    assert list(argtypes) == _c_signature("flow_update.cu", name)
    assert len(args) == len(argtypes)
    plan = tile_plan(h, w, winsize)
    wts = fu.update_weights(winsize, gaussian)
    if name == "kh_flow_update":
        (_, _, bf16, _, hh, ww, ptr, dptr, taps, shape, smem, scratch, _,
         _) = args
        assert bf16 == 1
    else:
        (_, bf16, pairs, ppc, _, hh, ww, ptr, dptr, taps, round_m, shape,
         smem, scratch, _, _) = args
        assert (bf16, pairs, ppc, round_m) == (0, 4, 2, 1)
    assert (hh, ww, shape, smem) == (h, w, plan.shape, plan.smem)
    assert taps == plan.taps == len(wts) == 2 * (winsize // 2) + 1
    got = np.ctypeslib.as_array((ctypes.c_float * taps).from_address(ptr))
    assert np.array_equal(got, wts)
    assert (dptr is None) == (taps <= MAX_TAPS)
    if dptr is not None:
        got = np.ctypeslib.as_array((ctypes.c_float * taps).from_address(
            dptr))
        assert np.array_equal(got, wts)
    assert (scratch is None) == (plan.shape != MEM)


def _exact_warp_np(R1, dx, dy):
    """csrc/flow_iter.cuh::exact_warp statement for statement, in NumPy
    float32 over every pixel at once: each op rounds on its own, as the
    kernel's __f*_rn intrinsics do, and the sum runs left to right."""
    f32 = np.float32
    _, h, w = R1.shape
    r = np.arange(h, dtype=np.int32)[:, None]
    c = np.arange(w, dtype=np.int32)[None, :]
    fx = np.minimum(np.maximum(c.astype(f32) + dx, f32(0)), f32(w - 1))
    fy = np.minimum(np.maximum(r.astype(f32) + dy, f32(0)), f32(h - 1))
    x0 = np.clip(np.floor(fx).astype(np.int32), 0, w - 2)
    y0 = np.clip(np.floor(fy).astype(np.int32), 0, h - 2)
    ax = fx - x0.astype(f32)
    ay = fy - y0.astype(f32)
    bx = f32(1) - ax
    by = f32(1) - ay
    c00, c01 = R1[:, y0, x0], R1[:, y0, x0 + 1]
    c10, c11 = R1[:, y0 + 1, x0], R1[:, y0 + 1, x0 + 1]
    acc = (c00 * bx) * by
    acc = acc + (c01 * ax) * by
    acc = acc + (c10 * bx) * ay
    return acc + (c11 * ax) * ay


def _edge_flow(rng, h, w):
    """A random flow of up to twice the level's size, with pixels sent
    exactly onto the last row and column, just short of them, off every
    edge by a fraction, and onto the first row and column."""
    f32 = np.float32
    fl = rng.uniform(-2 * max(h, w), 2 * max(h, w), (2, h, w)).astype(f32)
    r = np.arange(h, dtype=f32)[:, None] + np.zeros((1, w), f32)
    c = np.arange(w, dtype=f32)[None, :] + np.zeros((h, 1), f32)
    kind = (np.arange(h * w) % 7).reshape(h, w)
    to = {1: ((w - 1) - c, (h - 1) - r),                 # the last pixel
          2: ((w - 1) - c - f32(0.25), (h - 1) - r - f32(1e-3)),
          3: (-c - f32(0.75), -r - f32(2.5)),             # off the top left
          4: ((w - 1) - c + f32(0.5), (h - 1) - r + f32(3.25)),
          5: (-c, -r)}                                    # the first pixel
    for k, (dx, dy) in to.items():
        fl[0][kind == k] = dx[kind == k]
        fl[1][kind == k] = dy[kind == k]
    return fl


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("h,w", ((2, 2), (37, 53), (70, 90)))
def test_exact_warp_model_is_the_plain_gather_bit_for_bit(h, w, dtype):
    """A NumPy float32 model of K8's in-kernel gather, each op rounded
    on its own, equals the plain gather (ops.warp.warp_poly_planar, the
    parent route's gather) bit for bit, f32 and bf16 planes, with
    samples off every edge and onto the last row and column."""
    from kalman_hydra_tpu_torch.ops.warp import warp_poly_planar
    rng = np.random.default_rng(h * 1000 + w)
    R1 = torch.from_numpy(rng.normal(size=(5, h, w)).astype(np.float32)
                          * 50).to(getattr(torch, dtype))
    fl = _edge_flow(rng, h, w)
    want = warp_poly_planar(R1, torch.from_numpy(fl)).numpy()
    got = _exact_warp_np(R1.float().numpy(), fl[0], fl[1])
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("pairs", (False, True))
def test_the_exact_path_calls_only_the_kernel_wrappers(monkeypatch, pairs):
    """At fast_warp=0 ops.farneback hands K8 (K8-pairs) the unwarped
    planes and calls no gather of its own: every iteration is one wrapper
    call on the level's planes (the stack, for pairs)."""
    from kalman_hydra_tpu_torch.config import FlowConfig
    from kalman_hydra_tpu_torch.ops import farneback as fb
    from kalman_hydra_tpu_torch.ops import warp

    def no_gather(*a, **k):
        raise AssertionError("the ops layer gathered")
    monkeypatch.setattr(warp, "warp_poly_planar", no_gather)
    seen = []

    def k8(R0, R1, flow, *a):
        seen.append((R0.data_ptr(), R1.data_ptr(), R0.shape))
        return flow

    def k8_pairs(Rl, flow_b, *a, **k):
        seen.append((Rl.data_ptr(), Rl.shape))
        return flow_b
    monkeypatch.setattr(fb, "flow_update", k8)
    monkeypatch.setattr(fb, "flow_update_pairs", k8_pairs)
    cfg = FlowConfig(levels=2, iterations=3)
    assert cfg.fast_warp == 0
    levels = [torch.randn(3, 5, 12, 16), torch.randn(3, 5, 24, 32)]
    if pairs:
        fb.farneback_pairs_from_pyramids(levels, cfg)
        want = [(lv.data_ptr(), lv.shape) for lv in levels]
    else:
        fb.farneback_from_pyramids([lv[0] for lv in levels],
                                   [lv[1] for lv in levels], cfg)
        want = [(lv[0].data_ptr(), lv[1].data_ptr(), lv[0].shape)
                for lv in levels]
    assert seen == [x for x in want for _ in range(3)]


PIPE_SHAPES = [(n, nb, nt, dt, skew) for n in (2, 3, 5)
               for nb in (1, 2, 3, 34) for nt in (1, 2, 7) for dt in (1, 2)
               for skew in (1, 2, 4)]


def _item_of(q, n_iters, nb, nt, skew):
    """csrc/flow_tile.cuh::pipe_item, statement for statement (C's
    integer division, on non-negative operands here)."""
    s = 0
    while True:
        j0 = 0 if s < nb else (s - nb + skew) // skew
        j1 = min(n_iters - 1, s // skew)
        n = (j1 - j0 + 1) * nt if j1 >= j0 else 0
        if q < n:
            j = j0 + q // nt
            return j, s - skew * j, q % nt
        q -= n
        s += 1


@pytest.mark.parametrize("n_iters,nb,nt,dt,skew", PIPE_SHAPES)
def test_pipe_items_wait_only_on_smaller_tickets(n_iters, nb, nt, dt, skew):
    items = pipe_items(n_iters, nb, nt, skew)
    assert items == [_item_of(q, n_iters, nb, nt, skew)
                     for q in range(len(items))]
    ticket = {it: q for q, it in enumerate(items)}
    assert len(ticket) == len(items) == n_iters * nb * nt
    for (j, b, t), q in ticket.items():
        waits = pipe_waits(j, b, t, nb, nt, dt)
        assert all(ticket[wt] < q for wt in waits)
        if j:
            assert (j - 1, b, t) in waits
            # every band and tile within reach, clipped to the level
            assert len(waits) == ((min(nb - 1, b + 1) - max(0, b - 1) + 1)
                                  * (min(nt - 1, t + dt) - max(0, t - dt)
                                     + 1))


def test_pipe_skew_spaces_waits_past_the_resident_blocks():
    """On 132 SMs the two fine 1080p levels get skews 7 and 13: never
    fewer than skew - 1 bands of tiles lie between an item and its own
    tile's previous iteration, and at 1080p, once every iteration is in
    flight, more than the 528 blocks two an SM hold; small levels stay
    within their band count."""
    for (h, w), want in (((1080, 1920), 7), ((540, 960), 13)):
        plan = tile_plan(h, w, 15)
        skew = pipe_skew(plan, 3, 132)
        assert skew == want <= plan.rows
        items = pipe_items(3, plan.rows, plan.cols, skew)
        ticket = {it: q for q, it in enumerate(items)}
        gaps = {(j, b): q - ticket[(j - 1, b, t)]
                for (j, b, t), q in ticket.items() if j}
        assert min(gaps.values()) >= (skew - 1) * plan.cols
    plan = tile_plan(1080, 1920, 15)
    items = pipe_items(3, plan.rows, plan.cols, 7)
    ticket = {it: q for q, it in enumerate(items)}
    assert ticket[(2, 17, 0)] - ticket[(1, 17, 0)] > 2 * 2 * 132
    assert pipe_skew(tile_plan(20, 30, 15), 3, 132) == 1
    assert pipe_skew(tile_plan(37, 53, 15), 2, 132) == 2


@pytest.mark.parametrize("winsize,max_disp", [(15, 8), (15, 0), (31, 40),
                                              (5, 3)])
def test_pipe_waits_cover_the_flow_a_tile_reads(winsize, max_disp):
    """A tile's M spans its rows and columns +- bw, and M at (r, c) reads
    the prior flow on row r at columns c - D ... c + D + 1: all of it lies
    in the tiles the item waits for."""
    h, w = 70, 300
    plan = tile_plan(h, w, winsize)
    bw, dt = plan.taps // 2, pipe_dt(plan, max_disp)
    for b in range(plan.rows):
        for t in range(plan.cols):
            waits = pipe_waits(1, b, t, plan.rows, plan.cols, dt)
            rows = {bb for _, bb, _ in waits}
            cols = {tt for _, _, tt in waits}
            r0, c0 = b * plan.th, t * plan.tw
            for r in range(max(0, r0 - bw), min(h, r0 + plan.th + bw)):
                assert r // plan.th in rows
            lo = max(0, c0 - bw - max_disp)
            hi = min(w - 1, c0 + plan.tw - 1 + bw + max_disp + 1)
            assert {lo // plan.tw, hi // plan.tw} <= cols
