"""The fused Farneback iteration of K2, K6 and K13 (csrc/flow_tile.cuh):
the wrappers' tile and shared-memory plan, their C calls, and K13's work
order and wait set.

The CUDA kernels run only on the card, where chip_smoke.py holds them to
their plain versions and to the old three-launch K2 bit for bit; these
tests pin, on the CPU, the Python side the wrappers pass to the kernels."""

import ctypes
import importlib
import re
from pathlib import Path

import pytest
import torch

from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.kernels.flow_iter import (
    MAX_TAPS, SMEM_LIMIT, STATIC_SMEM, TILE, pipe_dt, pipe_items, pipe_skew,
    pipe_waits, tile_plan)

# the module (the package's `flow_iter` is the wrapper function)
fi = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_iter")
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


@pytest.mark.parametrize("winsize", (1, 3, 5, 15, 31, 43, 59, 61, 62, 63,
                                     65, 101, 121, 201, 1001, 2001))
def test_tile_plan_raises_for_a_window_that_does_not_fit(winsize):
    taps = 2 * (winsize // 2) + 1
    need = _smem(taps)
    if taps <= MAX_TAPS and need + STATIC_SMEM <= SMEM_LIMIT:
        assert tile_plan(37, 53, winsize).smem == need
    else:
        with pytest.raises(ValueError, match="232448 B"):
            tile_plan(37, 53, winsize)


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


def test_the_plan_uses_the_tile_the_kernels_build():
    """TILE and MAX_TAPS are flow_tile.cuh's kTileH, kTileW and kMaxTaps,
    and the flow's staging (2 planes of th x (tw + 1)) fits in M's buffer
    at the smallest window."""
    assert TILE == (_cuh_int("kTileH"), _cuh_int("kTileW"))
    assert MAX_TAPS == _cuh_int("kMaxTaps")
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
        fi._launch(R, R, fl[None], 0, 15, 8, False)
    else:
        fi._launch_pipe(R, R, fl, 15, 8, 3, False)
    (fname, argtypes, args), = calls
    assert fname == name
    assert list(argtypes) == _c_signature(source, name)
    assert len(args) == len(argtypes)
    assert tile_plan(h, w, 15).smem in args


PIPE_SHAPES = [(n, nb, nt, dt, skew) for n in (2, 3, 5)
               for nb in (1, 2, 3, 34) for nt in (1, 2, 7) for dt in (1, 2)
               for skew in (1, 2, 4)]


def _item_of(q, n_iters, nb, nt, skew):
    """csrc/flow_iters_pipe.cu::item_of, statement for statement (C's
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
