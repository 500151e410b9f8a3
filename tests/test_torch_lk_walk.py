"""CPU tests of K12's walk (kernels/lk.py::lk_sparse_levels, one launch for
every level of a frame step): its plain version against lk_sparse's old
per-level route bit for bit, and both C interfaces as the wrappers call
them."""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kalman_hydra_tpu_torch.config import FlowConfig
from kalman_hydra_tpu_torch.io.synthetic import moving_blob_clip
from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.kernels import lk as klk
from kalman_hydra_tpu_torch.ops import lk as tlk
from kalman_hydra_tpu_torch.ops.color import grayscale_u8

CSRC = Path(klk.__file__).resolve().parents[1] / "csrc"


def _args(img_a, img_b, gx, gy, pts, guess, cfg):
    """One level's K12 arguments at cfg's LK settings."""
    return klk.level_args(img_a, img_b, gx, gy, pts, guess, cfg.lk_winsize,
                          cfg.lk_max_iter, cfg.lk_eps, cfg.lk_min_eig,
                          cfg.lk_block_halo)


def _route(pa, grads, pb, pts, cfg, guess):
    """A frame step as ops/lk.py ran it before the walk: one one-level
    K12 call a level and the torch glue around it."""
    status = torch.ones(pts.shape[0], dtype=torch.bool)
    for lvl in range(cfg.levels - 1, -1, -1):
        gx, gy = grads[lvl]
        args = _args(pa[lvl], pb[lvl], gx, gy, pts * (1.0 / (2 ** lvl)),
                     guess, cfg)
        new, ok = klk.lk_level(*args)
        guess = new - args[8]
        if lvl == 0:
            h, w = pa[0].shape
            inb = ((guess[:, 0] >= 0) & (guess[:, 0] <= w - 1)
                   & (guess[:, 1] >= 0) & (guess[:, 1] <= h - 1))
            status = status & ok & inb
        else:
            guess = guess * 2.0
    return guess, status


@pytest.fixture(scope="module")
def frames():
    clip, _ = moving_blob_clip(num_frames=2, height=96, width=128,
                               num_points=4, blob_sigma=10.0,
                               velocity=(2.1, -1.4), seed=3)
    g0, g1 = (grayscale_u8(torch.from_numpy(clip[i])) for i in (0, 1))
    rs = np.random.RandomState(5)
    pts = (rs.random_sample((40, 2)) * [127.0, 95.0]).astype(np.float32)
    border = [[0, 0], [127, 0], [0, 95], [127, 95], [1, 47.5], [64, 95]]
    return g0, g1, torch.from_numpy(np.concatenate(
        [pts, np.float32(border)]))


@pytest.mark.parametrize("levels", (3, 4))
@pytest.mark.parametrize("far", (False, True))
@pytest.mark.parametrize("halo", (0, 8))
def test_walk_plain_equals_the_per_level_route(frames, halo, far, levels):
    """lk_sparse_levels_plain (what lk_sparse runs on a CPU tensor) gives
    the per-level route's points and status bit for bit, at the exact
    window (halo 0) and the block window (halo 8), from the handed-down
    guess and from one 12 x -9 px off at the coarsest level; at 4 levels
    the coarsest, 12 x 16 (36 x 40 padded), is smaller than the halo'd
    38 x 38 block, so it takes the exact window there."""
    g0, g1, pts = frames
    cfg = FlowConfig(method="lk_sparse", levels=levels, lk_block_halo=halo)
    pa, grads = tlk.lk_pyramid(g0, cfg)
    pb, _ = tlk.lk_pyramid(g1, cfg)
    guess = pts * (1.0 / 2 ** (levels - 1))
    if far:
        guess = guess + torch.tensor([12.0, -9.0])
    if levels == 4 and halo:
        h, w = pa[-1].shape
        assert klk.window(h, w, guess, cfg.lk_winsize,
                          halo)[1] != (16.0, 16.0)
    got, st = klk.lk_sparse_levels(pa, pb, grads, pts, cfg.lk_winsize,
                                   cfg.lk_max_iter, cfg.lk_eps,
                                   cfg.lk_min_eig, halo, guess=guess)
    ref, rst = _route(pa, grads, pb, pts, cfg, guess)
    assert torch.equal(got, ref) and torch.equal(st, rst)
    assert st.any() and got.dtype == torch.float32


@pytest.mark.parametrize("halo", (0, 8))
def test_lk_sparse_runs_the_walk(frames, halo):
    """ops.lk.lk_sparse is the walk over cfg.levels of the two pyramids
    (its default guess pts / 2^(levels - 1)); on the CPU it counts no
    launch."""
    g0, g1, pts = frames
    cfg = FlowConfig(method="lk_sparse", levels=3, lk_block_halo=halo)
    pa, grads = tlk.lk_pyramid(g0, cfg)
    pb, _ = tlk.lk_pyramid(g1, cfg)
    klk.lk_sparse_levels.launches = 0
    got, st = tlk.lk_sparse(g0, g1, pts, cfg)
    ref, rst = _route(pa, grads, pb, pts, cfg, pts * 0.25)
    assert torch.equal(got, ref) and torch.equal(st, rst)
    assert klk.lk_sparse_levels.launches == 0


_C_TYPES = {"const void*": _build.P, "void*": _build.P, "int": _build.I,
            "float": _build.F, "const unsigned long long*": _build.P,
            "const int*": _build.P}


def _c_signature(name):
    src = (CSRC / "lk.cu").read_text()
    args = re.search(rf"KH_API int {name}\(([^)]*)\)", src).group(1)
    return [_C_TYPES[re.sub(r"\s+\w+$", "", a.strip())]
            for a in args.split(",")]


def _recorder(monkeypatch, tables):
    calls = []

    def function(fname, *argtypes):
        def fn(*args):       # the host tables live only during the call
            calls.append((fname, argtypes, args, tables(fname, args)))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    return calls


@pytest.mark.parametrize("with_guess", (False, True))
def test_walk_calls_the_c_interface_as_declared(monkeypatch, frames,
                                                with_guess):
    """The walk's launcher, run on CPU tensors with the library call
    recorded, makes ONE kh_lk_levels call with the types of the C
    signature: each level's four image pointers and (h, w), finest
    first; the points and their row stride (a column slice of a 6-state
    filter: 6); the coarsest level's guess or null; eps squared in f32;
    the halo."""
    def tables(fname, args):
        nl = args[2]
        return (np.ctypeslib.as_array((ctypes.c_uint64 * (4 * nl))
                                      .from_address(args[0])).copy(),
                np.ctypeslib.as_array((ctypes.c_int * (2 * nl))
                                      .from_address(args[1])).copy())
    calls = _recorder(monkeypatch, tables)
    g0, g1, pts = frames
    cfg = FlowConfig(method="lk_sparse", levels=3, lk_block_halo=8)
    pa, grads = tlk.lk_pyramid(g0, cfg)
    pb, _ = tlk.lk_pyramid(g1, cfg)
    guess = pts * 0.25 if with_guess else None
    state = torch.cat([pts, torch.zeros(pts.shape[0], 4)], 1)
    pos = state[:, 0:2]               # a column slice, as the filter's
    out, st = klk._launch_walk(pa, pb, grads, pos, 21, 10, 0.01, 1e-4, 8,
                               guess)
    (fname, argtypes, args, (ptrs, dims)), = calls
    assert fname == "kh_lk_levels"
    assert list(argtypes) == _c_signature(fname)
    assert len(args) == len(argtypes)
    (_, _, nl, p, ps, g, K, win, max_iter, eps2, min_eig, halo, o, s,
     _stream) = args
    assert (nl, p, ps, K, win, max_iter, halo) == (
        3, pos.data_ptr(), 6, pts.shape[0], 21, 10, 8)
    assert g == (guess.data_ptr() if with_guess else None)
    assert eps2 == float(np.float32(0.01 * 0.01)) and min_eig == 1e-4
    assert (o, s) == (out.data_ptr(), st.data_ptr())
    assert out.shape == (pts.shape[0], 2) and st.dtype == torch.bool
    for lvl in range(3):
        assert list(ptrs[4 * lvl:4 * lvl + 4]) == [
            t.data_ptr() for t in (pa[lvl], pb[lvl], *grads[lvl])]
        assert list(dims[2 * lvl:2 * lvl + 2]) == list(pa[lvl].shape)


def test_one_level_calls_the_c_interface_as_declared(monkeypatch, frames):
    """lk_level's launcher (the one-level launch of the same kernel)
    passes level_args as kh_lk_level declares them."""
    calls = _recorder(monkeypatch, lambda fname, args: None)
    g0, g1, pts = frames
    cfg = FlowConfig(method="lk_sparse", levels=2, lk_block_halo=8)
    pa, grads = tlk.lk_pyramid(g0, cfg)
    pb, _ = tlk.lk_pyramid(g1, cfg)
    args = _args(pa[0], pb[0], *grads[0], pts, pts, cfg)
    out, ok = klk._launch_level(*args)
    (fname, argtypes, cargs, _), = calls
    assert fname == "kh_lk_level"
    assert list(argtypes) == _c_signature(fname)
    assert len(cargs) == len(argtypes)
    assert cargs[:4] == tuple(t.data_ptr() for t in args[:4])
    assert cargs[4:7] == (*pa[0].shape, args[8])
    assert cargs[7:10] == tuple(t.data_ptr() for t in args[4:7])
    assert cargs[10:12] == (16.0, 16.0)
    assert cargs[12:16] == (pts.shape[0], 21, 10,
                            float(np.float32(0.01 * 0.01)))
    assert cargs[17:19] == (out.data_ptr(), ok.data_ptr())
