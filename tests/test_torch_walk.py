"""K5's walk (kernels/flow_level.py::flow_levels, csrc/flow_level.cu) on
the CPU: its plain version against the per-level route it replaced (bit
for bit) and against the JAX reference's flow_level in interpret mode and
its resize, level by level; its plan, ticket order and wait set; its C
interface as the wrapper calls it; and the resize coefficients the walk
and resize_linear share, cached per device."""

from __future__ import annotations

import ctypes
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalman_hydra_tpu.kernels.flow_level_pallas import flow_level as fl_pl
from kalman_hydra_tpu.ops.pyramid import resize_linear as jresize
from kalman_hydra_tpu_torch import kernels
from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.ops import pyramid as tpyr
from kalman_hydra_tpu_torch.ops.pyramid import farneback_levels

# the module, which the package's flow_level function hides
kfl = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_level")
CSRC = Path(kfl.__file__).resolve().parents[1] / "csrc"


def _levels(h, w, levels, rng, dtype=torch.float32):
    """Random (5, lh, lw) R0 and R1 planes of every level of the
    Farneback plan of an h x w frame, coarsest first."""
    shapes = [(lh, lw) for (_k, lh, lw, _s, _ks)
              in farneback_levels(h, w, levels, 0.5)]
    R0s, R1s = [], []
    for lh, lw in shapes:
        for out in (R0s, R1s):
            out.append(torch.from_numpy(rng.normal(size=(5, lh, lw)).astype(
                np.float32)).to(dtype))
    return R0s, R1s


def _route(R0s, R1s, flow, winsize, max_disp, iters, gaussian, pyr_scale):
    """The route the walk replaced, as ops/farneback.py ran it: one level
    after another, each `iters` plain iterations, the flow resized with
    resize_linear and scaled by 1 / pyr_scale between levels."""
    for i, (R0, R1) in enumerate(zip(R0s, R1s)):
        if i:
            flow = tpyr.resize_linear(flow, R0.shape[1], R0.shape[2]) * (
                1.0 / pyr_scale)
        flow = kfl.flow_level_plain(R0, R1, flow, winsize, max_disp, iters,
                                    gaussian)
    return flow


@pytest.mark.parametrize("prior", (False, True))
@pytest.mark.parametrize("gaussian", (False, True))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("h,w,levels", ((100, 128, 2), (128, 112, 3)))
def test_flow_levels_is_the_per_level_route(h, w, levels, dtype, gaussian,
                                            prior, rng):
    """On CPU tensors flow_levels equals the per-level route bit for bit
    (2-3 levels of a <= 128 px frame; f32 and bf16 planes; box and
    Gaussian windows; zero and random +-3 px prior) and counts no
    launch."""
    R0s, R1s = _levels(h, w, levels, rng, dtype)
    lh, lw = R0s[0].shape[1:]
    fl = torch.from_numpy(rng.uniform(-3, 3, (2, lh, lw)).astype(
        np.float32)) if prior else torch.zeros(2, lh, lw)
    kernels.reset_launches()
    got = kfl.flow_levels(R0s, R1s, fl, 15, 8, 3, gaussian, 0.5)
    assert got.shape == (2, h, w) and got.dtype == torch.float32
    assert torch.equal(got, _route(R0s, R1s, fl, 15, 8, 3, gaussian, 0.5))
    assert kfl.flow_levels.launches == 0


@pytest.mark.parametrize("dtype,gaussian", (("float32", False),
                                            ("bfloat16", True)))
def test_flow_levels_matches_pallas_level_by_level(dtype, gaussian, rng):
    """The walk over 1 and 2 levels of a 64x96 frame (32x48, 64x96)
    within 1e-4 of the JAX reference's route after each level: its
    flow_level in interpret mode, its resize_linear times 2 between
    levels."""
    R0s, R1s = _levels(64, 96, 2, rng, getattr(torch, dtype))
    lh, lw = R0s[0].shape[1:]
    fl = rng.uniform(-3, 3, (2, lh, lw)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    ref = jnp.asarray(fl)
    for k in range(len(R0s)):
        if k:
            ref = jresize(ref, *R0s[k].shape[1:]) * (1.0 / 0.5)
        ref = fl_pl(jnp.asarray(R0s[k].float().numpy()).astype(jdt),
                    jnp.asarray(R1s[k].float().numpy()).astype(jdt), ref,
                    15, 8, 2, gaussian=gaussian, interpret=True)
        got = kfl.flow_levels(R0s[:k + 1], R1s[:k + 1], torch.from_numpy(fl),
                              15, 8, 2, gaussian, 0.5)
        assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-4


# the gated levels of 1080p and 720p frames, and a small odd frame
WALK_SHAPES = {
    "1080p": [(34, 60), (68, 120), (135, 240), (270, 480)],
    "720p": [(45, 80), (90, 160), (180, 320), (360, 640)],
    "150x203": [(38, 51), (75, 102), (150, 203)],
}


@pytest.mark.parametrize("winsize,max_disp", ((15, 8), (31, 8), (5, 0)))
@pytest.mark.parametrize("name", WALK_SHAPES)
def test_walk_items_wait_only_on_smaller_tickets(name, winsize, max_disp):
    """Every item's waits come earlier in ticket order (so the smallest
    unfinished claimed ticket can always run), every item appears once,
    and an iteration j > 0 waits for its own tile's iteration j - 1."""
    plan = kfl.walk_plan(WALK_SHAPES[name], winsize, max_disp, 3)
    items = kfl.walk_items(plan, 3)
    ticket = {it: q for q, it in enumerate(items)}
    assert len(ticket) == len(items) == 3 * sum(L.nb * L.nt for L in plan)
    assert [L.item0 for L in plan] == [
        min(q for (l, *_), q in ticket.items() if l == i)
        for i in range(len(plan))]
    for (l, j, b, t), q in ticket.items():
        waits = kfl.walk_waits(plan, l, j, b, t, 3, winsize, max_disp)
        assert all(ticket[wt] < q for wt in waits)
        if j:
            assert (l, j - 1, b, t) in waits
        elif l:
            assert waits and all(wt[:2] == (l - 1, 2) for wt in waits)


@pytest.mark.parametrize("winsize,max_disp", ((15, 8), (31, 3), (5, 0)))
def test_walk_waits_cover_the_flow_an_item_reads(winsize, max_disp):
    """A tile's M spans its rows and columns +- bw, and M at (r, c) reads
    the prior flow on row r at columns c - D ... c + D + 1; at a level's
    first iteration that flow is the resize of the coarser level's, read
    at rows y0[r], y1[r] and columns x0[c], x1[c]. All of it lies in the
    tiles the item waits for."""
    plan = kfl.walk_plan(WALK_SHAPES["150x203"], winsize, max_disp, 2)
    bw = winsize // 2
    for l, L in enumerate(plan):
        for b in range(L.nb):
            for t in range(L.nt):
                rows = range(max(0, b * L.th - bw),
                             min(L.h, b * L.th + L.th + bw))
                lo = max(0, t * L.tw - bw - max_disp)
                hi = min(L.w - 1, t * L.tw + L.tw - 1 + bw + max_disp + 1)
                for j in (0, 1):
                    waits = set(kfl.walk_waits(plan, l, j, b, t, 2, winsize,
                                               max_disp))
                    if j:
                        need = {(l, 0, r // L.th, c // L.tw) for r in rows
                                for c in (lo, hi)}
                    elif l:
                        C = plan[l - 1]
                        y0, y1, _ = tpyr.resize_coeffs(L.h, C.h)
                        x0, x1, _ = tpyr.resize_coeffs(L.w, C.w)
                        need = {(l - 1, 1, y // C.th, x // C.tw)
                                for r in rows for y in (y0[r], y1[r])
                                for x in (x0[lo], x1[hi])}
                    else:
                        need = set()
                    assert need <= waits


def test_walk_plan_tiles_and_shared_memory():
    """Each level takes the smallest tiles of which one iteration fits
    the 396 blocks 132 SMs hold (1080p: 8 x 8 at 34x60 and 68x120, 8 x 16
    at 135x240, 16 x 32 at 270x480, where 8 x 16 would take 1,020), its
    items iteration after iteration (skew = its bands); one block's
    shared memory is the 16 x 32 tile's M and its halo (5 f32 planes at
    an odd row stride), within an H100 block's limit for every window the
    kernels take; tickets and progress words run level after level."""
    plan = kfl.walk_plan(WALK_SHAPES["1080p"], 15, 8, 3)
    assert [(L.th, L.tw) for L in plan] == [(8, 8), (8, 8), (8, 16),
                                            (16, 32)]
    assert [L.nb * L.nt for L in plan] == [40, 135, 255, 255]
    assert [(L.db, L.dt, L.skew) for L in plan] == [
        (1, 2, 5), (1, 2, 9), (1, 1, 17), (1, 1, 17)]
    assert [L.prog0 for L in plan] == [0, 40, 175, 430]
    assert [L.item0 for L in plan] == [0, 120, 525, 1290]
    assert [L.shape for L in kfl.walk_plan(WALK_SHAPES["1080p"], 15, 8, 3,
                                           sms=16)] == [2, 0, 0, 0]
    assert kfl.walk_smem(15) == 4 * 5 * (16 + 14) * ((32 + 14) | 1)
    assert kfl.walk_smem(61) + 260 <= 232_448
    assert kfl.walk_plan([(5, 7)], 1, 0, 1)[0].skew == 1
    with pytest.raises(ValueError):
        kfl.walk_plan([(34, 60)] * 9, 15, 8, 3)


def _gated(h, w, levels, pyr_scale, itemsize=2):
    return [(lh, lw) for (_k, lh, lw, _s, _ks)
            in farneback_levels(h, w, levels, pyr_scale)
            if kfl.fits(lh, lw, itemsize)]


@pytest.mark.parametrize("h,w,pyr_scale,runs", (
    (1080, 1920, 0.8, [8, 3]), (720, 1280, 0.75, [8, 1]),
    (1080, 1920, 0.5, [4])))
def test_walks_plan_at_most_max_levels_a_launch(monkeypatch, h, w,
                                                pyr_scale, runs):
    """A pyr_scale near 1 gates more levels than one launch takes (11 at
    1080p and 0.8, 9 at 720p and 0.75): the device route plans one walk
    for each MAX_LEVELS of them, every plan within walk_plan's limit, and
    counts one launch a walk."""
    shapes = _gated(h, w, 20, pyr_scale)
    assert len(shapes) == sum(runs)
    walks = []

    def launch(R0s, R1s, flow, winsize, max_disp, iters, gaussian, ps):
        got = [tuple(R.shape[1:]) for R in R0s]
        assert flow.shape == (2,) + got[0]
        walks.append(kfl.walk_plan(got, winsize, max_disp, iters))
        return torch.zeros((2,) + got[-1])
    monkeypatch.setattr(kfl, "_launch", launch)
    R = [torch.empty(5, lh, lw, dtype=torch.bfloat16) for lh, lw in shapes]
    kernels.reset_launches()
    out = kfl._walks(R, R, torch.zeros(2, *shapes[0]), 15, 8, 3, False,
                     pyr_scale)
    assert [len(p) for p in walks] == runs
    assert all(len(p) <= kfl.MAX_LEVELS for p in walks)
    assert [(L.h, L.w) for p in walks for L in p] == shapes
    assert out.shape == (2,) + shapes[-1]
    assert kfl.flow_levels.launches == len(runs)


def test_walks_equal_the_per_level_route(monkeypatch, rng):
    """Split into walks (one level a walk here, so that 3 levels take
    three), with each walk run by its plain version, the device route
    equals the per-level route bit for bit: the resize between walks is
    the one between levels."""
    monkeypatch.setattr(kfl, "MAX_LEVELS", 1)
    monkeypatch.setattr(kfl, "_launch", lambda *a: kfl.flow_levels_plain(*a))
    R0s, R1s = _levels(128, 128, 3, rng)
    fl = torch.from_numpy(rng.uniform(-3, 3, (2,) + tuple(
        R0s[0].shape[1:])).astype(np.float32))
    kernels.reset_launches()
    got = kfl._walks(R0s, R1s, fl, 15, 8, 2, True, 0.5)
    assert torch.equal(got, _route(R0s, R1s, fl, 15, 8, 2, True, 0.5))
    assert len(R0s) == kfl.flow_levels.launches == 3


def _cu_int(name):
    src = (CSRC / "flow_level.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _ternary(expr, s):
    """A C chain `s == 0 ? a : s == 1 ? b : c` at s."""
    parts = [p.strip() for p in re.split(r"[?:]", expr)]
    for cond, val in zip(parts[:-1:2], parts[1::2]):
        if int(cond.split("==")[1]) == s:
            return int(val)
    return int(parts[-1])


def test_the_plan_uses_the_shapes_the_kernel_builds():
    """WALK_TILES, MAX_LEVELS and BLOCKS_PER_SM are csrc/flow_level.cu's
    shape_h/shape_w, kMaxLevels and the kernel's launch bounds."""
    src = (CSRC / "flow_level.cu").read_text()
    body = {f: re.search(rf"int {f}\(int s\) \{{\s*return ([^;]*);",
                         src).group(1) for f in ("shape_h", "shape_w")}
    for i, (th, tw) in enumerate(kfl.WALK_TILES):
        assert _ternary(body["shape_h"], i) == th
        assert _ternary(body["shape_w"], i) == tw
    assert len(kfl.WALK_TILES) == _cu_int("kShapes")
    assert kfl.MAX_LEVELS == _cu_int("kMaxLevels")
    assert re.search(r"__launch_bounds__\(kTileThreads, (\d)\)\s*"
                     r"flow_walk_kernel", src).group(1) == str(
                         kfl.BLOCKS_PER_SM)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "const unsigned long long*": ctypes.c_void_p,
            "const int*": ctypes.c_void_p}


def _c_signature(name):
    src = (CSRC / "flow_level.cu").read_text()
    args = re.search(rf"KH_API int {name}\(([^)]*)\)", src).group(1)
    return [_C_TYPES[re.sub(r"\s+\w+$", "", a.strip())]
            for a in args.split(",")]


@pytest.mark.parametrize("gaussian", (False, True))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flow_levels_calls_the_c_interface_as_declared(monkeypatch, dtype,
                                                       gaussian):
    """_launch, run on CPU tensors with the library call recorded, makes
    ONE kh_flow_levels call for all levels, with the types of the C
    signature, the plan's dims table, each level's planes, flow buffers
    (disjoint, iters of them a level, iters - 1 for the last) and the
    cached resize coefficients, the window's taps in host memory, 1 /
    pyr_scale and the plan's shared memory."""
    calls = []

    def function(fname, *argtypes):
        def fn(*args):       # the host tables live only during the call
            n = args[0]
            calls.append((fname, argtypes, args, np.ctypeslib.as_array(
                (ctypes.c_uint64 * (9 * n)).from_address(args[1])).copy(),
                np.ctypeslib.as_array((ctypes.c_int * (10 * n))
                                      .from_address(args[2])).copy()))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(kfl, "_sm_count", lambda dev: 132)
    shapes = WALK_SHAPES["150x203"]
    R0s = [torch.zeros(5, h, w, dtype=dtype) for h, w in shapes]
    R1s = [torch.zeros(5, h, w, dtype=dtype) for h, w in shapes]
    fl = torch.zeros(2, *shapes[0])
    out = kfl._launch(R0s, R1s, fl, 15, 8, 3, gaussian, 0.5)
    (fname, argtypes, args, ptrs, dims), = calls
    assert fname == "kh_flow_levels"
    assert list(argtypes) == _c_signature(fname)
    assert len(args) == len(argtypes)
    (n, _p, _d, bf16, prior, D, _wts, wts_dev, taps, post, iters, scale,
     smem, _counters, out_ptr, _stream) = args
    assert wts_dev is None          # 15 taps ride in the parameters
    plan = kfl.walk_plan(shapes, 15, 8, 3)
    assert (n, bf16, prior, D, taps, iters, smem, out_ptr) == (
        3, int(dtype == torch.bfloat16), fl.data_ptr(), 8, 15, 3,
        kfl.walk_smem(15), out.data_ptr())
    assert scale == 2.0 and out.shape == (2, 150, 203)
    assert post == pytest.approx(1 / 225 if not gaussian else 1.0)
    ptrs, dims = ptrs.reshape(3, 9), dims.reshape(3, 10)
    for i, L in enumerate(plan):
        assert list(dims[i]) == [L.h, L.w, L.shape, L.nb, L.nt, L.db, L.dt,
                                 L.skew, L.item0, L.prog0]
        assert list(ptrs[i, :2]) == [R0s[i].data_ptr(), R1s[i].data_ptr()]
        if i:
            want = [a.data_ptr() for a in tpyr.resize_coeffs_device(
                L.h, plan[i - 1].h, "cpu") + tpyr.resize_coeffs_device(
                L.w, plan[i - 1].w, "cpu")]
            assert list(ptrs[i, 3:]) == want
        else:
            assert not ptrs[i, 3:].any()
    # each level's buffers follow the last: 3 iterations of 2 planes, 2
    # for the last level (its last iteration writes `out`)
    sizes = [2 * h * w * 4 for h, w in shapes]
    assert ptrs[1, 2] - ptrs[0, 2] == 3 * sizes[0]
    assert ptrs[2, 2] - ptrs[1, 2] == 3 * sizes[1]


def test_one_level_launch_counts_as_flow_level(monkeypatch):
    """flow_level is the walk's launch over one level (pyr_scale unused):
    off the CPU it counts in flow_level.launches, the walk in
    flow_levels.launches; flow_levels lists in kernels.WRAPPERS in its
    place. (Meta tensors stand for the card's, the launch recorded.)"""
    seen = []
    monkeypatch.setattr(kfl, "_check", lambda *a: None)
    monkeypatch.setattr(kfl, "_launch", lambda R0s, R1s, flow, *a:
                        seen.append((len(R0s),) + a) or flow)
    R = torch.zeros(5, 34, 60, device="meta")
    fl = torch.zeros(2, 34, 60, device="meta")
    before = (kfl.flow_level.launches, kfl.flow_levels.launches)
    kfl.flow_level(R, R, fl, 15, 8, 3)
    kfl.flow_levels([R, R], [R, R], fl, 15, 8, 2, True, 0.5)
    after = (kfl.flow_level.launches, kfl.flow_levels.launches)
    kfl.flow_level.launches, kfl.flow_levels.launches = before
    assert seen == [(1, 15, 8, 3, False, 1.0), (2, 15, 8, 2, True, 0.5)]
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    assert "flow_levels" in kernels.WRAPPERS
    assert "flow_level" not in kernels.WRAPPERS


@pytest.mark.parametrize("n_out,n_in", ((68, 34), (120, 60), (203, 102),
                                        (1080, 540), (5, 3), (7, 7)))
def test_resize_coefficients_are_cached_and_unchanged(n_out, n_in, rng):
    """resize_linear's coefficients are made once per (out, in, device)
    and its values are those of the uncached form (int64 indices, f64
    weights rounded to f32 on the device at every call)."""
    img = torch.from_numpy(rng.normal(size=(2, n_in, n_in + 3)).astype(
        np.float32))
    got = tpyr.resize_linear(img, n_out, n_out + 1)
    first = tpyr.resize_coeffs_device(n_out, n_in, "cpu")
    assert all(a is b for a, b in zip(
        first, tpyr.resize_coeffs_device(n_out, n_in, torch.device("cpu"))))
    y0, y1, fy = (torch.as_tensor(a) for a in tpyr.resize_coeffs(n_out, n_in))
    x0, x1, fx = (torch.as_tensor(a)
                  for a in tpyr.resize_coeffs(n_out + 1, n_in + 3))
    fy = fy.to(torch.float32)[:, None]
    fx = fx.to(torch.float32)
    rows = img.index_select(-2, y0) * (1 - fy) + img.index_select(-2, y1) * fy
    want = (rows.index_select(-1, x0) * (1 - fx)
            + rows.index_select(-1, x1) * fx)
    assert torch.equal(got, want)
