"""poly_n past 7: the generic builds of K3/K7a and K4/K7b (the taps in
shared memory, copied from device memory; the tile's halo and rows sized
from n) and, past POLY_N_MAX, their device-memory route (K11's level
images, then kh_polyexp_mem's two passes over every level, their moment
planes in a scratch buffer) planned through their wrappers on CPU
tensors with the library call recorded, and the expansion and the
Farneback setting at poly_n up to 257 against the JAX package (Pallas in
interpret mode) on the CPU, its results from the store
(torch_ref_store.py) past POLY_N_MAX and at n = 11, computed live when
an entry is stale or missing. The kernels run on the card, in
chip_smoke.py's F4 phase."""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalman_hydra_tpu.config import FlowConfig
from kalman_hydra_tpu.io.synthetic import translating_pair
from kalman_hydra_tpu.kernels.polyexp_pallas import (
    poly_expansion_planar as pe_pl)
from kalman_hydra_tpu_torch import api, pipeline
from kalman_hydra_tpu_torch.config import FlowConfig as TFlowConfig
from kalman_hydra_tpu_torch.config import RunConfig
from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.kernels import level_image as li
from kalman_hydra_tpu_torch.kernels import polyexp as pe
from kalman_hydra_tpu_torch.ops import farneback as TFB
from torch_ref_store import farneback_interpret, reference
import torch_threads  # noqa: F401  (one torch thread a worker)

CSRC = Path(pe.__file__).resolve().parents[1] / "csrc"
SIGMA = {9: 1.9, 11: 2.3, 13: 2.7}


def _record(monkeypatch):
    calls = []

    def function(fname, *argtypes):
        def fn(*args):
            calls.append((fname, args))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    return calls


def _floats(ptr, n):
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


@pytest.mark.parametrize("n", (9, 11, 13, pe.POLY_N_MAX))
def test_polyexp_plan_takes_the_generic_build(n):
    """K3/K7a at an n with no compiled build: the 32 x 64 tile, its
    (32 + 2n) x (64 + 2n) input, three moment planes at the odd stride
    (64 + 2n) | 1 and the 3 (2n + 1) taps, within one block's shared
    memory up to POLY_N_MAX, and no further."""
    plan = pe.polyexp_plan(n)
    assert (plan.th, plan.tw) == (32, 64) and n not in pe.COMPILED_N
    assert plan.smem == 4 * ((32 + 2 * n) * (64 + 2 * n)
                             + 96 * ((64 + 2 * n) | 1) + 3 * (2 * n + 1))
    assert plan.smem <= pe.SMEM_LIMIT
    assert pe.polyexp_plan(n, torch.bfloat16) == plan


def test_poly_n_limit_is_the_shared_memory_the_kernels_take():
    """POLY_N_MAX is the largest odd n whose K3 tile fits one block and
    whose K4 level tile (16 rows of pe_in_w(n)) with its polyexp body
    fits half of one; the next odd n misses one of the two. The C
    header's n-widened strides are the plan's."""
    def fits(n):
        in_w = li.pe_in_w(n)
        k4 = 4 * ((16 + 2 * n) * in_w + 3 * li.PE_TH * in_w
                  + 3 * li.pe_tap_stride(n))
        return pe._generic_smem(n) <= pe.SMEM_LIMIT and \
            k4 <= pe.SMEM_LIMIT // 2
    assert pe.POLY_N_MAX % 2 == 1 and fits(pe.POLY_N_MAX)
    assert not fits(pe.POLY_N_MAX + 2)
    src = (CSRC / "polyexp.cuh").read_text()
    assert int(re.search(r"constexpr int kPeNMax = (\d+);", src).group(1)) \
        == li.PE_N_BY_VALUE
    for n in (1, 5, 7, 8, 9, 13):
        assert li.pe_in_w(n) == 64 + 2 * max(n, 8)
        assert li.pe_tap_stride(n) == 2 * max(n, 8) + 1
    assert li.pe_in_w(5) == 80 and li.pe_tap_stride(5) == 17


@pytest.mark.parametrize("frames", (1, 2))
@pytest.mark.parametrize("n", (9, 13))
def test_generic_builds_call_the_c_interface(monkeypatch, n, frames):
    """K3/K7a and K4/K7b at n > 8 pass the plan's shared memory and the
    taps in host memory and, for the generic builds, in device memory;
    the compiled n (5) passes none there."""
    calls = _record(monkeypatch)
    imgs = torch.zeros(frames, 70, 100)
    pe._launch(imgs, n, SIGMA[n], torch.bfloat16)
    li._launch(imgs, 3, 0.5, n, SIGMA[n], torch.float32)
    pe._launch(imgs, 5, 1.1, torch.float32)
    (k3, a3), (k4, a4), (k5, a5) = calls
    taps = pe.poly_taps(n, SIGMA[n])
    assert (k3, k4, k5) == ("kh_polyexp", "kh_level_polyexp", "kh_polyexp")
    assert a3[6] == n and a3[8] == pe.polyexp_plan(n).smem
    assert np.array_equal(_floats(a3[4], len(taps)), taps)
    assert np.array_equal(_floats(a3[5], len(taps)), taps)
    plan = li.fused_plan(70, 100, 3, 0.5, n, frames)
    assert a4[9] == n and a4[13] == plan.smem
    assert np.array_equal(_floats(a4[8], len(taps)), taps)
    assert a5[5] is None


BIG_N = (53, 75, 101, 257)


def _ints(ptr, n, ctype=ctypes.c_int):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)).copy()


def _record_mem(monkeypatch):
    """_record, with each kh_polyexp_mem call's level table (ptrs, dims:
    two a level) read while the call's arrays live."""
    calls = []

    def function(fname, *argtypes):
        def fn(*args):
            table = None
            if fname == "kh_polyexp_mem":
                lv = args[1]
                table = (_ints(args[2], 2 * lv, ctypes.c_uint64)
                         .reshape(lv, 2).tolist(),
                         [tuple(d) for d in _ints(args[3], 2 * lv)
                          .reshape(lv, 2).tolist()])
            calls.append((fname, args, table))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    return calls


@pytest.mark.parametrize("frames", (1, 2))
@pytest.mark.parametrize("n", BIG_N)
def test_routes_past_poly_n_max_take_device_memory(monkeypatch, n, frames):
    """Past POLY_N_MAX both K3/K7a and K4/K7b take the device-memory
    route: K3/K7a one kh_polyexp_mem call over one level, with the taps
    in host memory and as the (2n + 1, 4) {g, xg, xxg, 0} table in device
    memory, and a (frames, w, pitch, 4) f32 scratch, pitch = h rounded
    up to MEM_R; K4/K7b the level images of every frame
    (kh_level_images_batch, K11's plan) and then one kh_polyexp_mem call
    over every coarse level, its scratch each level's block after the
    last. No shared-memory plan is asked for: the tiled plan refuses such
    an n, and no fused level plan is made."""
    assert pe.polyexp_route(n) == "mem" and li.level_route(n) == "mem"
    assert pe.polyexp_route(pe.POLY_N_MAX) == "generic"
    assert li.level_route(pe.POLY_N_MAX) == "fused"
    with pytest.raises(ValueError):
        pe.polyexp_plan(n)
    calls = _record_mem(monkeypatch)
    h, w, sg = 70, 100, 0.2 * n
    imgs = torch.zeros(frames, h, w)
    out = pe._launch(imgs, n, sg, torch.bfloat16)
    assert out.shape == (frames, 5, h, w) and out.dtype == torch.bfloat16
    (name, a, (ptrs, dims)), = calls
    taps, t = pe.poly_taps(n, sg), 2 * n + 1
    assert name == "kh_polyexp_mem" and a[:2] == (frames, 1)
    assert ptrs == [[imgs.data_ptr(), out.data_ptr()]] and dims == [(h, w)]
    assert a[6] == n and a[7] == 1
    assert a[9] == pe.mem_scratch_floats(frames, h, w) == 4 * frames * w * 72
    assert np.array_equal(_floats(a[4], len(taps)), taps)
    taps4 = _floats(a[5], 4 * t).reshape(t, 4)
    assert np.array_equal(taps4[:, :3].T.ravel(), taps[:3 * t])
    assert not taps4[:, 3].any()
    calls.clear()
    outs, launches = li._launch(imgs, 3, 0.5, n, sg, torch.float32)
    plan = li.fused_plan(h, w, 3, 0.5, 0, frames, li.IMG_SPLIT_MAX)
    assert [c[0] for c in calls] == ["kh_level_images_batch",
                                     "kh_polyexp_mem"]
    assert launches == 2 and calls[0][1][1:4] == (frames, h, w)
    _, a, (ptrs, dims) = calls[1]
    assert a[:2] == (frames, len(plan.levels)) and a[6:8] == (n, 0)
    assert dims == [(lv.lh, lv.lw) for lv in plan.levels]
    assert [p[1] for p in ptrs] == [o.data_ptr() for o in outs]
    assert a[9] == sum(pe.mem_scratch_floats(frames, lv.lh, lv.lw)
                       for lv in plan.levels)
    for lv, o in zip(plan.levels, outs):
        assert o.shape == (frames, 5, lv.lh, lv.lw)


def test_device_memory_route_takes_levels_in_runs(monkeypatch):
    """K4/K7b's device-memory route at 20 coarse levels (levels 20,
    pyr_scale 0.9): K11's level images in runs of MAX_LEVELS (12 + 8),
    then kh_polyexp_mem in runs of MEM_MAX_LEVELS (16 + 4), each call
    with its run's levels in plan order; the wrapper counts the four."""
    calls = _record_mem(monkeypatch)
    imgs = torch.zeros(1, 600, 800)
    outs, launches = li._launch(imgs, 20, 0.9, 101, 20.2, torch.bfloat16)
    plan = li.fused_plan(600, 800, 20, 0.9, 0, 1, li.IMG_SPLIT_MAX)
    assert len(plan.levels) == len(outs) == 20
    assert [c[0] for c in calls] == ["kh_level_images_batch"] * 2 \
        + ["kh_polyexp_mem"] * 2 and launches == 4
    shapes = [(lv.lh, lv.lw) for lv in plan.levels]
    assert calls[2][2][1] == shapes[:16] and calls[3][2][1] == shapes[16:]
    assert [c[1][1] for c in calls[2:]] == [16, 4]
    assert [p[1] for c in calls[2:] for p in c[2][0]] == \
        [o.data_ptr() for o in outs]


_C_TYPES = {"const void*": _build.P, "void*": _build.P, "int": _build.I,
            "long long": _build.L, "const unsigned long long*": _build.P,
            "const int*": _build.P}


def _c_signature(source, name):
    src = (CSRC / source).read_text()
    args = re.search(rf"KH_API int {name}\(([^)]*)\)", src).group(1)
    return [_C_TYPES[re.sub(r"\s+\w+$", "", a.strip())]
            for a in args.split(",")]


def test_device_memory_route_calls_the_c_interface_as_declared(
        monkeypatch):
    """The device-memory route's two C entry points are called with the
    argument types of their C signatures (csrc/polyexp.cu's
    kh_polyexp_mem, csrc/level_image.cu's kh_level_images_batch), one
    argument for each; the wrapper's MEM_R and MEM_MAX_LEVELS are the
    kernel's constants."""
    calls = []

    def function(fname, *argtypes):
        def fn(*args):
            calls.append((fname, argtypes, args))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    li._launch(torch.zeros(2, 70, 100), 3, 0.5, 101, 20.2, torch.float32)
    seen = set()
    for fname, argtypes, args in calls:
        source = "polyexp.cu" if fname == "kh_polyexp_mem" else \
            "level_image.cu"
        assert list(argtypes) == _c_signature(source, fname), fname
        assert len(args) == len(argtypes)
        seen.add(fname)
    assert seen == {"kh_polyexp_mem", "kh_level_images_batch"}
    src = (CSRC / "polyexp.cu").read_text()
    for name, value in (("kMemR", pe.MEM_R),
                        ("kMemMaxLevels", pe.MEM_MAX_LEVELS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1)) == value, name


@pytest.mark.parametrize("n", (53, 101, 257))
def test_polyexp_past_the_limit_matches_pallas(n, rng):
    """K3's plain version past POLY_N_MAX on a 48x64 frame, 2n + 1 taps
    over many more rows and columns than the frame has (every tap past
    the edge is the replicate border), poly_sigma 0.2 n, against the
    Pallas kernel in interpret mode: < 1e-3."""
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    sg = 0.2 * n
    ref = reference(f"fault_poly.polyexp.{n}",
                    lambda: pe_pl(jnp.asarray(img), n, sg, interpret=True),
                    config={"n": n, "sigma": sg}, inputs=(img,))
    got = pe.poly_expansion_planar(torch.from_numpy(img), n, sg)
    assert np.abs(got.numpy() - ref).max() < 1e-3
    assert np.abs(ref).max() > 0.1


@pytest.mark.parametrize("n", (53, 101, 257))
def test_poly_n_past_the_limit_flow_matches_reference(n):
    """api.flow on the CPU at poly_n 53, 101 and 257 (past POLY_N_MAX,
    which the port refused until the device-memory route; poly_sigma 0.2
    n; 3 levels, fast warp 8) on a 128x128 pair against the reference's
    Farneback in interpret mode: < 1e-3 px, as the other F4 cases."""
    a, b, _ = translating_pair(height=128, width=128, shift=(2.0, -1.5),
                               seed=0)
    kw = dict(levels=3, poly_n=n, poly_sigma=0.2 * n, fast_warp=8)
    pipeline.check_slice(RunConfig(flow=TFlowConfig(**kw)))
    ref = farneback_interpret(f"fault_poly.farneback.{n}", a, b,
                              FlowConfig(**kw))
    got = api.flow(a, b, TFlowConfig(**kw), device="cpu")
    assert got.shape == ref.shape == (128, 128, 2)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < 1e-3


@pytest.mark.parametrize("n", (9, 11, 13))
def test_wide_polyexp_matches_pallas(n, rng):
    """K3's plain version at n = 9, 11, 13 on a 100x130 frame against the
    Pallas kernel in interpret mode: < 1e-3."""
    img = rng.uniform(0, 255, (100, 130)).astype(np.float32)
    ref = np.asarray(pe_pl(jnp.asarray(img), n, SIGMA[n], interpret=True))
    got = pe.poly_expansion_planar(torch.from_numpy(img), n, SIGMA[n])
    assert np.abs(got.numpy() - ref).max() < 1e-3


def test_wide_poly_n_flow_matches_reference():
    """The F4 setting end to end: Farneback at poly_n 11 (3 levels, fast
    warp 8) against the reference's impl="pallas" in interpret mode:
    < 1e-3 px."""
    a, b, _ = translating_pair(height=96, width=128, shift=(2.0, -1.5),
                               seed=0)
    kw = dict(levels=3, poly_n=11, poly_sigma=SIGMA[11], fast_warp=8)
    ref = farneback_interpret("fault_poly.farneback.11", a, b,
                              FlowConfig(**kw))
    got = TFB.farneback(torch.from_numpy(a).float(),
                        torch.from_numpy(b).float(), TFlowConfig(**kw))
    assert np.abs(got.numpy() - ref).max() < 1e-3
