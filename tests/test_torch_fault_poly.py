"""poly_n past 7: the generic builds of K3/K7a and K4/K7b (the taps in
shared memory, copied from device memory; the tile's halo and rows sized
from n) planned through their wrappers on CPU tensors with the library
call recorded, the limit past which pipeline.check_slice refuses, and the
expansion and the Farneback setting against the JAX package (Pallas in
interpret mode) on the CPU. The kernels run on the card, in
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
from kalman_hydra_tpu.ops import farneback as FB
from kalman_hydra_tpu_torch import api, pipeline
from kalman_hydra_tpu_torch.config import FlowConfig as TFlowConfig
from kalman_hydra_tpu_torch.config import RunConfig
from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.kernels import level_image as li
from kalman_hydra_tpu_torch.kernels import polyexp as pe
from kalman_hydra_tpu_torch.ops import farneback as TFB

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


def test_check_slice_refuses_poly_n_past_the_limit():
    """Every odd poly_n up to POLY_N_MAX runs; the next is refused before
    any launch, naming ROADMAP's F4 (pipeline.check_slice, through
    api.flow too); the Lucas-Kanade methods read no poly_n."""
    big = pe.POLY_N_MAX + 2
    for n in (9, 13, pe.POLY_N_MAX):
        pipeline.check_slice(RunConfig(flow=TFlowConfig(poly_n=n)))
    with pytest.raises(NotImplementedError, match="F4"):
        pipeline.check_slice(RunConfig(flow=TFlowConfig(poly_n=big)))
    frame = np.zeros((40, 48), np.uint8)
    with pytest.raises(NotImplementedError, match="F4"):
        api.flow(frame, frame, TFlowConfig(poly_n=big), device="cpu")
    pipeline.check_slice(RunConfig(flow=TFlowConfig(method="lk_sparse",
                                                    poly_n=big)))


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
    ref = np.asarray(FB.farneback(jnp.asarray(a), jnp.asarray(b),
                                  FlowConfig(**kw), impl="pallas",
                                  interpret=True))
    got = TFB.farneback(torch.from_numpy(a).float(),
                        torch.from_numpy(b).float(), TFlowConfig(**kw))
    assert np.abs(got.numpy() - ref).max() < 1e-3
