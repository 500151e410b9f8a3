"""K13 (flow_iters_pipelined, FlowConfig.fi_pipeline) and path AP, the
headline graph with fi_pipeline=True, against the JAX reference (Pallas
in interpret mode on the CPU; path AP at f32 planes on the reference's
plain XLA route, since test_k13_route_flow_matches_reference holds K13's
route in interpret mode at f32 and path AP at bf16 holds the path there:
a reference jit is mostly compile time, about half of it at XLA).

On the CPU the wrapper runs `flow_iters_pipelined_plain`, so these tests
pin the arithmetic that the CUDA kernel is held to on the card
(chip_smoke.py compares it there with n_iters K2 launches, bit for bit,
and with the plain version)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu import pipeline as jp
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu.kernels.flow_iter_pallas import (
    flow_iters_pipelined as fip_pl, prep_planes)
from kalman_hydra_tpu.ops.color import grayscale_u8 as j_gray
from kalman_hydra_tpu.ops.farneback import (
    farneback_from_pyramids as j_from_pyr, polyexp_pyramid as j_pyr)
from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.config import RunConfig as TRunConfig
from kalman_hydra_tpu_torch.kernels import flow_iter, flow_iters_pipelined
from kalman_hydra_tpu_torch.kernels.flow_iter import (
    flow_iter_plain, flow_iters_pipelined_plain)
from kalman_hydra_tpu_torch.ops import farneback as tfb


def _np(a):
    a = np.array(a)                     # a writable copy
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("n_iters,gaussian,dtype", [
    (2, False, "float32"),
    (3, False, "float32"),
    (3, False, "bfloat16"),
    (2, True, "float32"),
])
def test_flow_iters_pipelined_matches_pallas(n_iters, gaussian, dtype, rng):
    """K13 at 70x90 (the reference's own test shape: its last band has
    rows past the image), tile_h 16, D=8, flows beyond the clamp:
    < 1e-5, as the reference holds its kernel to n sequential
    flow_iter."""
    h, w = 70, 90
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    R0 = jnp.asarray(rng.normal(size=(5, h, w)).astype(np.float32)).astype(
        jdt)
    R1 = jnp.asarray(rng.normal(size=(5, h, w)).astype(np.float32)).astype(
        jdt)
    fl = rng.uniform(-5, 5, (2, h, w)).astype(np.float32)
    ref = np.asarray(fip_pl(prep_planes(R0, 15, 8, tile_h=16),
                            prep_planes(R1, 15, 8, tile_h=16),
                            jnp.asarray(fl), 15, 8, n_iters, img_hw=(h, w),
                            gaussian=gaussian, tile_h=16, interpret=True))
    R0t = torch.from_numpy(_np(R0)).to(getattr(torch, dtype))
    R1t = torch.from_numpy(_np(R1)).to(getattr(torch, dtype))
    got = flow_iters_pipelined(R0t, R1t, torch.from_numpy(fl), 15, 8,
                               n_iters, gaussian)
    assert got.shape == (2, h, w) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() < 1e-5


def test_flow_iters_pipelined_plain_is_iterated_flow_iter(rng):
    """The plain version is n_iters applications of K2's plain version,
    bit for bit, and a single iteration is refused as the reference
    refuses it."""
    R0, R1 = (torch.from_numpy(rng.normal(size=(5, 20, 30)).astype(
        np.float32)) for _ in range(2))
    fl = torch.from_numpy(rng.uniform(-3, 3, (2, 20, 30)).astype(np.float32))
    want = fl
    for _ in range(3):
        want = flow_iter_plain(R0, R1, want, 15, 8)
    assert torch.equal(flow_iters_pipelined_plain(R0, R1, fl, 15, 8, 3),
                       want)
    with pytest.raises(ValueError, match="n_iters >= 2"):
        flow_iters_pipelined(R0, R1, fl, 15, 8, 1)


def pipe_config(bf16: bool, impl: str = "pallas") -> RunConfig:
    """Path AP's settings (the headline graph with fi_pipeline) at
    fi_level_fused=False, so that K13 runs on every level: with the
    whole-level kernel on, every level of a clip this small passes K5's
    gate on both sides and K13 would never run. 128x160 (3 levels),
    K=32; the reference in interpret mode, or on its XLA route at
    impl="xla"."""
    return RunConfig(
        flow=FlowConfig(levels=3, fast_warp=8, bf16_poly=bf16,
                        fi_level_fused=False, fi_pipeline=True),
        ekf=EkfConfig(state_dim=6),
        tracks=TrackConfig(num_tracks=32, reinit_every=2),
        impl=impl, pallas_interpret=True)


@pytest.fixture(scope="module")
def clip():
    frames, _ = moving_blob_clip(num_frames=5, height=128, width=160,
                                 num_points=8, seed=0)
    return frames


def test_k13_route_flow_matches_reference(clip, monkeypatch):
    """farneback_from_pyramids at fi_pipeline=True, fi_level_fused=False
    runs one K13 call per level (and no K2) and gives the reference's
    flow (< 1e-5, the kernel's bar), from the reference's own planes."""
    cfg = pipe_config(False)
    g0, g1 = (j_gray(jnp.asarray(clip[i])) for i in (0, 1))
    pa, pb = (j_pyr(g, cfg.flow, impl="pallas", interpret=True)
              for g in (g0, g1))
    ref = np.asarray(j_from_pyr(pa, pb, cfg.flow, impl="pallas",
                                interpret=True))
    calls = []

    def count(fn):
        def run(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return run
    monkeypatch.setattr(tfb, "flow_iters_pipelined",
                        count(flow_iters_pipelined))
    monkeypatch.setattr(tfb, "flow_iter", count(flow_iter))
    tcfg = TRunConfig.from_json(cfg.to_json()).flow
    got = tfb.farneback_from_pyramids(
        tuple(torch.from_numpy(_np(a)) for a in pa),
        tuple(torch.from_numpy(_np(a)) for a in pb), tcfg).numpy()
    assert calls == ["flow_iters_pipelined"] * 3
    assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("bf16", [False, True])
def test_path_ap_matches_reference(clip, bf16):
    """Path AP: track_arrays with fi_pipeline on both sides, K13 on every
    level (the reference in interpret mode at bf16 planes, on its XLA
    route at f32); positions < 1e-3 px, alive and track_id identical."""
    cfg = pipe_config(bf16, "pallas" if bf16 else "xla")
    ref = jax.device_get(jax.jit(jp.track_arrays, static_argnames="cfg")(
        jnp.asarray(clip), cfg))
    got = {k: v.numpy() for k, v in tp.track_arrays(
        torch.from_numpy(clip), TRunConfig.from_json(cfg.to_json())).items()}
    assert got["pos"].shape == (5, 32, 2)
    assert np.abs(got["pos"] - ref["pos"]).max() < 1e-3
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_array_equal(got["track_id"], ref["track_id"])
    assert np.abs(got["nis"] - ref["nis"]).max() < 1e-3
    assert got["alive"][-1].all()


def test_fi_pipeline_needs_two_iterations_and_skips_k5_levels(clip):
    """With iterations=1 (the temporal warm-1 stage) fi_pipeline takes
    K2, as the reference does; with fi_level_fused the gated levels keep
    K5: the port's track_arrays equals the same config without
    fi_pipeline bit for bit in both cases (on the CPU K5's and K13's
    plain versions are iterated K2 ones)."""
    base = TRunConfig.from_json(pipe_config(True).to_json())
    x = torch.from_numpy(clip)
    for flow in (dataclasses.replace(base.flow, iterations=1),
                 dataclasses.replace(base.flow, fi_level_fused=True)):
        a = tp.track_arrays(x, base.replace(flow=flow))
        b = tp.track_arrays(x, base.replace(flow=dataclasses.replace(
            flow, fi_pipeline=False)))
        for k in a:
            assert torch.equal(a[k], b[k]), k
