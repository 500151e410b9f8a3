"""The exact-warp Farneback of the reference's default configuration
against the JAX reference (Pallas in interpret mode on the CPU): K8
(flow_update, the exact gather included) and the gather alone, K11 (the level images alone), the
Farneback levels at fast_warp=0 with and without a warm start, and the
public `api.flow` (Farneback, and dense LK).

On the CPU each wrapper runs its plain version, so these tests pin the
arithmetic that the CUDA kernels are held to on the card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu import api as japi
from kalman_hydra_tpu.config import FlowConfig
from kalman_hydra_tpu.io.synthetic import translating_pair
from kalman_hydra_tpu.kernels.flow_update_pallas import (
    flow_update as flow_update_pl)
from kalman_hydra_tpu.kernels.level_image_pallas import (
    farneback_images_pallas)
from kalman_hydra_tpu.ops import farneback as FB
from kalman_hydra_tpu_torch import api
from kalman_hydra_tpu_torch.config import FlowConfig as TFlowConfig
from kalman_hydra_tpu_torch.kernels import coarse_level_images, flow_update
from kalman_hydra_tpu_torch.kernels.flow_update import flow_update_plain
from kalman_hydra_tpu_torch.kernels.level_image import \
    coarse_level_images_plain
from kalman_hydra_tpu_torch.ops import farneback as TFB
from kalman_hydra_tpu_torch.ops.pyramid import gaussian_blur_level
from kalman_hydra_tpu_torch.ops.warp import warp_poly_planar


def _np(a):
    a = np.array(a)                     # a writable copy
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a, dtype=torch.float32):
    return torch.from_numpy(_np(a)).to(dtype)


def _planes(rng, h, w):
    a = rng.uniform(0, 255, (h, w)).astype(np.float32)
    return FB.poly_expansion_p(jnp.asarray(a), 5, 1.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gaussian", [False, True])
def test_flow_update_matches_pallas(gaussian, dtype, rng):
    """K8's plain version vs the Pallas kernel at 96x128, f32 and bf16
    planes, a random +-2 px flow: the port gets the unwarped R1 (the
    gather is in K8), the Pallas kernel gets _warp_poly_planar(R1, flow)
    in f32, as the reference's Farneback calls it
    (ops/farneback.py:521-528): < 1e-4."""
    h, w = 96, 128
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    R0, R1 = _planes(rng, h, w).astype(jdt), _planes(rng, h, w).astype(jdt)
    flow = jnp.asarray(rng.uniform(-2, 2, (2, h, w)).astype(np.float32))
    R1w = FB._warp_poly_planar(R1, flow).astype(jnp.float32)
    ref = np.asarray(flow_update_pl(R0.astype(jnp.float32), R1w, flow, 15,
                                    gaussian, interpret=True))
    tdt = getattr(torch, dtype)
    args = (_t(R0, tdt), _t(R1, tdt), _t(flow))
    got = flow_update(*args, 15, gaussian)
    assert got.shape == (2, h, w) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() < 1e-4
    # the wrapper on a CPU tensor is exactly its plain version
    assert torch.equal(got, flow_update_plain(*args, 15, gaussian))


def test_flow_update_refuses_bf16():
    """K8 takes bf16 or f32 planes, both of one dtype, and an f32 flow:
    bf16 against f32 planes, a bf16 flow, and planes or a flow of the
    wrong shape (or a level under 2x2, which the gather cannot take) are
    refused on the CPU as on the card."""
    R = torch.zeros(5, 16, 16)
    fl = torch.zeros(2, 16, 16)
    with pytest.raises(TypeError, match="all bf16 or all f32"):
        flow_update(R.to(torch.bfloat16), R, fl, 15)
    with pytest.raises(TypeError, match="all bf16 or all f32"):
        flow_update(R, R.to(torch.bfloat16), fl, 15)
    with pytest.raises(TypeError, match="flow f32"):
        flow_update(R, R, fl.to(torch.bfloat16), 15)
    for a, b, f in ((R[:4], R[:4], fl), (R, R[:, :15], fl),
                    (R, R, fl[:, :15]), (R, R, fl[:1])):
        with pytest.raises(ValueError, match="planes"):
            flow_update(a, b, f, 15)
    with pytest.raises(ValueError, match="2x2"):
        flow_update(R[:, :1], R[:, :1], fl[:, :1], 15)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_warp_matches_reference(dtype, rng):
    """The exact gather vs the reference's _warp_poly_planar, with flows
    of up to 40 px that leave the image on every side (the clamps of the
    sample point and of its corner): < 1e-5; bf16 planes come out f32."""
    h, w = 40, 56
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    R1 = _planes(rng, h, w).astype(jdt)
    flow = rng.uniform(-40, 40, (2, h, w)).astype(np.float32)
    flow[:, :4] = np.array([0.0, h - 1.0])[:, None, None]      # onto the edge
    ref = np.asarray(FB._warp_poly_planar(R1, jnp.asarray(flow)))
    got = warp_poly_planar(_t(R1, getattr(torch, dtype)),
                           torch.from_numpy(flow))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() < 1e-5


@pytest.mark.parametrize("shape,levels,scale",
                         [((96, 128), 3, 0.5), ((37, 53), 2, 0.5),
                          ((128, 128), 4, 0.5), ((128, 96), 3, 0.75),
                          ((100, 100), 2, 0.6)])
def test_level_images_match_pallas(shape, levels, scale, rng):
    """K11's plain version (and level 0's plain blur) vs the Pallas
    farneback_images_pallas at the reference's own shapes: < 1e-2, the
    reference's bar; measured < 1e-4."""
    img = rng.uniform(0, 255, shape).astype(np.float32)
    ref = [np.asarray(a) for a in farneback_images_pallas(
        jnp.asarray(img), levels, scale, interpret=True)]
    x = torch.from_numpy(img)
    got = coarse_level_images(x, levels, scale)
    got.append(gaussian_blur_level(x, TFlowConfig(levels=levels,
                                                  pyr_scale=scale), k=0))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        err = np.abs(g.numpy() - r).max()
        assert err < 1e-2
        assert err < 1e-4                   # the measured agreement
    assert all(torch.equal(a, b) for a, b in zip(
        got[:-1], coarse_level_images_plain(x, levels, scale)))


def _pair():
    a, b, _ = translating_pair(height=96, width=128, shift=(2.0, -1.0))
    return a, b


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_farneback_exact_warp_matches_pallas(bf16, warm):
    """farneback_from_pyramids at fast_warp=0 (every iteration: the exact
    gather, then K8) vs the reference's impl="pallas" in interpret mode,
    f32 and bf16 planes, cold and warm-started from a flow0 field: < 1e-3
    px. The bf16 case is the reference's own regression
    (tests/unit/test_kernels.py::
    test_farneback_pallas_bf16_exact_warp_matches_xla)."""
    a, b = _pair()
    cfg = FlowConfig(levels=3, bf16_poly=bf16)
    flow0 = None
    if warm:
        flow0 = np.zeros(a.shape + (2,), np.float32)
        flow0[..., 0], flow0[..., 1] = 1.5, -0.5
    ref = np.asarray(FB.farneback(
        jnp.asarray(a), jnp.asarray(b), cfg,
        flow0=None if flow0 is None else jnp.asarray(flow0),
        impl="pallas", interpret=True))
    got = TFB.farneback(torch.from_numpy(a).float(),
                        torch.from_numpy(b).float(),
                        TFlowConfig(levels=3, bf16_poly=bf16),
                        None if flow0 is None else torch.from_numpy(flow0))
    assert got.shape == ref.shape == a.shape + (2,)
    assert np.abs(got.numpy() - ref).max() < 1e-3
    # and the flow recovers the translation away from the borders
    assert np.abs(np.median(got.numpy()[20:-20, 20:-20], axis=(0, 1))
                  - [2.0, -1.0]).max() < 0.1


_FLOW_CASES = {
    "uint8": lambda a, b: (a, b, None),
    "unit_float": lambda a, b: (a.astype(np.float64) / 255.0,
                                b.astype(np.float64) / 255.0, None),
    "initial": lambda a, b: (a, b, np.full(a.shape + (2,), 1.0, np.float32)),
}


@pytest.mark.parametrize("case", sorted(_FLOW_CASES))
def test_api_flow_matches_reference(case):
    """api.flow with no config (FlowConfig(): the exact warp, 5 levels
    that the 96x128 plan clamps to 3) vs the reference's api.flow with no
    config: uint8 frames, [0, 1] float frames (rescaled to 0..255) and an
    `initial` warm start: < 1e-3 px."""
    a, b, init = _FLOW_CASES[case](*_pair())
    ref = japi.flow(a, b, initial=init)
    got = api.flow(a, b, initial=init, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-3


def test_api_flow_lk_raises():
    """Dense LK through api.flow (inside the slice since the port's LK
    slice): uint8 frames, 3 levels, against the reference's api.flow,
    < 1e-3 px; an `initial` flow raises the reference's ValueError (a
    Farneback feature), and a sparse method is not a dense flow, as in
    the reference."""
    a, b = _pair()
    cfg = FlowConfig(method="lk_dense", levels=3)
    ref = japi.flow(a, b, cfg)
    got = api.flow(a, b, TFlowConfig(method="lk_dense", levels=3),
                   device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-3
    init = np.zeros(a.shape + (2,), np.float32)
    msgs = []
    for fn, c in ((japi.flow, cfg), (api.flow, TFlowConfig(
            method="lk_dense"))):
        with pytest.raises(ValueError, match="Farneback feature") as e:
            fn(a, b, c, initial=init)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="dense method"):
        api.flow(a, b, TFlowConfig(method="lk_sparse"), device="cpu")
