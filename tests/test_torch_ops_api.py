"""The reference's public single-level ops (docs/API.md, "Vision ops")
under their names in the port, against the JAX functions on identical
NumPy inputs, on the CPU: ops.farneback's poly_expansion (H, W, 5) and
poly_expansion_p (5, H, W) (K3's plain version here), update_matrices(_p)
at fast_warp 0 and 4, update_flow(_p) with a box and a Gaussian window;
ops.pyramid.pyr_down (K9's plain version here); ops.filters.box_blur2d.
Bars (PARITY.md): polyexp, pyr_down and box_blur2d < 1e-3, the update
planes < 1e-4, the flows < 1e-4 px."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalman_hydra_tpu.io.synthetic import translating_pair
from kalman_hydra_tpu.ops import farneback as jfb
from kalman_hydra_tpu.ops import filters as jfilt
from kalman_hydra_tpu.ops import pyramid as jpyr
from kalman_hydra_tpu_torch.ops import farneback as tfb
from kalman_hydra_tpu_torch.ops import filters as tfilt
from kalman_hydra_tpu_torch.ops import pyramid as tpyr
import torch_threads  # noqa: F401  (one torch thread a worker)

SHAPES = ((48, 64), (37, 53))
# the reference's ops, jitted: one compile each instead of one an op
J_POLY_P = jax.jit(jfb.poly_expansion_p, static_argnums=(1, 2))
J_POLY = jax.jit(jfb.poly_expansion, static_argnums=(1, 2))
J_UPDATE_P = jax.jit(jfb.update_matrices_p, static_argnums=3)
J_UPDATE = jax.jit(jfb.update_matrices, static_argnums=3)
J_FLOW_P = jax.jit(jfb.update_flow_p, static_argnums=(1, 2))
J_FLOW = jax.jit(jfb.update_flow, static_argnums=(1, 2))
J_PYR = jax.jit(jpyr.pyr_down)
J_BOX = jax.jit(jfilt.box_blur2d, static_argnums=1,
                static_argnames="normalize")


def _np(x):
    return np.array(x)     # a writable copy


def _pair(shape):
    """A textured frame pair shifted by (1.5, -1) px, u8-scale f32."""
    a, b, _ = translating_pair(height=shape[0], width=shape[1],
                               shift=(1.5, -1.0), seed=3)
    return a.astype(np.float32), b.astype(np.float32)


def _planes_and_flow(shape, rng):
    """Both frames' (5, H, W) planes at poly_n 5 (the reference's) and a
    smooth (2, H, W) flow of a few px."""
    a, b = _pair(shape)
    R0 = _np(J_POLY_P(jnp.asarray(a), 5, 1.1))
    R1 = _np(J_POLY_P(jnp.asarray(b), 5, 1.1))
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.stack([1.5 + 0.8 * np.sin(xx / 9.0 + 0.3 * rng.random()),
                     -1.0 + 0.6 * np.cos(yy / 7.0)]).astype(np.float32)
    return R0, R1, flow


@pytest.mark.parametrize("shape", SHAPES)
def test_poly_expansion_matches_reference(shape):
    """poly_expansion (planes last) and poly_expansion_p (planes first)
    at poly_n 5, and a stack of two frames through the batched route:
    < 1e-3."""
    n, sigma = 5, 1.1
    a, b = _pair(shape)
    ref = _np(J_POLY(jnp.asarray(a), n, sigma))
    ref_p = _np(J_POLY_P(jnp.asarray(a), n, sigma))
    got = tfb.poly_expansion(torch.from_numpy(a), n, sigma).numpy()
    got_p = tfb.poly_expansion_p(torch.from_numpy(a), n, sigma).numpy()
    assert got.shape == ref.shape == (*shape, 5)
    assert got_p.shape == ref_p.shape == (5, *shape)
    assert np.abs(got - ref).max() < 1e-3
    assert np.abs(got_p - ref_p).max() < 1e-3
    stack = tfb.poly_expansion_p(torch.from_numpy(np.stack([a, b])), n,
                                 sigma).numpy()
    assert np.array_equal(stack[0], got_p)
    assert np.abs(ref_p).max() > 1.0


@pytest.mark.parametrize("fast_warp", (0, 4))
@pytest.mark.parametrize("shape", SHAPES)
def test_update_matrices_matches_reference(shape, fast_warp, rng):
    """update_matrices_p on (5, H, W) planes and update_matrices on the
    same planes last, with the exact gather (fast_warp 0) and the
    select-sum warp (fast_warp 4), against the reference's jitted ops:
    < 1e-4 (the planes reach ~20)."""
    R0, R1, flow = _planes_and_flow(shape, rng)
    ref_p = _np(J_UPDATE_P(jnp.asarray(R0), jnp.asarray(R1),
                           jnp.asarray(flow), fast_warp))
    ref = _np(J_UPDATE(jnp.asarray(R0.transpose(1, 2, 0)),
                       jnp.asarray(R1.transpose(1, 2, 0)),
                       jnp.asarray(flow.transpose(1, 2, 0)), fast_warp))
    got_p = tfb.update_matrices_p(torch.from_numpy(R0), torch.from_numpy(R1),
                                  torch.from_numpy(flow), fast_warp).numpy()
    got = tfb.update_matrices(
        torch.from_numpy(R0.transpose(1, 2, 0)),
        torch.from_numpy(R1.transpose(1, 2, 0)),
        torch.from_numpy(flow.transpose(1, 2, 0)), fast_warp).numpy()
    assert got_p.shape == ref_p.shape == (5, *shape)
    assert got.shape == ref.shape == (*shape, 5)
    assert np.abs(got_p - ref_p).max() < 1e-4
    assert np.abs(got - ref).max() < 1e-4
    assert np.abs(ref - ref_p.transpose(1, 2, 0)).max() < 1e-4
    assert np.abs(ref_p).max() > 1.0


@pytest.mark.parametrize("gaussian", (False, True))
@pytest.mark.parametrize("shape", SHAPES)
def test_update_flow_matches_reference(shape, gaussian, rng):
    """update_flow_p and update_flow (winsize 15) on the normal
    equations of a frame pair: < 1e-4 px."""
    R0, R1, flow = _planes_and_flow(shape, rng)
    M = _np(J_UPDATE_P(jnp.asarray(R0), jnp.asarray(R1), jnp.asarray(flow),
                       0))
    ref_p = _np(J_FLOW_P(jnp.asarray(M), 15, gaussian))
    ref = _np(J_FLOW(jnp.asarray(M.transpose(1, 2, 0)), 15, gaussian))
    got_p = tfb.update_flow_p(torch.from_numpy(M), 15, gaussian).numpy()
    got = tfb.update_flow(torch.from_numpy(M.transpose(1, 2, 0).copy()), 15,
                          gaussian).numpy()
    assert got_p.shape == ref_p.shape == (2, *shape)
    assert got.shape == ref.shape == (*shape, 2)
    assert np.abs(got_p - ref_p).max() < 1e-4
    assert np.abs(got - ref).max() < 1e-4
    assert np.abs(ref_p).max() > 0.5


@pytest.mark.parametrize("shape", SHAPES)
def test_pyr_down_matches_reference(shape, rng):
    """ops.pyramid.pyr_down on one (H, W) image and on a (2, H, W)
    stack: < 1e-3."""
    imgs = (rng.random((2, *shape)) * 255).astype(np.float32)
    ref = _np(J_PYR(jnp.asarray(imgs)))
    got = tpyr.pyr_down(torch.from_numpy(imgs)).numpy()
    one = tpyr.pyr_down(torch.from_numpy(imgs[0])).numpy()
    assert got.shape == ref.shape == (2, (shape[0] + 1) // 2,
                                      (shape[1] + 1) // 2)
    assert np.abs(got - ref).max() < 1e-3
    assert np.array_equal(one, got[0])


@pytest.mark.parametrize("size, normalize", ((3, False), (15, True),
                                             (21, True)))
@pytest.mark.parametrize("shape", SHAPES)
def test_box_blur2d_matches_reference(shape, size, normalize, rng):
    """ops.filters.box_blur2d (replicate border) at sizes 3 (sums), 15
    (the factored box) and 21 (the reference's cumulative sums): <
    1e-3."""
    img = (rng.random(shape) * 255).astype(np.float32)
    ref = _np(J_BOX(jnp.asarray(img), size, normalize=normalize))
    got = tfilt.box_blur2d(torch.from_numpy(img), size,
                           normalize=normalize).numpy()
    assert got.shape == ref.shape == shape
    assert np.abs(got - ref).max() < 1e-3
