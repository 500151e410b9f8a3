"""The port's plain ops and models against the JAX reference's, on
identical NumPy inputs: colour, filters, pyramid, warp, corners, Kalman
filter, lifecycle."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu.config import EkfConfig, TrackConfig
from kalman_hydra_tpu.models import ekf as jekf
from kalman_hydra_tpu.models import lifecycle as jlife
from kalman_hydra_tpu.ops import color as jcolor
from kalman_hydra_tpu.ops import features as jfeat
from kalman_hydra_tpu.ops import filters as jfilt
from kalman_hydra_tpu.ops import pyramid as jpyr
from kalman_hydra_tpu.ops import warp as jwarp
from kalman_hydra_tpu_torch.models import ekf as tekf
from kalman_hydra_tpu_torch.models import lifecycle as tlife
from kalman_hydra_tpu_torch.ops import color as tcolor
from kalman_hydra_tpu_torch.ops import features as tfeat
from kalman_hydra_tpu_torch.ops import filters as tfilt
from kalman_hydra_tpu_torch.ops import pyramid as tpyr
from kalman_hydra_tpu_torch.ops import warp as twarp


def _t(a):
    return torch.from_numpy(np.array(a))


def test_grayscale_bit_exact(rng):
    frame = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    ref = np.asarray(jcolor.grayscale_u8(jnp.asarray(frame)))
    got = tcolor.grayscale_u8(_t(frame)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (5, 0.0), (9, 1.5),
                                         (79, 15.5)])
def test_gaussian_kernel_and_blur(ksize, sigma, rng):
    np.testing.assert_array_equal(tfilt.gaussian_kernel(ksize, sigma),
                                  jfilt.gaussian_kernel(ksize, sigma))
    img = rng.uniform(0, 255, (40, 90)).astype(np.float32)
    ref = np.asarray(jfilt.gaussian_blur(jnp.asarray(img), ksize, sigma))
    got = tfilt.gaussian_blur(_t(img), ksize, sigma).numpy()
    assert np.abs(got - ref).max() < 1e-3


@pytest.mark.parametrize("size,border", [(3, "reflect101"),
                                         (15, "replicate"),
                                         (13, "replicate")])
def test_box_filter(size, border, rng):
    x = rng.normal(size=(33, 47)).astype(np.float32)
    for axis in (0, 1):
        ref = np.asarray(jfilt.box_filter(jnp.asarray(x), size, axis=axis,
                                          border=border))
        got = tfilt.box_filter(_t(x), size, dim=axis, border=border)
        assert np.abs(got.numpy() - ref).max() < 1e-5


@pytest.mark.parametrize("shape,levels", [((128, 160), 3), ((1080, 1920), 5),
                                          ((37, 250), 5)])
def test_farneback_levels_plan(shape, levels):
    assert tpyr.farneback_levels(*shape, levels, 0.5) == \
        jpyr.farneback_levels(*shape, levels, 0.5)


def test_resize_and_level_images(rng):
    img = rng.uniform(0, 255, (96, 130)).astype(np.float32)
    ref = np.asarray(jpyr.resize_linear(jnp.asarray(img), 47, 66))
    assert np.abs(tpyr.resize_linear(_t(img), 47, 66).numpy()
                  - ref).max() < 1e-4
    refs = jpyr.farneback_images(jnp.asarray(img), 3, 0.5)
    gots = tpyr.farneback_images(_t(img), 3, 0.5)
    assert len(refs) == len(gots) == 2          # 96 px: one coarse level
    for r, g in zip(refs, gots):
        assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-3


def test_sample_flow(rng):
    flow = rng.normal(size=(40, 50, 2)).astype(np.float32)
    pts = rng.uniform(-5, 60, (100, 2)).astype(np.float32)
    ref = np.asarray(jwarp.sample_flow(jnp.asarray(flow), jnp.asarray(pts)))
    got = twarp.sample_flow(_t(flow), _t(pts)).numpy()
    assert np.abs(got - ref).max() < 1e-5


def test_corner_response_and_pool(blob_clip):
    frames, _ = blob_clip
    gray = np.asarray(jcolor.grayscale_u8(jnp.asarray(frames[0])))
    ref = np.asarray(jfeat.min_eig_response(jnp.asarray(gray)))
    got = tfeat.min_eig_response(_t(gray)).numpy()
    assert np.abs(got - ref).max() < 1e-5
    cfg = TrackConfig(num_tracks=64, corner_pool=300)
    for pool in (64, None):
        rp, rs = jfeat.corner_pool(jnp.asarray(gray), cfg, pool_size=pool)
        gp, gs = tfeat.corner_pool(_t(gray), cfg, pool_size=pool)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
        assert np.abs(gs.numpy() - np.asarray(rs)).max() < 1e-5


@pytest.mark.parametrize("state_dim", [4, 6])
def test_predict_update(state_dim, rng):
    cfg = EkfConfig(state_dim=state_dim)
    from kalman_hydra_tpu.models import dynamics as jdyn
    K, n = 50, state_dim
    F, Q, H = jdyn.transition(cfg), jdyn.process_noise(cfg), \
        jdyn.position_H(cfg)
    R = (cfg.r * np.eye(2)).astype(np.float32)
    x = rng.normal(size=(K, n)).astype(np.float32)
    A = rng.normal(size=(K, n, n)).astype(np.float32)
    P = (A @ A.transpose(0, 2, 1) + np.eye(n)).astype(np.float32)
    y = rng.normal(size=(K, 2)).astype(np.float32)
    rx, rP = jekf.predict(jnp.asarray(x), jnp.asarray(P), jnp.asarray(F),
                          jnp.asarray(Q))
    gx, gP = tekf.predict(_t(x), _t(P), _t(F), _t(Q))
    assert np.abs(gx.numpy() - np.asarray(rx)).max() < 1e-4
    assert np.abs(gP.numpy() - np.asarray(rP)).max() < 1e-4
    ref = jekf.update(rx, rP, jnp.asarray(y), jnp.asarray(H), jnp.asarray(R))
    got = tekf.update(gx, gP, _t(y), _t(H), _t(R))
    for r, g in zip(ref, got):
        assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-4


def test_lifecycle_gate_kill_reseed(rng):
    """Random pool with dead slots, gated tracks, escapees and tied corner
    scores: the reseed assignment (score order, ties by index) must be
    identical."""
    ecfg, tcfg = EkfConfig(state_dim=6), TrackConfig(min_distance=8.0)
    K, Pn = 40, 30
    x = np.zeros((K, 6), np.float32)
    x[:, 0:2] = rng.uniform(-5, 105, (K, 2))
    P = np.broadcast_to(np.eye(6, dtype=np.float32), (K, 6, 6)).copy()
    alive = rng.random(K) < 0.6
    misses = rng.integers(0, 6, K).astype(np.int32)
    tid = rng.integers(0, 3, K).astype(np.int32)
    nis = rng.uniform(0, 20, K).astype(np.float32)
    x_pred = x + 1.0
    pts = rng.uniform(0, 100, (Pn, 2)).astype(np.float32)
    score = np.round(rng.uniform(-0.2, 1, Pn), 1).astype(np.float32)

    js = jekf.TrackState(jnp.asarray(x), jnp.asarray(P), jnp.asarray(alive),
                         jnp.asarray(misses), jnp.asarray(tid))
    ts = tekf.TrackState(_t(x), _t(P), _t(alive), _t(misses), _t(tid))
    js = jlife.gate(js, jnp.asarray(x_pred), jnp.asarray(P),
                    jnp.asarray(nis), ecfg)
    ts = tlife.gate(ts, _t(x_pred), _t(P), _t(nis), ecfg)
    js = jlife.kill_lost(js, ecfg, 100, 100)
    ts = tlife.kill_lost(ts, ecfg, 100, 100)
    js = jlife.reseed(js, jnp.asarray(pts), jnp.asarray(score), ecfg, tcfg)
    ts = tlife.reseed(ts, _t(pts), _t(score), ecfg, tcfg)
    for f in ("x", "P", "alive", "misses", "track_id"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    assert (np.asarray(js.track_id) != tid).any()
