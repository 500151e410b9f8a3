"""The port's OpenCV/NumPy oracle (kalman_hydra_tpu_torch.ref) against the
JAX package's (kalman_hydra_tpu.ref), bit for bit on the CPU: the same
seeded NumPy inputs through both, every public function of ref.imgproc,
ref.ekf and ref.pipeline, equal arrays (np.array_equal), status and
alive identical. No JAX kernel runs here: both sides are cv2 and NumPy."""

import numpy as np
import pytest

from kalman_hydra_tpu import config as jconfig
from kalman_hydra_tpu.io.synthetic import moving_blob_clip, translating_pair
from kalman_hydra_tpu.ref import ekf as jekf
from kalman_hydra_tpu.ref import imgproc as jip
from kalman_hydra_tpu.ref import pipeline as jpl
from kalman_hydra_tpu_torch import config as tconfig
from kalman_hydra_tpu_torch.ref import ekf as tekf
from kalman_hydra_tpu_torch.ref import imgproc as tip
from kalman_hydra_tpu_torch.ref import pipeline as tpl


def _port(cfg):
    """A reference config as the port's, through its JSON."""
    if isinstance(cfg, jconfig.RunConfig):
        return tconfig.RunConfig.from_json(cfg.to_json())
    return getattr(tconfig, type(cfg).__name__)(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def pair():
    """A 64x80 uint8 pair related by a (2.5, -1.5) px shift."""
    a, b, _ = translating_pair(height=64, width=80, shift=(2.5, -1.5),
                               seed=5)
    return np.round(a).astype(np.uint8), np.round(b).astype(np.uint8)


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3)])
def test_grayscale(shape, rng):
    frame = rng.integers(0, 256, shape, dtype=np.uint8)
    _equal(tip.grayscale(frame), jip.grayscale(frame))


@pytest.mark.parametrize("shape", [(64, 80), (37, 53)])
def test_pyr_down_and_build_pyramid(shape, rng):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    _equal(tip.pyr_down(img), jip.pyr_down(img))
    got, ref = tip.build_pyramid(img, 4), jip.build_pyramid(img, 4)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        _equal(g, r)


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_farneback(pair, warm, gaussian, rng):
    """Box and Gaussian windows, cold and from an initial flow."""
    a, b = pair
    cfg = jconfig.FlowConfig(levels=3, gaussian_win=gaussian)
    flow0 = (rng.uniform(-2, 2, a.shape + (2,)).astype(np.float32)
             if warm else None)
    ref = jip.farneback(a, b, cfg, flow0)
    got = tip.farneback(a, b, _port(cfg), flow0)
    assert got.shape == (64, 80, 2)
    _equal(got, ref)


def test_lk_sparse(pair, rng):
    a, b = pair
    cfg = jconfig.FlowConfig(levels=3)
    pts = rng.uniform(-4, 84, (40, 2)).astype(np.float32)  # some off-frame
    rp, rs = jip.lk_sparse(a, b, pts, cfg)
    gp, gs = tip.lk_sparse(a, b, pts, _port(cfg))
    _equal(gp, rp)
    _equal(gs, rs)
    assert 0 < rs.sum() < len(pts)


def test_lk_dense(rng):
    a, b, _ = translating_pair(height=64, width=64, shift=(1.5, -1.0),
                               seed=6)
    cfg = jconfig.FlowConfig(levels=3)
    ref = jip.lk_dense(a, b, cfg, stride=4)
    got = tip.lk_dense(a, b, _port(cfg), stride=4)
    assert got.shape == (16, 16, 2)
    _equal(got, ref)


def test_good_features(pair):
    cfg = jconfig.TrackConfig(num_tracks=32)
    gray = pair[0].astype(np.float32)
    for n in (0, 7):
        ref = jip.good_features(gray, cfg, max_corners=n)
        _equal(tip.good_features(gray, _port(cfg), max_corners=n), ref)
    flat = np.zeros((32, 32), np.float32)              # no corner at all
    _equal(tip.good_features(flat, _port(cfg)), jip.good_features(flat, cfg))


def test_sample_flow(rng):
    flow = rng.normal(size=(24, 30, 2)).astype(np.float32)
    pts = rng.uniform(-3, 33, (50, 2)).astype(np.float32)
    _equal(tip.sample_flow(flow, pts), jip.sample_flow(flow, pts))


@pytest.mark.parametrize("n", [4, 6])
def test_ekf(n, rng):
    """transition, process_noise, init_state, predict, update,
    filter_tracks and rts_smooth."""
    cfg = jconfig.EkfConfig(state_dim=n)
    tcfg = _port(cfg)
    _equal(tekf.transition(tcfg), jekf.transition(cfg))
    _equal(tekf.process_noise(tcfg), jekf.process_noise(cfg))
    seeds = rng.uniform(0, 100, (5, 2))
    for g, r in zip(tekf.init_state(tcfg, seeds), jekf.init_state(cfg, seeds)):
        _equal(g, r)

    F, Q = jekf.transition(cfg), jekf.process_noise(cfg)
    A = rng.normal(size=(n, n))
    x, P = rng.normal(size=n), A @ A.T + np.eye(n)
    for g, r in zip(tekf.predict(x, P, F, Q), jekf.predict(x, P, F, Q)):
        _equal(g, r)
    H = np.zeros((2, n))
    H[0, 0] = H[1, 1] = 1.0
    z, R = rng.normal(size=2), 0.7 * np.eye(2)
    got, ref = tekf.update(x, P, z, H, R), jekf.update(x, P, z, H, R)
    _equal(got[0], ref[0])
    _equal(got[1], ref[1])
    assert got[2] == ref[2]

    x0, P0 = jekf.init_state(cfg, seeds)
    z_seq = seeds + np.cumsum(rng.normal(size=(6, 5, 2)), axis=0)
    ref = jekf.filter_tracks(cfg, z_seq, x0, P0)
    got = tekf.filter_tracks(tcfg, z_seq, x0, P0)
    assert set(got) == set(ref)
    for k in ref:
        _equal(got[k], ref[k])
    args = [ref[k] for k in ("x_filt", "P_filt", "x_pred", "P_pred")]
    for g, r in zip(tekf.rts_smooth(tcfg, *args), jekf.rts_smooth(cfg, *args)):
        _equal(g, r)


@pytest.mark.parametrize("method", ["farneback", "lk_sparse"])
def test_track_clip(method):
    """The CPU pipeline on a 96x96 clip from good_features seeds, and
    from given seeds; its timing dict gets both keys."""
    frames, truth = moving_blob_clip(num_frames=5, height=96, width=96,
                                     num_points=8, seed=0)
    cfg = jconfig.RunConfig(flow=jconfig.FlowConfig(method=method, levels=3),
                            tracks=jconfig.TrackConfig(num_tracks=24))
    for seeds in (None, truth.positions[0]):
        timing = {}
        ref = jpl.track_clip(frames, cfg, seeds)
        got = tpl.track_clip(frames, _port(cfg), seeds, timing)
        assert set(timing) == {"flow_s", "ekf_s"}
        assert got.positions.shape == ref.positions.shape
        assert got.positions.shape[0] == 5
        _equal(got.positions, ref.positions)
        _equal(got.alive, ref.alive)
        _equal(got.nis, ref.nis)
        assert got.smoothed is None and ref.smoothed is None
