"""The flow-driven and photometric measurement channels (implicit-flow
EKF/IEKF, UKF, adaptive_q, photometric, flow_photometric, seed_in_body)
and track_precomputed_flow against the JAX reference, on identical NumPy
inputs: each function, then whole clips through track_arrays. The
reference has no Pallas kernel here; the port's versions are plain
torch, so these tests pin them as they run on the card too."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu import pipeline as jp
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     SmoothConfig, TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu.models import dynamics as jdyn
from kalman_hydra_tpu.models import ekf as jekf
from kalman_hydra_tpu.models import photometric as jphoto
from kalman_hydra_tpu.ops import segment as jseg
from kalman_hydra_tpu.ops import warp as jwarp
from kalman_hydra_tpu_torch import convert
from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.config import EkfConfig as TEkfConfig
from kalman_hydra_tpu_torch.config import RunConfig as TRunConfig
from kalman_hydra_tpu_torch.models import ekf as tekf
from kalman_hydra_tpu_torch.models import lifecycle as tlife
from kalman_hydra_tpu_torch.models import photometric as tphoto
from kalman_hydra_tpu_torch.ops import segment as tseg
from kalman_hydra_tpu_torch.ops import warp as twarp

_t = torch.from_numpy


def _smooth_flow(rng, h, w):
    """An (h, w, 2) flow with curvature (a non-zero Jacobian everywhere)
    plus noise."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    fl = np.stack([2.0 * np.sin(xs / 9.0) + 0.5 * np.cos(ys / 7.0),
                   -1.5 * np.cos(ys / 11.0) + 0.3 * np.sin(xs / 5.0)], -1)
    return (fl + 0.05 * rng.normal(size=fl.shape)).astype(np.float32)


def _points(rng, k, h, w):
    """Points inside the frame, on its borders and outside it."""
    inside = rng.uniform([0, 0], [w - 1, h - 1], (k - 6, 2))
    edge = np.array([[0, 0], [w - 1, h - 1], [w - 1.0005, 3], [-4, 7],
                     [w + 5, h / 2], [w / 2, h - 1]])
    return np.concatenate([inside, edge]).astype(np.float32)


def test_sample_flow_with_grad_matches_reference(rng):
    """Values and Jacobians < 1e-5 (the rolled borders zeroed, the
    w - 1.001 clip)."""
    fl = _smooth_flow(rng, 40, 56)
    pts = _points(rng, 64, 40, 56)
    jv, jj = jwarp.sample_flow_with_grad(jnp.asarray(fl), jnp.asarray(pts))
    tv, tj = twarp.sample_flow_with_grad(_t(fl), _t(pts))
    assert tj.shape == (64, 2, 2)
    assert np.abs(tv.numpy() - np.asarray(jv)).max() < 1e-5
    assert np.abs(tj.numpy() - np.asarray(jj)).max() < 1e-5


def test_bilinear_sample_rows_matches_reference(rng):
    """The row-stacked sampler of the photometric channel: < 1e-5."""
    h, w = 30, 44
    planes = rng.normal(size=(h * w, 3)).astype(np.float32) * 50
    x = rng.uniform(-3, w + 2, (7, 25)).astype(np.float32)
    y = rng.uniform(-3, h + 2, (7, 25)).astype(np.float32)
    ref = np.asarray(jwarp.bilinear_sample_rows(
        jnp.asarray(planes), h, w, jnp.asarray(x), jnp.asarray(y)))
    got = twarp.bilinear_sample_rows(_t(planes), h, w, _t(x), _t(y))
    assert got.shape == (7, 25, 3)
    assert np.abs(got.numpy() - ref).max() < 1e-5 * np.abs(ref).max()


def _state(rng, cfg, k, h, w):
    """A live track pool with random means and SPD covariances (and Q
    scales with adaptive_q), as NumPy arrays."""
    n = cfg.state_dim
    x = np.zeros((k, n), np.float32)
    x[:, 0:2] = rng.uniform([4, 4], [w - 5, h - 5], (k, 2))
    x[:, 2:] = rng.normal(size=(k, n - 2)) * 0.7
    A = rng.normal(size=(k, n, n)).astype(np.float32) * 0.4
    P = (A @ A.transpose(0, 2, 1) + np.eye(n, dtype=np.float32)).astype(
        np.float32)
    st = dict(x=x, P=P, alive=rng.random(k) > 0.1,
              misses=np.zeros(k, np.int32),
              track_id=np.arange(k, dtype=np.int32))
    st["q_scale"] = (rng.uniform(0.5, 2.0, k).astype(np.float32)
                     if cfg.adaptive_q > 0 else None)
    return st


_EKF_CASES = {
    "implicit_iekf1": dict(measurement="implicit_flow", iekf_iters=1),
    "implicit_iekf3": dict(measurement="implicit_flow", iekf_iters=3),
    "implicit_iekf3_4state": dict(measurement="implicit_flow", iekf_iters=3,
                                  state_dim=4),
    "ukf": dict(measurement="implicit_flow", filter_type="ukf"),
    "ukf_alpha": dict(measurement="implicit_flow", filter_type="ukf",
                      ukf_alpha=0.5, ukf_kappa=1.0),
    "position_adaptive_q": dict(measurement="position", adaptive_q=0.3),
    "implicit_adaptive_q": dict(measurement="implicit_flow",
                                adaptive_q=0.5),
}


@pytest.mark.parametrize("name", sorted(_EKF_CASES))
def test_ekf_step_channels_match_reference(name, rng):
    """ekf_step of 64 tracks (some dead) against a curved flow: the
    implicit-flow EKF and IEKF, the UKF, and adaptive_q on the position
    and implicit channels; state, covariance, NIS and Q scales < 1e-4
    (the EKF step bar)."""
    kw = dict(state_dim=6)
    kw.update(_EKF_CASES[name])
    cfg = EkfConfig(**kw)
    tcfg = TEkfConfig(**kw)
    h, w = 48, 64
    fl = _smooth_flow(rng, h, w)
    st = _state(rng, cfg, 64, h, w)
    F, Q = jdyn.transition(cfg), jdyn.process_noise(cfg)
    R = cfg.r * np.eye(2, dtype=np.float32)
    jst = jekf.TrackState(**{k: None if v is None else jnp.asarray(v)
                             for k, v in st.items()})
    (js, jaux) = jax.jit(lambda s, f: jekf.ekf_step(
        s, f, cfg, jnp.asarray(F), jnp.asarray(Q), jnp.asarray(R)))(
        jst, jnp.asarray(fl))
    tst = tekf.TrackState(**{k: None if v is None else _t(v)
                             for k, v in st.items()})
    ts, taux = tekf.ekf_step(tst, _t(fl), tcfg, _t(F), _t(Q))
    for a, b in ((ts.x, js.x), (ts.P, js.P), (taux["nis"], jaux["nis"]),
                 (taux["x_pred"], jaux["x_pred"]),
                 (taux["P_pred"], jaux["P_pred"])):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-4
    assert (ts.q_scale is None) == (js.q_scale is None)
    if ts.q_scale is not None:
        assert np.abs(ts.q_scale.numpy() - np.asarray(js.q_scale)).max() \
            < 1e-4
        assert not np.allclose(ts.q_scale.numpy(), st["q_scale"])


def test_reseed_resets_q_scale(rng):
    """A fresh slot's Q scale restarts at 1; the others keep theirs, and
    init_tracks starts them all at 1 (None without adaptive_q)."""
    cfg = TEkfConfig(adaptive_q=0.3)
    from kalman_hydra_tpu_torch.config import TrackConfig as TTrackConfig
    st = tekf.init_tracks(cfg, _t(rng.uniform(0, 50, (8, 2)).astype(
        np.float32)))
    assert torch.equal(st.q_scale, torch.ones(8))
    assert tekf.init_tracks(TEkfConfig(), st.x[:, 0:2]).q_scale is None
    st = st._replace(alive=torch.tensor([False, True] * 4),
                     q_scale=torch.full((8,), 3.0))
    pts = _t(np.array([[100.0, 100.0], [200.0, 200.0]], np.float32))
    out = tlife.reseed(st, pts, torch.tensor([5.0, 4.0]), cfg,
                       TTrackConfig())
    assert out.q_scale.tolist() == [1.0, 3.0, 1.0] + [3.0] * 5


def _frames(seed=0, t=6, h=96, w=96):
    frames, _ = moving_blob_clip(num_frames=t, height=h, width=w,
                                 num_points=6, seed=seed)
    return frames


def test_photometric_measure_matches_reference(rng):
    """photometric_measure of 48 points on a frame pair (templates at the
    true previous positions, Gauss-Newton from a guess up to 2 px off):
    z < 1e-3 px, R_k < 1e-3 relative, valid identical."""
    from kalman_hydra_tpu.ops.color import grayscale_u8 as jgray
    clip = _frames()
    g0, g1 = (np.array(jgray(jnp.asarray(clip[i]))) for i in (0, 1))
    cfg = EkfConfig()
    p_prev = _points(rng, 48, 96, 96)
    p_pred = (p_prev + rng.uniform(-2, 2, p_prev.shape)).astype(np.float32)
    jz, jR, jv = jax.jit(lambda *a: jphoto.photometric_measure(*a, cfg))(
        *(jnp.asarray(a) for a in (g0, g1, p_prev, p_pred)))
    tz, tR, tv = tphoto.photometric_measure(
        *(_t(a) for a in (g0, g1, p_prev, p_pred)), TEkfConfig())
    assert np.abs(tz.numpy() - np.asarray(jz)).max() < 1e-3
    jR = np.asarray(jR)
    assert np.abs(tR.numpy() - jR).max() < 1e-3 * np.abs(jR).max()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.any() and not tv.all()


@pytest.mark.parametrize("invert", [False, True])
def test_segment_body_matches_reference(invert):
    """Otsu's threshold equal and the body mask identical, bit for bit,
    on a clip frame and on a frame with a second, smaller blob."""
    from kalman_hydra_tpu.ops.color import grayscale_u8 as jgray
    g = np.asarray(jgray(jnp.asarray(_frames()[0])))
    g2 = g.copy()
    g2[5:20, 60:90] = 255.0 - g2[5:20, 60:90]
    for img in (g, g2):
        jt = jseg.otsu_threshold(jnp.asarray(img))
        tt = tseg.otsu_threshold(_t(img))
        assert float(tt) == float(jt)
        jm = np.asarray(jseg.segment_body(jnp.asarray(img), invert=invert))
        tm = tseg.segment_body(_t(img), invert=invert).numpy()
        np.testing.assert_array_equal(tm, jm)
        assert 0 < tm.sum() < tm.size
        np.testing.assert_array_equal(
            tseg.mask_scores(_t(img), _t(tm)).numpy(),
            np.asarray(jseg.mask_scores(jnp.asarray(img), jnp.asarray(jm))))


def _frame_1080p(name):
    """Frame 0 of a 1080 x 1920 clip: deforming_body_clip's default (the
    mesh paths' clip) or chip_smoke.py's path A clip (moving_blob_clip)."""
    from kalman_hydra_tpu.io.synthetic import deforming_body_clip
    if name == "body":
        return deforming_body_clip(num_frames=1, height=1080, width=1920,
                                   seed=0)[0][0]
    return moving_blob_clip(num_frames=1, height=1080, width=1920,
                            num_points=16, blob_sigma=1920 / 18.0,
                            velocity=(2.1, -1.4), seed=0)[0][0]


@pytest.mark.parametrize("name", ["body", "blob"])
def test_segment_body_matches_reference_at_1080p(name):
    """At 1080p the histogram's intensity sum passes 2^24, where the
    port's int64 cumulation and the reference's f32 cumsum may part:
    Otsu's threshold equal and the body mask identical, bit for bit."""
    from kalman_hydra_tpu.ops.color import grayscale_u8 as jgray
    g = np.array(jgray(jnp.asarray(_frame_1080p(name))))
    assert g.sum() > 2 ** 24
    jt = jseg.otsu_threshold(jnp.asarray(g))
    assert float(tseg.otsu_threshold(_t(g))) == float(jt)
    jm = np.asarray(jseg.segment_body(jnp.asarray(g)))
    tm = tseg.segment_body(_t(g)).numpy()
    np.testing.assert_array_equal(tm, jm)
    assert 0 < tm.sum() < tm.size


_BASE = RunConfig(tracks=TrackConfig(num_tracks=16, reinit_every=2),
                  impl="pallas", pallas_interpret=True)
_PATHS = {
    # path I: the headline graph's flow, the 6-state IEKF / UKF
    "I_iekf2": _BASE.replace(
        flow=FlowConfig(levels=2, fast_warp=8, bf16_poly=True),
        ekf=EkfConfig(state_dim=6, measurement="implicit_flow",
                      iekf_iters=2)),
    "I_ukf": _BASE.replace(
        flow=FlowConfig(levels=2, fast_warp=8, bf16_poly=True),
        ekf=EkfConfig(state_dim=6, measurement="implicit_flow",
                      filter_type="ukf")),
    # path P: the photometric channel alone, and flow + photometric
    # with adaptive_q and body-restricted seeding
    "P_photometric": _BASE.replace(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="photometric")),
    "P_flow_photometric": _BASE.replace(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="flow_photometric", adaptive_q=0.3),
        tracks=TrackConfig(num_tracks=16, reinit_every=2,
                           seed_in_body=True)),
    # path W: docs/WALKTHROUGH.md section 3
    "W_walkthrough": _BASE.replace(
        flow=FlowConfig(method="lk_sparse", lk_block_halo=8, levels=2),
        ekf=EkfConfig(state_dim=6, adaptive_q=0.3, measurement="position"),
        smooth=SmoothConfig(enabled=True, lag=3)),
    "pair_implicit_adaptive_q_body": _BASE.replace(
        flow=FlowConfig(levels=2, fast_warp=8),
        ekf=EkfConfig(measurement="implicit_flow", adaptive_q=0.3),
        tracks=TrackConfig(num_tracks=16, reinit_every=2,
                           seed_in_body=True),
        pair_batch=True),
}


@pytest.mark.parametrize("name", sorted(_PATHS))
def test_track_arrays_channels_match_reference(name):
    """track_arrays on a 96 x 96 T=6 clip through both packages for each
    new channel's path config: positions < 1e-3 px, alive and track_id
    identical (and the smoother's output with the fixed lag)."""
    cfg = _PATHS[name]
    clip = _frames()
    ref = jax.device_get(jax.jit(jp.track_arrays, static_argnames="cfg")(
        jnp.asarray(clip), cfg))
    got = {k: v.numpy() for k, v in tp.track_arrays(
        torch.from_numpy(clip), TRunConfig.from_json(cfg.to_json())).items()}
    assert got["pos"].shape == (6, 16, 2)
    assert np.abs(got["pos"] - ref["pos"]).max() < 1e-3
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_array_equal(got["track_id"], ref["track_id"])
    assert np.abs(got["nis"] - ref["nis"]).max() < 1e-3
    assert set(got) == set(ref)
    if "smoothed" in got:
        assert np.abs(got["smoothed"] - ref["smoothed"]).max() < 1e-3
    assert got["alive"][-1].any()


def test_photometric_init_velocity_matches_reference():
    """With no flow pyramid cached (measurement="photometric"),
    init_velocity's frame 0 -> 1 flow comes from the frames themselves;
    the primed velocities are the reference's (< 1e-4 px/frame)."""
    cfg = _BASE.replace(flow=FlowConfig(levels=2),
                        ekf=EkfConfig(measurement="photometric",
                                      state_dim=6),
                        tracks=TrackConfig(num_tracks=16,
                                           init_velocity=True))
    clip = _frames()
    jc = jax.jit(jp.init_from_frame, static_argnames="cfg")(clip[0], cfg)
    jx = np.asarray(jax.jit(jp._prime_init_velocity, static_argnames="cfg")(
        jc, clip[1], cfg).tracks.x)
    tcfg = TRunConfig.from_json(cfg.to_json())
    tc = tp.init_from_frame(torch.from_numpy(clip[0]), tcfg)
    assert tc.prev_rpyr == ()
    tx = tp._prime_init_velocity(tc, torch.from_numpy(clip[1]),
                                 tcfg).tracks.x.numpy()
    assert np.abs(tx - jx).max() < 1e-4
    assert np.abs(tx[:, 2:4]).max() > 0.1


def test_seed_in_body_restricts_the_seeds():
    """With seed_in_body every seed lies inside frame 0's body mask, and
    the port's seeds are the reference's."""
    cfg = _PATHS["P_flow_photometric"]
    clip = _frames()
    jc = jax.device_get(jax.jit(jp.init_from_frame, static_argnames="cfg")(
        clip[0], cfg))
    tc = tp.init_from_frame(torch.from_numpy(clip[0]),
                            TRunConfig.from_json(cfg.to_json()))
    np.testing.assert_array_equal(tc.tracks.x.numpy(), np.asarray(jc.tracks.x))
    np.testing.assert_array_equal(tc.tracks.alive.numpy(),
                                  np.asarray(jc.tracks.alive))
    np.testing.assert_array_equal(tc.tracks.q_scale.numpy(),
                                  np.asarray(jc.tracks.q_scale))
    mask = tseg.segment_body(tc.prev_gray).numpy()
    xy = tc.tracks.x[:, 0:2].numpy().astype(int)
    live = tc.tracks.alive.numpy()
    assert live.any() and (mask[xy[live, 1], xy[live, 0]] == 1).all()


def test_adaptive_q_carry_round_trip():
    """A reference Carry with Q scales crosses into the port and back
    unchanged (convert.py carries q_scale, None or a tensor)."""
    cfg = _PATHS["P_flow_photometric"]
    jc = jax.device_get(jax.jit(jp.init_from_frame, static_argnames="cfg")(
        _frames()[0], cfg))
    tc = convert.carry_to_torch(jc, "cpu")
    assert tc.tracks.q_scale.shape == (16,)
    back = convert.carry_to_numpy(tc)
    np.testing.assert_array_equal(back["tracks"]["q_scale"],
                                  np.asarray(jc.tracks.q_scale))
    tc2 = convert.carry_to_torch(jax.device_get(jax.jit(
        jp.init_from_frame, static_argnames="cfg")(_frames()[0], _BASE)),
        "cpu")
    assert tc2.tracks.q_scale is None
    assert convert.carry_to_numpy(tc2)["tracks"]["q_scale"] is None


@pytest.mark.parametrize("ekf", [
    dict(), dict(state_dim=6, measurement="implicit_flow", iekf_iters=2),
    dict(adaptive_q=0.3)])
def test_track_precomputed_flow_matches_reference(ekf, rng):
    """track_precomputed_flow over 5 supplied curved flows from 20 seeds
    (some leaving the frame): positions < 1e-3 px, alive, track_id and
    NIS as the reference's."""
    cfg = RunConfig(ekf=EkfConfig(**ekf))
    h, w = 40, 56
    flows = np.stack([_smooth_flow(rng, h, w) * (1 + 0.2 * t)
                      for t in range(5)])
    seeds = _points(rng, 20, h, w)[:14]
    ref = jp.track_precomputed_flow(flows, seeds, cfg)
    got = tp.track_precomputed_flow(flows, seeds,
                                    TRunConfig.from_json(cfg.to_json()),
                                    device="cpu")
    assert got.positions.shape == (6, 14, 2)
    assert np.abs(got.positions - ref.positions).max() < 1e-3
    np.testing.assert_array_equal(got.alive, ref.alive)
    np.testing.assert_array_equal(got.track_id, ref.track_id)
    assert np.abs(got.nis - ref.nis).max() < 1e-3
    assert got.smoothed is None


def test_photometric_computes_no_flow(monkeypatch):
    """measurement="photometric" caches no flow pyramid and never calls
    the flow: the step's carry holds no pyramid and no warm start."""
    from kalman_hydra_tpu_torch.ops import farneback as tfb
    cfg = TRunConfig.from_json(_PATHS["P_photometric"].replace(
        flow=FlowConfig(levels=2, temporal_init=True)).to_json())

    def boom(*a, **k):
        raise AssertionError("flow computed in photometric mode")
    monkeypatch.setattr(tp, "farneback_from_pyramids", boom)
    monkeypatch.setattr(tfb, "polyexp_pyramid", boom)
    monkeypatch.setattr(tp, "polyexp_pyramid", boom)
    clip = torch.from_numpy(_frames(t=3))
    carry = tp.init_from_frame(clip[0], cfg)
    assert carry.prev_rpyr == () and carry.prev_flow is None
    carry, out = tp.make_step(cfg, "cpu")(carry, clip[1])
    assert carry.prev_rpyr == () and carry.prev_flow is None
    assert out["pos"].shape == (16, 2)
    assert dataclasses.asdict(cfg.flow)["temporal_init"]
