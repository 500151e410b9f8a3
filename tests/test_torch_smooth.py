"""Smoothing against the JAX reference on the CPU: the RTS smoothers
(monolithic, host-chunked, fixed-lag) and the per-pixel flow KF on random
inputs; tracking with smoothing on every path (per-frame monolithic and
fixed-lag, track_clip's chunked mode, the pair-batched and multi-clip
paths with init_velocity); `api.smooth` and `api.flow_sequence(smooth=
True)` with no config; and a reference Carry taken mid-clip under
temporal_init and lag=2, carried across with `convert` and continued by
the port.

The reference runs its plain XLA route (impl="xla") at f32 planes: its
smoothers are XLA on every route, and the flow kernels and route these
cases reach are held in Pallas interpret mode by other tests (the exact
warp cold and warm: test_torch_flow_update.py; end to end:
test_torch_channels.py's flow_photometric path; K1:
test_torch_kernels.py and test_torch_ekf_route.py). A reference jit is
mostly compile time, about half of it at XLA. The pair paths, at bf16
planes, run in interpret mode (the XLA route rounds them elsewhere)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu import api as japi
from kalman_hydra_tpu import pipeline as jp
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     SmoothConfig, TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu.models import dynamics as jdyn
from kalman_hydra_tpu.models import pixel_ekf as jpix
from kalman_hydra_tpu.models import rts as jrts
from kalman_hydra_tpu_torch import api, convert
from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.config import RunConfig as TRunConfig
from kalman_hydra_tpu_torch.models import pixel_ekf as tpix
from kalman_hydra_tpu_torch.models import rts as trts


@pytest.fixture(scope="module")
def clip():
    frames, _ = moving_blob_clip(num_frames=5, height=128, width=160,
                                 num_points=8, seed=0)
    return frames


def _ported(cfg: RunConfig) -> TRunConfig:
    return TRunConfig.from_json(cfg.to_json())


def _history(rng, T, K, n):
    """A random filter history as a filter leaves it: per track a random
    SPD start, process noise and position-measurement noise; each step
    predicts (F P F^T + Q, F x plus noise) and updates the covariance;
    states random; and random segment breaks."""
    cfg = EkfConfig(state_dim=n)
    F, Q = jdyn.transition(cfg), jdyn.process_noise(cfg)
    H = jdyn.position_H(cfg).astype(np.float64)
    A = rng.normal(size=(K, n, n))
    P = A @ np.swapaxes(A, -1, -2) / n + np.eye(n)
    q = rng.uniform(0.5, 2.0, (K, 1, 1))
    R = rng.uniform(0.1, 1.0, (K, 1, 1)) * np.eye(2)
    P_filt, P_pred = [P], [P]
    for _ in range(T - 1):
        Pp = F @ P @ F.T + q * Q
        Kg = Pp @ H.T @ np.linalg.inv(H @ Pp @ H.T + R)
        P = (np.eye(n) - Kg @ H) @ Pp
        P = 0.5 * (P + np.swapaxes(P, -1, -2))
        P_pred.append(Pp)
        P_filt.append(P)
    x_filt = rng.normal(size=(T, K, n)).astype(np.float32)
    x_pred = x_filt.copy()
    x_pred[1:] = (x_filt[:-1] @ F.T
                  + rng.normal(size=(T - 1, K, n)).astype(np.float32))
    h = dict(x_filt=x_filt, P_filt=np.stack(P_filt).astype(np.float32),
             x_pred=x_pred, P_pred=np.stack(P_pred).astype(np.float32))
    breaks = rng.random((T - 1, K)) < 0.2
    return h, breaks


@pytest.mark.parametrize("n", [4, 6])
def test_rts_matches_reference(n, rng):
    """rts_smooth and rts_smooth_chunked (chunk 3, through host memory)
    vs the reference on random SPD histories with breaks: < 1e-4; the
    chunked pass equals the monolithic one."""
    T, K = 8, 6
    hist, breaks = _history(rng, T, K, n)
    F = jdyn.transition(EkfConfig(state_dim=n))
    args = [hist[k] for k in ("x_filt", "P_filt", "x_pred", "P_pred")]
    rx, rP = jrts.rts_smooth(jnp.asarray(F), *map(jnp.asarray, args),
                             breaks=jnp.asarray(breaks))
    targs = [torch.from_numpy(a) for a in args]
    gx, gP = trts.rts_smooth(F, *targs, breaks=torch.from_numpy(breaks))
    assert np.abs(gx.numpy() - np.asarray(rx)).max() < 1e-4
    assert np.abs(gP.numpy() - np.asarray(rP)).max() < 1e-4
    cx, cP = jrts.rts_smooth_chunked(F, *args, chunk=3, breaks=breaks)
    hx, hP = trts.rts_smooth_chunked(F, *targs, chunk=3,
                                     breaks=torch.from_numpy(breaks))
    assert np.abs(hx.numpy() - cx).max() < 1e-4
    assert np.abs(hP.numpy() - cP).max() < 1e-4
    assert np.abs(hx.numpy() - gx.numpy()).max() < 1e-4


def test_fixed_lag_matches_reference(rng):
    """fixed_lag_smooth over a 3-deep window whose middle step re-seeds
    two tracks and kills one: < 1e-4."""
    L1, K, n = 3, 6, 4
    hist, _ = _history(rng, L1, K, n)
    tid = np.zeros((L1, K), np.int32)
    tid[2, :2] = 1
    alive = np.ones((L1, K), bool)
    alive[1, 3] = False
    F = jdyn.transition(EkfConfig(state_dim=n))
    args = [hist[k] for k in ("x_filt", "P_filt", "x_pred", "P_pred")]
    rx, rP = jrts.fixed_lag_smooth(jnp.asarray(F),
                                   *map(jnp.asarray, args + [tid, alive]))
    gx, gP = trts.fixed_lag_smooth(
        torch.as_tensor(F), *(torch.from_numpy(a) for a in args),
        torch.from_numpy(tid), torch.from_numpy(alive))
    assert np.abs(gx.numpy() - np.asarray(rx)).max() < 1e-4
    assert np.abs(gP.numpy() - np.asarray(rP)).max() < 1e-4


def test_pixel_ekf_matches_reference(rng):
    """The per-pixel flow KF over 7 frames of 16x20 flows with outliers
    that trip the innovation gate: < 1e-4 (PARITY.md's bar)."""
    flows = rng.normal(size=(7, 16, 20, 2)).astype(np.float32)
    flows[3, :4] += 30.0                                   # gated pixels
    ref = np.asarray(jpix.smooth_flow_sequence(jnp.asarray(flows)))
    got = tpix.smooth_flow_sequence(torch.from_numpy(flows)).numpy()
    assert np.abs(got - ref).max() < 1e-4
    np.testing.assert_array_equal(got[0], flows[0])


def _smooth_cfg(**smooth) -> RunConfig:
    return RunConfig(tracks=TrackConfig(num_tracks=32),
                     smooth=SmoothConfig(enabled=True, **smooth),
                     impl="xla")


def _assert_smoothed(got: dict, ref: dict):
    assert np.abs(got["pos"] - ref["pos"]).max() < 1e-3
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_array_equal(got["track_id"], ref["track_id"])
    assert got["smoothed"].shape == got["pos"].shape
    assert np.abs(got["smoothed"] - ref["smoothed"]).max() < 1e-3


@pytest.fixture(scope="module")
def port_rows(clip):
    """The port's track_arrays rows, filter history included, under (e)
    by lag, each computed once; lag 0 (one RTS) is also (f)'s
    monolithic smoother."""
    cache = {}

    def rows(lag):
        if lag not in cache:
            cache[lag] = {k: v.numpy() for k, v in tp.track_arrays(
                torch.from_numpy(clip), _ported(_smooth_cfg(lag=lag)),
                with_history=True).items()}
        return cache[lag]
    return rows


@pytest.fixture(scope="module")
def ref_rows(clip):
    """The reference's track_arrays rows, filter history included, under
    (e) by lag, each computed once: lag 0's history is also the one (f)'s
    chunked smoother runs on."""
    cache = {}

    def rows(lag):
        if lag not in cache:
            cache[lag] = jax.device_get(jax.jit(
                jp.track_arrays, static_argnames=("cfg", "with_history"))(
                jnp.asarray(clip), _smooth_cfg(lag=lag), True))
        return cache[lag]
    return rows


@pytest.mark.parametrize("lag", [0, 2])
def test_track_arrays_smoothing_matches_reference(clip, lag, port_rows,
                                                  ref_rows):
    """(e) RunConfig() with smoothing, monolithic RTS and the fixed-lag
    smoother at lag=2: `smoothed` < 1e-3 px; with_history returns the
    reference's filter history too."""
    ref = ref_rows(lag)
    got = port_rows(lag)
    assert set(got) == set(ref)
    _assert_smoothed(got, ref)
    for k in ("x_filt", "P_filt", "x_pred", "P_pred"):
        assert np.abs(got[k] - ref[k]).max() < 1e-3, k


def test_track_clip_chunked_matches_reference(clip, port_rows, ref_rows):
    """(f) track_clip with SmoothConfig(chunk=2): the history goes through
    host memory and is smoothed two frames at a time: `smoothed` < 1e-3
    px against the reference's track_clip at chunk=2, which runs its
    filter (the same history as (e)'s at lag 0, shared) and then its
    chunked smoother (`_smooth_history_chunked`) on the host; < 1e-4
    against the port's monolithic RTS (track_clip's smoothing is
    track_arrays')."""
    cfg = _smooth_cfg(chunk=2)
    ref = ref_rows(0)
    ref_smoothed = jp._smooth_history_chunked(ref, cfg)[..., 0:2]
    got = tp.track_clip(clip, _ported(cfg), device="cpu")
    assert np.abs(got.positions - ref["pos"]).max() < 1e-3
    assert np.abs(got.smoothed - ref_smoothed).max() < 1e-3
    assert np.abs(got.smoothed - port_rows(0)["smoothed"]).max() < 1e-4


def _pair_cfg(lag: int) -> RunConfig:
    return RunConfig(
        flow=FlowConfig(levels=3, fast_warp=8, bf16_poly=True),
        tracks=TrackConfig(num_tracks=24, reinit_every=2,
                           init_velocity=True),
        smooth=SmoothConfig(enabled=True, lag=lag), impl="pallas",
        pallas_interpret=True, pair_batch=True)


@pytest.mark.parametrize("multi_clip", [False, True])
def test_pair_paths_smoothing_matches_reference(clip, multi_clip):
    """(g) The pair-batched path (monolithic RTS) and the multi-clip path
    (two chained clips, lag=2), both with init_velocity: positions and
    `smoothed` < 1e-3 px per clip, alive and track_id identical."""
    if multi_clip:
        clip2, _ = moving_blob_clip(num_frames=5, height=128, width=160,
                                    num_points=8, seed=1)
        frames = np.stack([clip, clip2])
        cfg = _pair_cfg(lag=2)
        fn, tfn = jp.track_clips_pairflow, tp.track_clips_pairflow
    else:
        frames, cfg = clip, _pair_cfg(lag=0)
        fn, tfn = jp.track_arrays, tp.track_arrays
    ref = jax.device_get(jax.jit(fn, static_argnames="cfg")(
        jnp.asarray(frames), cfg))
    got = {k: v.numpy()
           for k, v in tfn(torch.from_numpy(frames), _ported(cfg)).items()}
    assert set(got) == set(ref)
    if not multi_clip:
        got, ref = {k: v[None] for k, v in got.items()}, \
            {k: v[None] for k, v in ref.items()}
    for b in range(got["pos"].shape[0]):
        _assert_smoothed({k: v[b] for k, v in got.items()},
                         {k: v[b] for k, v in ref.items()})


def test_api_smooth_default_matches_reference():
    """api.smooth with no config: RunConfig() with the RTS on in both
    packages (the reference at its default impl="xla"): `smoothed`
    < 1e-3 px."""
    frames, _ = moving_blob_clip(num_frames=4, height=96, width=128,
                                 num_points=6, seed=2)
    ref = japi.smooth(frames)
    got = api.smooth(frames, device="cpu")
    assert got.smoothed.shape == ref.smoothed.shape == (4, 256, 2)
    assert np.abs(got.positions - ref.positions).max() < 1e-3
    assert np.abs(got.smoothed - ref.smoothed).max() < 1e-3


def test_api_flow_sequence_smooth_default_matches_reference():
    """api.flow_sequence(smooth=True) with no config: the per-frame
    exact-warp chain, per-pixel KF smoothed, in both packages: < 1e-3 px."""
    frames, _ = moving_blob_clip(num_frames=4, height=96, width=128,
                                 num_points=6, seed=3)
    ref = japi.flow_sequence(frames, smooth=True)
    got = api.flow_sequence(frames, smooth=True, device="cpu")
    assert got.shape == ref.shape == (3, 96, 128, 2)
    assert np.abs(got - ref).max() < 1e-3


def test_carry_round_trip_mid_clip(clip):
    """A reference Carry after two steps under temporal_init and lag=2
    (prev_flow and lag_buf set) crosses into the port with
    convert.carry_to_torch and back; the port then continues it to the
    reference's positions, nis and fixed-lag emissions (< 1e-3)."""
    cfg = RunConfig(flow=FlowConfig(levels=3, temporal_init=True),
                    tracks=TrackConfig(num_tracks=32),
                    smooth=SmoothConfig(enabled=True, lag=2),
                    impl="xla")
    jstep = jax.jit(jp.make_step(cfg))
    jc = jax.jit(jp.init_from_frame, static_argnames="cfg")(clip[0], cfg)
    for t in (1, 2):
        jc, _ = jstep(jc, clip[t])
    jc = jax.device_get(jc)
    assert jc.prev_flow is not None and len(jc.lag_buf) == 6
    tc = convert.carry_to_torch(jc, "cpu")
    back = convert.carry_to_numpy(tc)
    np.testing.assert_array_equal(back["prev_flow"], np.asarray(jc.prev_flow))
    for a, b in zip(back["lag_buf"], jc.lag_buf):
        np.testing.assert_array_equal(a, np.asarray(b))
    tstep = tp.make_step(_ported(cfg), "cpu")
    for t in (3, 4):
        jc, jo = jstep(jc, clip[t])
        tc, to = tstep(tc, torch.from_numpy(clip[t]))
        jo = jax.device_get(jo)
        for k in ("pos", "nis", "smoothed_lag"):
            assert np.abs(to[k].numpy() - jo[k]).max() < 1e-3, (t, k)
        np.testing.assert_array_equal(to["track_id"].numpy(),
                                      jo["track_id"])
    assert np.abs(tc.prev_flow.numpy()
                  - np.asarray(jax.device_get(jc.prev_flow))).max() < 1e-3
