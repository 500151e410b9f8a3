"""Streaming against the JAX reference on the CPU: the port's
`pipeline.track_stream` against the reference's `track_stream` on the same
clip (the default config with re-seeding from a corner pool; init_velocity
with reinit_every 3, temporal_init and fixed-lag smoothing; lk_sparse with
lag-0 (chunked) smoothing, seeds and frame0), each stream against the
port's own `track_clip`, and what the stream leaves to the per-frame step
(pair_batch) or refuses (render_tmpl, the mesh-render channels)."""

import dataclasses

import numpy as np
import pytest

from kalman_hydra_tpu import pipeline as jp
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     SmoothConfig, TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.config import RunConfig as TRunConfig

_TRACKS = TrackConfig(num_tracks=8, corner_pool=16)
CASES = {
    # the reference's defaults at 2 levels: a fresh corner pool and
    # re-seeding every frame
    "default": RunConfig(flow=FlowConfig(levels=2), tracks=_TRACKS),
    "velocity_temporal_lag": RunConfig(
        flow=FlowConfig(levels=2, temporal_init=True),
        ekf=EkfConfig(state_dim=6),
        tracks=dataclasses.replace(_TRACKS, reinit_every=3,
                                   init_velocity=True),
        smooth=SmoothConfig(enabled=True, lag=2)),
    # lag 0 and chunk 0: the history in host memory, chunked RTS (64)
    "lk_sparse_chunked_seeds_frame0": RunConfig(
        flow=FlowConfig(method="lk_sparse", levels=2), tracks=_TRACKS,
        smooth=SmoothConfig(enabled=True)),
}


@pytest.fixture(scope="module")
def clip():
    frames, truth = moving_blob_clip(num_frames=6, height=64, width=80,
                                     num_points=8, seed=3)
    return frames, truth.positions[0]


def _args(name, frames, seeds):
    """(frame iterator, keyword arguments) of a case's stream: the last
    case gives frame 0 apart and replaces the corner seeding."""
    if name.endswith("seeds_frame0"):
        return iter(frames[1:]), dict(frame0=frames[0], seeds=seeds)
    return iter(frames), {}


def _ported(cfg: RunConfig) -> TRunConfig:
    return TRunConfig.from_json(cfg.to_json())


def _same(a, b, bar):
    assert a.positions.shape == b.positions.shape
    assert np.abs(a.positions - b.positions).max() < bar
    np.testing.assert_array_equal(a.alive, b.alive)
    np.testing.assert_array_equal(a.track_id, b.track_id)
    assert np.abs(a.nis - b.nis).max() < bar
    assert (a.smoothed is None) == (b.smoothed is None)
    if a.smoothed is not None:
        assert np.abs(a.smoothed - b.smoothed).max() < bar


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_matches_reference(clip, name):
    """The port's stream against the reference's on the CPU: positions
    (and smoothed positions, NIS) < 1e-3 px, alive and track_id
    identical, every frame a row."""
    frames, seeds = clip
    cfg = CASES[name]
    it, kw = _args(name, frames, seeds)
    ref = jp.track_stream(it, cfg, **kw)
    it, kw = _args(name, frames, seeds)
    got = tp.track_stream(it, _ported(cfg), **kw, device="cpu")
    assert got.positions.shape == (6, 8, 2)
    _same(got, ref, 1e-3)
    assert got.alive[-1].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_matches_clip_mode(clip, name):
    """The stream against the port's own track_clip of the same clip and
    seeds: < 1e-4 px (the bar of the reference's
    test_streaming_matches_clip_mode), alive and track_id identical."""
    frames, seeds = clip
    cfg = _ported(CASES[name])
    it, kw = _args(name, frames, seeds)
    got = tp.track_stream(it, cfg, **kw, device="cpu")
    ref = tp.track_clip(frames, cfg, seeds=kw.get("seeds"), device="cpu")
    _same(got, ref, 1e-4)


def test_stream_runs_the_per_frame_step(clip):
    """pair_batch does not change a stream: it runs the per-frame step,
    as the reference's does (the same rows, bit for bit)."""
    frames, _ = clip
    cfg = _ported(CASES["default"])
    a = tp.track_stream(iter(frames[:4]), cfg, device="cpu")
    b = tp.track_stream(iter(frames[:4]), cfg.replace(pair_batch=True),
                        device="cpu")
    for f in ("positions", "alive", "nis", "track_id"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_stream_refuses_the_render_channels(clip):
    """render_tmpl and the mesh-render measurement raise
    NotImplementedError naming ROADMAP P11b."""
    frames, _ = clip
    cfg = _ported(CASES["default"])
    with pytest.raises(NotImplementedError, match="P11b"):
        tp.track_stream(iter(frames), cfg, render_tmpl=object(),
                        device="cpu")
    render = cfg.replace(ekf=dataclasses.replace(cfg.ekf,
                                                 measurement="render"),
                         tracks=dataclasses.replace(cfg.tracks,
                                                    reinit=False))
    with pytest.raises(NotImplementedError, match="P11b"):
        tp.track_stream(iter(frames), render, device="cpu")
