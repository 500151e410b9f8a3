"""Checkpoint and resume against the JAX reference on the CPU: the port's
checkpoint has the reference's npz keys, dtypes and shapes; a reference
checkpoint resumes in the port, and a port checkpoint in the reference,
each equal to the other package's resume; a resume equals the
uninterrupted stream and keeps the reinit_every cadence; a stream too
short for its checkpoint raises, and a resume at the end of the stream
returns the restored state as one row."""

import dataclasses

import numpy as np
import pytest

from kalman_hydra_tpu import pipeline as jp
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     SmoothConfig, TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.config import RunConfig as TRunConfig
from kalman_hydra_tpu_torch.utils import checkpoint

# every optional key: the corner pool (reinit_every 3), the warm-start
# field (temporal_init), q_scale (adaptive_q) and the lag-2 window
FULL = RunConfig(flow=FlowConfig(levels=2, temporal_init=True),
                 ekf=EkfConfig(adaptive_q=0.3),
                 tracks=TrackConfig(num_tracks=8, corner_pool=16,
                                    reinit_every=3),
                 smooth=SmoothConfig(enabled=True, lag=2))
TFULL = TRunConfig.from_json(FULL.to_json())
BASIC = TRunConfig.from_json(RunConfig(
    flow=FlowConfig(levels=2),
    tracks=TrackConfig(num_tracks=8, corner_pool=16)).to_json())


@pytest.fixture(scope="module")
def frames():
    return moving_blob_clip(num_frames=7, height=64, width=80, num_points=8,
                            seed=5)[0]


@pytest.fixture(scope="module")
def checkpoints(frames, tmp_path_factory):
    """Each package's stream of the first 5 frames under FULL, a
    checkpoint every 2 frames (the last at frame_idx 4): (rows, path)
    by package."""
    d = tmp_path_factory.mktemp("ckpt")
    ref_path, port_path = str(d / "ref.npz"), str(d / "port.npz")
    ref = jp.track_stream(iter(frames[:5]), FULL, checkpoint_path=ref_path,
                          checkpoint_every=2)
    port = tp.track_stream(iter(frames[:5]), TFULL,
                           checkpoint_path=port_path, checkpoint_every=2,
                           device="cpu")
    return {"ref": (ref, ref_path), "port": (port, port_path)}


def _same(a, b, bar):
    assert a.positions.shape == b.positions.shape
    assert np.abs(a.positions - b.positions).max() < bar
    np.testing.assert_array_equal(a.alive, b.alive)
    np.testing.assert_array_equal(a.track_id, b.track_id)
    assert (a.smoothed is None) == (b.smoothed is None)
    if a.smoothed is not None:
        assert np.abs(a.smoothed - b.smoothed).max() < bar


def test_checkpoint_has_the_reference_keys(checkpoints):
    """Same keys, dtypes and shapes as the reference's checkpoint of the
    same run; the states agree (< 1e-3, the integer and boolean fields
    and the frame index identical), and so do the streams' rows."""
    (ref, ref_path), (port, port_path) = (checkpoints["ref"],
                                          checkpoints["port"])
    _same(port, ref, 1e-3)
    with np.load(ref_path) as r, np.load(port_path) as p:
        assert sorted(p.keys()) == sorted(r.keys())
        assert {"corner_pts", "prev_flow", "q_scale", "lag_xf",
                "lag_alive"} <= set(p.keys())
        for k in r.keys():
            assert (p[k].dtype, p[k].shape) == (r[k].dtype, r[k].shape), k
            if p[k].dtype.kind in "biu":
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
            else:
                assert np.abs(p[k] - r[k]).max() < 1e-3, k
        assert int(p["frame_idx"]) == 4


def test_port_resumes_a_reference_checkpoint(frames, checkpoints):
    """A reference checkpoint resumed by the port against the reference's
    own resume of it: < 1e-4 px, alive and track_id identical."""
    path = checkpoints["ref"][1]
    ref = jp.track_stream(iter(frames), FULL, checkpoint_path=path,
                          resume=True)
    got = tp.track_stream(iter(frames), TFULL, checkpoint_path=path,
                          resume=True, device="cpu")
    assert got.positions.shape == (2, 8, 2)
    _same(got, ref, 1e-4)


def test_reference_resumes_a_port_checkpoint(frames, checkpoints):
    """A port checkpoint resumed by the reference against the port's own
    resume of it: < 1e-4 px, alive and track_id identical."""
    path = checkpoints["port"][1]
    ref = jp.track_stream(iter(frames), FULL, checkpoint_path=path,
                          resume=True)
    got = tp.track_stream(iter(frames), TFULL, checkpoint_path=path,
                          resume=True, device="cpu")
    _same(ref, got, 1e-4)


@pytest.mark.parametrize("name", ["basic", "full", "reinit_every_3"])
def test_resume_matches_uninterrupted(frames, tmp_path, name):
    """A stream checkpointed at frame_idx 4 and resumed equals the tail of
    the uninterrupted stream (< 1e-4 px, alive and track_id identical):
    the corner pool, the window, the warm-start field and q_scale come
    back, and reinit_every 3 keeps its refresh cadence across the
    resume."""
    cfg = {"basic": BASIC, "full": TFULL,
           "reinit_every_3": BASIC.replace(tracks=dataclasses.replace(
               BASIC.tracks, reinit_every=3))}[name]
    ck = str(tmp_path / "state.npz")
    full = tp.track_stream(iter(frames), cfg, device="cpu")
    tp.track_stream(iter(frames[:5]), cfg, checkpoint_path=ck,
                    checkpoint_every=2, device="cpu")
    resumed = tp.track_stream(iter(frames), cfg, checkpoint_path=ck,
                              resume=True, device="cpu")
    assert resumed.positions.shape == (2, 8, 2)
    np.testing.assert_array_equal(resumed.track_id, full.track_id[-2:])
    np.testing.assert_array_equal(resumed.alive, full.alive[-2:])
    assert np.abs(resumed.positions - full.positions[-2:]).max() < 1e-4


def test_resume_short_stream_and_end_of_stream(frames, tmp_path):
    """A stream shorter than the checkpoint's frames raises ValueError
    naming the resume; a stream that ends where the checkpoint was
    written returns the restored state as its one row."""
    ck = str(tmp_path / "state.npz")
    run = tp.track_stream(iter(frames[:5]), BASIC, checkpoint_path=ck,
                          checkpoint_every=4, device="cpu")
    with pytest.raises(ValueError, match="resume"):
        tp.track_stream(iter(frames[:3]), BASIC, checkpoint_path=ck,
                        resume=True, device="cpu")
    end = tp.track_stream(iter(frames[:5]), BASIC, checkpoint_path=ck,
                          resume=True, device="cpu")
    assert end.positions.shape == (1, 8, 2)
    np.testing.assert_array_equal(end.positions[0], run.positions[-1])
    np.testing.assert_array_equal(end.track_id[0], run.track_id[-1])
    assert not end.nis.any()


def test_load_state_round_trip(tmp_path):
    """save_state then load_state gives back the arrays; the optional
    entries come back as None where the file has none."""
    from kalman_hydra_tpu_torch.models.ekf import TrackState
    import torch
    rng = np.random.default_rng(0)
    st = TrackState(x=torch.from_numpy(rng.normal(size=(3, 4)).astype(
                        np.float32)),
                    P=torch.eye(4).expand(3, 4, 4),
                    alive=torch.tensor([True, False, True]),
                    misses=torch.zeros(3, dtype=torch.int32),
                    track_id=torch.arange(3, dtype=torch.int32))
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, st, torch.zeros(5, 6), 7)
    state, gray, idx, cc, lag, flow = checkpoint.load_state(path)
    assert idx == 7 and gray.shape == (5, 6)
    assert cc is None and lag is None and flow is None
    assert state.q_scale is None
    for f in ("x", "P", "alive", "misses", "track_id"):
        np.testing.assert_array_equal(getattr(state, f),
                                      getattr(st, f).numpy())
