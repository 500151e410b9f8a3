"""The port against the OpenCV oracle, at the reference's own bars: the
CPU reference pipeline (kalman_hydra_tpu.ref.pipeline, cv2 + NumPy) on
tests/integration/test_pipeline.py's clip96/cfg96, and the committed
oracle outputs of tests/golden/oracle_v1.npz at
tests/integration/test_golden.py's bars (chip_smoke.py holds the card
to the same npz)."""

import os

import numpy as np
import pytest

from kalman_hydra_tpu.config import FlowConfig, RunConfig, TrackConfig
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu.ref import pipeline as rp
from kalman_hydra_tpu_torch import api, pipeline
from kalman_hydra_tpu_torch import config as tconfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "oracle_v1.npz")


def _port(cfg: RunConfig) -> tconfig.RunConfig:
    return tconfig.RunConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_track_clip_matches_cpu_oracle_pipeline():
    """pipeline.track_clip on the CPU against ref.pipeline.track_clip
    from the true seeds: mean < 1e-3 px, max < 1e-2 (the reference's
    test_device_pipeline_matches_oracle)."""
    frames, truth = moving_blob_clip(num_frames=6, height=96, width=96,
                                     num_points=8, seed=0)
    cfg = RunConfig(flow=FlowConfig(levels=3),
                    tracks=TrackConfig(num_tracks=8, reinit=False))
    seeds = truth.positions[0]
    got = pipeline.track_clip(frames, _port(cfg), seeds, device="cpu")
    ref = rp.track_clip(frames, cfg, seeds=seeds)
    d = np.linalg.norm(got.positions - ref.positions, axis=-1)
    assert d.mean() < 1e-3
    assert d.max() < 1e-2


def test_flow_matches_golden(golden):
    """api.flow (Farneback, levels=3) on the golden pair against the
    oracle's committed flow: mean EPE < 0.05, < 0.01 inside an 8-pixel
    border."""
    flow = api.flow(golden["pair_a"], golden["pair_b"],
                    tconfig.FlowConfig(levels=3), device="cpu")
    epe = np.linalg.norm(flow - golden["farneback_flow"], axis=-1)
    assert epe.mean() < 0.05
    assert epe[8:-8, 8:-8].mean() < 0.01


def test_tracks_match_golden(golden):
    """pipeline.track_clip from the golden seeds against the oracle's
    committed tracks: mean < 1e-2 px."""
    cfg = tconfig.RunConfig(flow=tconfig.FlowConfig(levels=3),
                            tracks=tconfig.TrackConfig(num_tracks=8,
                                                       reinit=False))
    tr = pipeline.track_clip(golden["clip_frames"], cfg,
                             seeds=golden["clip_seeds"], device="cpu")
    d = np.linalg.norm(tr.positions - golden["track_positions"], axis=-1)
    assert d.mean() < 1e-2
