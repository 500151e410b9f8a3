"""End to end: the port's track_arrays against the JAX reference's
track_arrays (impl="pallas" in interpret mode, fi_level_fused=False) on
the same clip, in f32 and with bf16 polyexp planes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu import pipeline as jp
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu_torch import api
from kalman_hydra_tpu_torch import pipeline as tp


def slice_config(bf16: bool) -> RunConfig:
    """The main path's settings at 128x160 (3 levels), K=32."""
    return RunConfig(
        flow=FlowConfig(levels=3, fast_warp=8, bf16_poly=bf16,
                        fi_level_fused=False),
        ekf=EkfConfig(state_dim=6),
        tracks=TrackConfig(num_tracks=32, reinit_every=2),
        impl="pallas", pallas_interpret=True)


@pytest.fixture(scope="module")
def clip():
    frames, _ = moving_blob_clip(num_frames=5, height=128, width=160,
                                 num_points=8, seed=0)
    return frames


@pytest.mark.parametrize("bf16", [False, True])
def test_track_arrays_matches_reference(clip, bf16):
    """Positions agree to <1e-3 px; alive and track_id are identical.
    (misses is carry state, not an output: test_torch_step.py holds it
    identical at every step of this clip and config.)"""
    cfg = slice_config(bf16)
    ref = jax.device_get(jax.jit(jp.track_arrays, static_argnames="cfg")(
        jnp.asarray(clip), cfg))
    got = {k: v.numpy() for k, v in
           tp.track_arrays(torch.from_numpy(clip), cfg).items()}
    assert set(got) == set(ref)
    assert got["pos"].shape == (5, 32, 2)
    assert np.abs(got["pos"] - ref["pos"]).max() < 1e-3
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_array_equal(got["track_id"], ref["track_id"])
    assert np.abs(got["nis"] - ref["nis"]).max() < 1e-3
    assert got["alive"][-1].all()

    # the public entry point returns the shared Trajectories type
    tr = api.track_video(clip, cfg)
    np.testing.assert_array_equal(tr.positions, got["pos"])
    np.testing.assert_array_equal(tr.track_id, got["track_id"])
