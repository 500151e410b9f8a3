"""End to end: the port's track_arrays against the JAX reference's
track_arrays (fi_level_fused=False) on the same clip, in f32 and with
bf16 polyexp planes. With bf16 planes the reference runs its Pallas
kernels in interpret mode (its XLA route rounds elsewhere), and this
case and test_torch_step.py's hold the unfused fast-warp route there; in
f32 its plain XLA route (test_torch_kernels.py holds K2, K3, K4 and K1
at f32 in interpret mode). A reference jit is mostly compile time, about
half of it at XLA."""

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
from kalman_hydra_tpu_torch.config import RunConfig as TRunConfig


def slice_config(bf16: bool) -> RunConfig:
    """The main path's settings at 128x160 (3 levels), K=32; the
    reference in interpret mode at bf16, on its XLA route at f32."""
    return RunConfig(
        flow=FlowConfig(levels=3, fast_warp=8, bf16_poly=bf16,
                        fi_level_fused=False),
        ekf=EkfConfig(state_dim=6),
        tracks=TrackConfig(num_tracks=32, reinit_every=2),
        impl="pallas" if bf16 else "xla", pallas_interpret=True)


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
    tcfg = TRunConfig.from_json(cfg.to_json())
    ref = jax.device_get(jax.jit(jp.track_arrays, static_argnames="cfg")(
        jnp.asarray(clip), cfg))
    got = {k: v.numpy() for k, v in
           tp.track_arrays(torch.from_numpy(clip), tcfg).items()}
    assert set(got) == set(ref)
    assert got["pos"].shape == (5, 32, 2)
    assert np.abs(got["pos"] - ref["pos"]).max() < 1e-3
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_array_equal(got["track_id"], ref["track_id"])
    assert np.abs(got["nis"] - ref["nis"]).max() < 1e-3
    assert got["alive"][-1].all()

    # the public entry point, asked for the CPU, gives the same rows
    tr = api.track_video(clip, tcfg, device="cpu")
    np.testing.assert_array_equal(tr.positions, got["pos"])
    np.testing.assert_array_equal(tr.track_id, got["track_id"])
