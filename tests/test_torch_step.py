"""Step level: a JAX reference Carry from init_from_frame, carried across
with kalman_hydra_tpu_torch.convert, then stepped through both packages'
make_step side by side — on the clean clip, and from a perturbed state
that makes the gate, kill and reseed paths fire."""

import numpy as np
import jax
import pytest
import torch

from kalman_hydra_tpu import pipeline as jp
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu_torch import convert
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


def _plane_tol(ref, bf16):
    """f32 planes agree to 1e-3; bf16 planes to one bf16 ulp (8 bits),
    measured at 2^-6 below that (f32 summation-order noise ~2e-5)."""
    if not bf16:
        return 1e-3
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -6)))
                   - 7)


def _perturb(tracks, cfg):
    """Dead slots 0-3 (reseeded), slots 4-7 one miss from death with a
    velocity jump of 30 px/frame (gated, then killed), slot 8 off frame."""
    t = {f: np.array(getattr(tracks, f)) for f in tracks._fields
         if getattr(tracks, f) is not None}
    t["alive"][0:4] = False
    t["misses"][4:8] = cfg.ekf.max_misses - 1
    t["x"][4:8, 2:4] += 30.0
    t["x"][8, 0] = -50.0
    return tracks._replace(**t)


def _assert_state(tc, jc, tag):
    j = convert.tracks_to_numpy(convert.tracks_to_torch(jc.tracks, "cpu"))
    t = convert.tracks_to_numpy(tc.tracks)
    for f in ("alive", "misses", "track_id"):
        np.testing.assert_array_equal(t[f], j[f], err_msg=f"{tag}: {f}")
    assert np.abs(t["x"] - j["x"]).max() < 1e-3, tag
    assert np.abs(t["P"] - j["P"]).max() < 1e-3, tag
    assert tc.frame_idx == int(jc.frame_idx), tag


@pytest.mark.parametrize("bf16", [False, True])
def test_steps_match_reference(clip, bf16):
    cfg = slice_config(bf16)
    jc0 = jax.device_get(jax.jit(jp.init_from_frame,
                                 static_argnames="cfg")(clip[0], cfg))

    # the port's own init_from_frame reproduces the reference's carry
    tc0 = tp.init_from_frame(torch.from_numpy(clip[0]), cfg)
    ref0 = convert.carry_to_numpy(convert.carry_to_torch(jc0, "cpu"))
    got0 = convert.carry_to_numpy(tc0)
    np.testing.assert_array_equal(got0["prev_gray"], ref0["prev_gray"])
    for f in ("x", "alive", "track_id"):
        np.testing.assert_array_equal(got0["tracks"][f], ref0["tracks"][f])
    np.testing.assert_array_equal(got0["corner_cache"][0],
                                  ref0["corner_cache"][0])
    assert len(got0["prev_rpyr"]) == len(ref0["prev_rpyr"]) == 3
    for g, r in zip(got0["prev_rpyr"], ref0["prev_rpyr"]):
        assert np.all(np.abs(g - r) <= _plane_tol(r, bf16))

    jstep = jax.jit(jp.make_step(cfg))
    tstep = tp.make_step(cfg, "cpu")
    starts = {"clean": jc0,
              "perturbed": jc0._replace(tracks=_perturb(jc0.tracks, cfg))}
    for name, jc in starts.items():
        tc = convert.carry_to_torch(jc, "cpu")
        gated = reseeded = False
        for t in range(1, clip.shape[0]):
            jc, jo = jstep(jc, clip[t])
            tc, to = tstep(tc, torch.from_numpy(clip[t]))
            _assert_state(tc, jax.device_get(jc), f"{name} step {t}")
            nis = np.asarray(jo["nis"])
            assert np.abs(to["nis"].numpy() - nis).max() < 1e-3
            gated |= bool((nis > cfg.ekf.gate_chi2).any())
            reseeded |= bool((np.asarray(jc.tracks.track_id) > 0).any())
        if name == "perturbed":
            assert gated and reseeded, "gate and reseed must fire"
