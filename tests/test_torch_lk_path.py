"""The Lucas-Kanade paths of the port against the JAX reference on the
CPU: track_arrays with lk_sparse (halo 8 with corr_conv, the 6-state
filter and a cached corner pool) and with lk_dense at the exact warp
with init_velocity, against the reference's track_arrays; lk_dense per
frame, pair-batched and multi-clip against the reference's
track_clips_pairflow; lk_sparse at halo 0 step by step against the
reference's make_step, with its Carry taken mid-clip and continued in
the port. Each reference run is
jitted once (its compile is most of these tests' time)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu import pipeline as jp
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu_torch import convert
from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.config import RunConfig as TRunConfig


@pytest.fixture(scope="module")
def clip():
    frames, _ = moving_blob_clip(num_frames=5, height=96, width=128,
                                 num_points=8, seed=0)
    return frames


def _ported(cfg: RunConfig) -> TRunConfig:
    return TRunConfig.from_json(cfg.to_json())


_TR = TrackConfig(num_tracks=16, corner_pool=64, reinit_every=1)
_SPARSE = FlowConfig(method="lk_sparse", levels=2)
_DENSE = FlowConfig(method="lk_dense", levels=2, fast_warp=8)
_CASES = {
    "sparse_halo8_corr_conv": RunConfig(
        flow=dataclasses.replace(_SPARSE, lk_block_halo=8,
                                 lk_solver="corr_conv"),
        ekf=EkfConfig(state_dim=6),
        tracks=dataclasses.replace(_TR, reinit_every=2)),
    "dense_init_velocity_exact_warp": RunConfig(
        flow=dataclasses.replace(_DENSE, fast_warp=0),
        tracks=dataclasses.replace(_TR, init_velocity=True)),
}


def _same(got: dict, ref: dict) -> None:
    """Positions (and smoothed positions) < 1e-3 px, alive and track_id
    identical, some tracks alive at the end."""
    assert sorted(ref) == sorted(got)
    for k in ("pos", "smoothed"):
        if k in ref:
            err = np.abs(got[k].numpy() - ref[k]).max()
            assert err < 1e-3, (k, err)
    np.testing.assert_array_equal(got["alive"].numpy(), ref["alive"])
    np.testing.assert_array_equal(got["track_id"].numpy(), ref["track_id"])
    assert ref["alive"][-1].any()


@pytest.mark.parametrize("name", sorted(_CASES))
def test_lk_track_arrays_matches_reference(clip, name):
    cfg = _CASES[name]
    ref = jax.jit(lambda f: jp.track_arrays(f, cfg))(jnp.asarray(clip))
    _same(tp.track_arrays(torch.from_numpy(clip), _ported(cfg)),
          jax.device_get(ref))


@pytest.fixture(scope="module")
def dense_clips_ref(clip):
    """The reference's track_clips_pairflow over the clip and its
    reverse, lk_dense: clip 0's outputs are also what its
    track_arrays_pairflow and track_arrays give for the clip (the same
    _track_from_pair_flows over the same vmapped lk_dense, and the
    per-frame scan the reference holds them to)."""
    cfg = RunConfig(flow=_DENSE, tracks=_TR, pair_batch=True)
    frames = np.stack([clip, clip[::-1].copy()])
    ref = jax.jit(lambda f: jp.track_clips_pairflow(f, cfg))(
        jnp.asarray(frames))
    return cfg, frames, jax.device_get(ref)


@pytest.mark.parametrize("path", ["per_frame", "pair_batch", "multi_clip"])
def test_lk_dense_paths_match_reference(dense_clips_ref, path):
    """lk_dense per frame (track_arrays), pair-batched
    (track_arrays_pairflow, a loop over the pairs) and multi-clip
    (track_clips_pairflow) against the reference's multi-clip run."""
    cfg, frames, ref = dense_clips_ref
    tcfg = _ported(cfg)
    if path == "multi_clip":
        _same(tp.track_clips_pairflow(torch.from_numpy(frames), tcfg), ref)
        return
    if path == "per_frame":
        tcfg = tcfg.replace(pair_batch=False)
    got = tp.track_arrays(torch.from_numpy(frames[0]), tcfg)
    _same(got, {k: v[0] for k, v in ref.items()})


def test_lk_sparse_steps_and_carry_match_reference(clip):
    """lk_sparse at halo 0, step by step: the reference's init_from_frame
    and make_step against the port's track_arrays (positions, nis < 1e-3
    px; alive and track_id identical at every step); and the reference's
    Carry after two steps (prev_rpyr holding (pyr, grads)) crossing into
    the port with convert.carry_to_torch and back unchanged, then
    continued by the port's make_step to the reference's outputs."""
    cfg = RunConfig(flow=_SPARSE, tracks=_TR)
    jstep = jax.jit(jp.make_step(cfg))
    jc = jax.jit(jp.init_from_frame, static_argnames="cfg")(clip[0], cfg)
    got = tp.track_arrays(torch.from_numpy(clip), _ported(cfg))
    carries = []
    for t in range(1, clip.shape[0]):
        jc, jo = jstep(jc, clip[t])
        jo = jax.device_get(jo)
        carries.append(jax.device_get(jc))
        for k in ("pos", "nis"):
            assert np.abs(got[k][t].numpy() - jo[k]).max() < 1e-3, (t, k)
        for k in ("alive", "track_id"):
            np.testing.assert_array_equal(got[k][t].numpy(), jo[k])
    assert got["alive"][-1].any()
    jc = carries[1]
    pyr, grads = jc.prev_rpyr
    assert len(pyr) == len(grads) == 2 and len(grads[0]) == 2
    tc = convert.carry_to_torch(jc, "cpu")
    back = convert.carry_to_numpy(tc)
    for a, b in zip(jax.tree_util.tree_leaves(back["prev_rpyr"]),
                    jax.tree_util.tree_leaves(jc.prev_rpyr)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tstep = tp.make_step(_ported(cfg), "cpu")
    for t in (3, 4):
        tc, to = tstep(tc, torch.from_numpy(clip[t]))
        for k in ("pos", "nis"):
            assert np.abs(to[k].numpy() - got[k][t].numpy()).max() \
                < 1e-3, (t, k)
        np.testing.assert_array_equal(to["track_id"].numpy(),
                                      got["track_id"][t].numpy())
