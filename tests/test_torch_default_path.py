"""The reference's default configuration end to end on the CPU: the
port's track_arrays against the JAX reference's under RunConfig() with
only the tracks shrunk, its bf16 and pe_fused=False variants, the warm
starts (temporal_init, init_velocity) at both warps, explicit seeds; the default `api.track_video` and
`api.track_videos` calls against the reference's own default calls; and
`flow_sequence`'s per-frame and pair-batched branches.

The reference runs its plain XLA route (impl="xla"), except in
flow_sequence's pair-batched bf16 case (its XLA route rounds the bf16
pair path elsewhere): each kernel and route these cases reach is held in
Pallas interpret mode by another test (the exact warp at f32 and bf16,
cold and warm: test_torch_flow_update.py; the exact warp end to end:
test_torch_channels.py's flow_photometric path; K1:
test_torch_kernels.py and test_torch_ekf_route.py; K11:
test_torch_flow_update.py's level-image test; K5's whole-level route:
test_torch_flow_level.py; the pair path: test_torch_pairflow.py's kernel
tests and paths B and C), and a reference jit is mostly compile time,
about half of it at XLA."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu import api as japi
from kalman_hydra_tpu import pipeline as jp
from kalman_hydra_tpu.config import FlowConfig, RunConfig, TrackConfig
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu_torch import api
from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.config import RunConfig as TRunConfig


@pytest.fixture(scope="module")
def clip():
    frames, _ = moving_blob_clip(num_frames=5, height=128, width=160,
                                 num_points=8, seed=0)
    return frames


def _ported(cfg: RunConfig) -> TRunConfig:
    return TRunConfig.from_json(cfg.to_json())


def _base() -> RunConfig:
    """RunConfig() with only the track pool shrunk, run by the reference
    on its plain XLA route (5 levels: the 128x160 plan clamps them to
    3)."""
    return RunConfig(tracks=TrackConfig(num_tracks=32), impl="xla")


def assert_rows(got: dict, ref: dict):
    """Positions and nis < 1e-3, alive and track_id identical."""
    assert np.abs(got["pos"] - ref["pos"]).max() < 1e-3
    assert np.abs(got["nis"] - ref["nis"]).max() < 1e-3
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_array_equal(got["track_id"], ref["track_id"])


def run_both(frames, cfg: RunConfig, seeds=None, got=None):
    """Both packages' track_arrays rows (`got`: the port's, if already
    computed)."""
    ref = jax.device_get(jax.jit(jp.track_arrays,
                                 static_argnames=("cfg", "with_history"))(
        jnp.asarray(frames), cfg,
        seeds=None if seeds is None else jnp.asarray(seeds)))
    if got is None:
        got = {k: v.numpy() for k, v in tp.track_arrays(
            torch.from_numpy(frames), _ported(cfg),
            seeds=None if seeds is None else torch.from_numpy(seeds)).items()}
    assert set(got) == set(ref)
    return got, ref


_WARM = dict(tracks=TrackConfig(num_tracks=32, init_velocity=True))
_CONFIGS = {
    "a_default": {},
    "b_bf16": dict(flow=FlowConfig(bf16_poly=True)),
    "c_pe_fused_off": dict(flow=FlowConfig(pe_fused=False)),
    "d_warm_exact_warp": dict(flow=FlowConfig(temporal_init=True), **_WARM),
    "d_warm_fast_warp_fused": dict(
        flow=FlowConfig(temporal_init=True, fast_warp=8,
                        fi_level_fused=True), **_WARM),
}


@pytest.fixture(scope="module")
def port_rows(clip):
    """The port's track_arrays rows by _CONFIGS name, each computed once
    (two tests read (d) at the exact warp)."""
    cache = {}

    def rows(name):
        if name not in cache:
            cache[name] = {k: v.numpy() for k, v in tp.track_arrays(
                torch.from_numpy(clip),
                _ported(_base().replace(**_CONFIGS[name]))).items()}
        return cache[name]
    return rows


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_track_arrays_matches_reference(clip, name, port_rows):
    """(a) RunConfig() itself, (b) with bf16 planes, (c) at
    pe_fused=False, (d) temporal_init + init_velocity at the exact warp
    and at fast_warp=8 with the whole-level kernel: positions and nis
    < 1e-3, alive and track_id identical."""
    got, ref = run_both(clip, _base().replace(**_CONFIGS[name]),
                        got=port_rows(name))
    assert got["pos"].shape == (5, 32, 2)
    assert_rows(got, ref)
    assert got["alive"][-1].any()


def test_init_velocity_primes_velocity(clip, port_rows):
    """init_velocity seeds the tracks' velocities from the frame 0 -> 1
    flow: the first step then predicts the blobs' motion, so its
    innovations are smaller than from rest."""
    cfg = _ported(_base().replace(**_CONFIGS["d_warm_exact_warp"]))
    cold = tp.track_arrays(torch.from_numpy(clip), cfg.replace(
        tracks=dataclasses.replace(cfg.tracks, init_velocity=False)))
    warm = port_rows("d_warm_exact_warp")
    assert warm["nis"][1].mean() < cold["nis"][1].mean().item()


@pytest.mark.parametrize("pair_batch", [False, True])
def test_seeds_pin_tracks(clip, pair_batch):
    """Explicit seeds replace the corner-pool seeding on the per-frame
    path (RunConfig()) and on the pair path (fast_warp=8): both packages
    start from, and track, the same points."""
    seeds = np.stack(np.meshgrid(np.linspace(20, 140, 8),
                                 np.linspace(20, 108, 4)), -1)
    seeds = seeds.reshape(-1, 2).astype(np.float32)
    cfg = _base()
    if pair_batch:
        cfg = cfg.replace(flow=FlowConfig(fast_warp=8), pair_batch=True)
    got, ref = run_both(clip, cfg, seeds)
    np.testing.assert_allclose(got["pos"][0], seeds)
    assert_rows(got, ref)


def test_default_call_matches_reference(clip):
    """api.track_video(clip) with no config: RunConfig() in both packages
    (the reference runs its default impl="xla"): positions < 1e-3 px,
    alive and track_id identical."""
    ref = japi.track_video(clip)
    got = api.track_video(clip, device="cpu")
    assert got.positions.shape == ref.positions.shape == (5, 256, 2)
    assert np.abs(got.positions - ref.positions).max() < 1e-3
    np.testing.assert_array_equal(got.alive, ref.alive)
    np.testing.assert_array_equal(got.track_id, ref.track_id)
    assert got.smoothed is None and ref.smoothed is None


def test_default_track_videos_matches_reference():
    """api.track_videos with no config: RunConfig() in both packages (the
    reference vmaps its default per-frame pipeline over the clips, the
    port runs them one after another): per clip, positions < 1e-3 px,
    alive and track_id identical."""
    clips = np.stack([moving_blob_clip(num_frames=3, height=96, width=128,
                                       num_points=6, seed=s)[0]
                      for s in (4, 5)])
    ref = japi.track_videos(clips)
    got = api.track_videos(clips, device="cpu")
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.positions.shape == r.positions.shape == (3, 256, 2)
        assert np.abs(g.positions - r.positions).max() < 1e-3
        np.testing.assert_array_equal(g.alive, r.alive)
        np.testing.assert_array_equal(g.track_id, r.track_id)


def _flow_seq_cfgs():
    """flow_sequence's two branches: the per-frame chain on the
    reference's XLA route, the pair-batched branch with bf16 planes in
    interpret mode (the XLA route rounds the bf16 pair path elsewhere)."""
    return {
        "per_frame_temporal": RunConfig(
            flow=FlowConfig(levels=3, temporal_init=True), impl="xla"),
        "pair_batch_fast_warp": RunConfig(
            flow=FlowConfig(levels=3, fast_warp=8, bf16_poly=True),
            impl="pallas", pallas_interpret=True, pair_batch=True),
    }


@pytest.mark.parametrize("name", sorted(_flow_seq_cfgs()))
def test_flow_sequence_matches_reference(clip, name):
    """api.flow_sequence: the per-frame chain with temporal_init (pair 0
    cold, each pair's flow seeding the next) and the pair-batched branch
    at fast_warp=8: every pair's flow < 1e-3 px."""
    cfg = _flow_seq_cfgs()[name]
    ref = np.asarray(jp.flow_sequence(jnp.asarray(clip), cfg, False))
    got = api.flow_sequence(clip, _ported(cfg), device="cpu")
    assert got.shape == ref.shape == (4, 128, 160, 2)
    assert np.abs(got - ref).max() < 1e-3


def test_flow_sequence_lk_raises(clip):
    """flow_sequence with dense LK (inside the slice since the port's LK
    slice; FlowConfig(method="lk_dense") otherwise default) against the
    reference's, every pair < 1e-3 px; sparse LK has no dense flow and
    raises the reference's ValueError."""
    cfg = RunConfig(flow=FlowConfig(method="lk_dense"))
    ref = np.asarray(jp.flow_sequence(jnp.asarray(clip), cfg, False))
    got = api.flow_sequence(clip, _ported(cfg), device="cpu")
    assert got.shape == ref.shape == (4, 128, 160, 2)
    assert np.abs(got - ref).max() < 1e-3
    with pytest.raises(ValueError, match="dense flow required"):
        api.flow_sequence(clip, TRunConfig(
            flow=TRunConfig().flow.__class__(method="lk_sparse")),
            device="cpu")
