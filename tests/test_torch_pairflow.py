"""The pair-batched kernels (K6 flow_iter_pairs, K7a
poly_expansion_planar_batch, K7b coarse_polyexp_fused_batch, K8-pairs
flow_update_pairs) and paths B (pair_batch, one clip), C (several clips
chained) and BX (pair_batch at the exact warp, fast_warp=0) against the
JAX reference (Pallas in interpret mode on the CPU; the reference's
exact-warp pair path is plain XLA).

On the CPU each wrapper runs its plain version, so these tests pin the
arithmetic that the CUDA kernels are held to on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu import pipeline as jp
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu.kernels.flow_iter_pallas import (
    flow_iter_pairs as fip_pl, prep_planes)
from kalman_hydra_tpu.kernels.level_image_pallas import (
    coarse_polyexp_fused_batch as coarse_b_pl)
from kalman_hydra_tpu.kernels.polyexp_pallas import (
    poly_expansion_planar_batch as pe_b_pl)
from kalman_hydra_tpu.ops.color import grayscale_u8 as j_gray
from kalman_hydra_tpu.ops.farneback import (
    farneback_pairs_from_pyramids as j_pairs,
    polyexp_pyramid_batch as j_pyr_b)
from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.config import RunConfig as TRunConfig
from kalman_hydra_tpu_torch.config import FlowConfig as TFlowConfig
from kalman_hydra_tpu_torch.kernels import (coarse_polyexp_fused_batch,
                                            flow_iter_pairs,
                                            flow_update_pairs,
                                            poly_expansion_planar_batch)
from kalman_hydra_tpu_torch.kernels.flow_update import flow_update_plain
from kalman_hydra_tpu_torch.ops.farneback import (
    farneback_pairs_from_pyramids)
from kalman_hydra_tpu_torch.ops.warp import warp_poly_planar


def _np(a):
    a = np.array(a)                     # a writable copy
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _bf16_ulp(x):
    """One bf16 ulp at |x|, taken at 2^-6 below that (the f32 moment
    sums' own summation-order noise, test_torch_kernels.py)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -6)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("clip_len", [0, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flow_iter_pairs_matches_pallas(clip_len, dtype, rng):
    """K6 over 6 frames: 5 pairs, or two chained 3-frame clips (4 pairs,
    none straddling the clips); D=8, flows beyond the clamp: < 1e-4. The
    JAX kernel takes prep_planes' padded slabs (ops/farneback.py
    prepares them so), the port unpadded planes."""
    h, w, D, win, N = 48, 64, 8, 15, 6
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    R = jnp.asarray(rng.normal(size=(N, 5, h, w)).astype(np.float32)).astype(
        jdt)
    B = (N // clip_len) * (clip_len - 1) if clip_len else N - 1
    fl = rng.uniform(-10, 10, (B, 2, h, w)).astype(np.float32)
    Rp = jax.vmap(lambda r: prep_planes(r, win, D))(R)
    ref = np.asarray(fip_pl(Rp, jnp.asarray(fl), win, D, (h, w),
                            clip_len=clip_len, interpret=True))
    got = flow_iter_pairs(torch.from_numpy(_np(R)).to(getattr(torch, dtype)),
                          torch.from_numpy(fl), win, D, False, clip_len)
    assert got.shape == (B, 2, h, w) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() < 1e-4


@pytest.mark.parametrize("n,pairs,clip_len", [(6, 4, 0), (6, 6, 0),
                                              (6, 5, 3), (9, 5, 3)])
def test_flow_iter_pairs_rejects_wrong_pair_count(n, pairs, clip_len):
    """A pair count that does not match the stack raises as the
    reference does."""
    R = torch.zeros(n, 5, 8, 8)
    fl = torch.zeros(pairs, 2, 8, 8)
    with pytest.raises(ValueError, match="pairs"):
        flow_iter_pairs(R, fl, 5, 2, False, clip_len)
    Rp = jnp.zeros((n, 5) + prep_planes(jnp.zeros((5, 8, 8)), 5, 2).shape[1:])
    with pytest.raises(ValueError, match="pairs"):
        fip_pl(Rp, jnp.zeros((pairs, 2, 8, 8)), 5, 2, (8, 8),
               clip_len=clip_len, interpret=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_polyexp_batch_matches_pallas(dtype, rng):
    """K7a, 3 frames of 100x130: f32 < 1e-3; bf16 within one bf16 ulp."""
    imgs = rng.uniform(0, 255, (3, 100, 130)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = _np(pe_b_pl(jnp.asarray(imgs), 5, 1.1, out_dtype=jdt,
                      interpret=True))
    got = poly_expansion_planar_batch(torch.from_numpy(imgs), 5, 1.1,
                                      out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    got = got.to(torch.float32).numpy()
    assert got.shape == ref.shape == (3, 5, 100, 130)
    if dtype == "float32":
        assert np.abs(got - ref).max() < 1e-3
    else:
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref))


@pytest.mark.parametrize("shape", [(150, 200), (256, 256)])
def test_coarse_polyexp_batch_matches_pallas(shape, rng):
    """K7b, 3 frames, levels=3: < 1e-3 on every coarse level."""
    imgs = rng.uniform(0, 255, (3,) + shape).astype(np.float32)
    ref = coarse_b_pl(jnp.asarray(imgs), 3, 0.5, 5, 1.1, interpret=True)
    got = coarse_polyexp_fused_batch(torch.from_numpy(imgs), 3, 0.5, 5, 1.1)
    assert len(got) == len(ref) >= 2
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.shape[:2] == (3, 5)
        assert np.abs(np.asarray(r) - g.numpy()).max() < 1e-3


def pair_config(bf16: bool) -> RunConfig:
    """The pair path's settings at 96x128 (3 levels), K=24, with a
    corner-pool refresh every 2 frames (the cadence the pool sequence
    must reproduce)."""
    return RunConfig(
        flow=FlowConfig(levels=3, fast_warp=8, bf16_poly=bf16),
        ekf=EkfConfig(state_dim=6),
        tracks=TrackConfig(num_tracks=24, reinit_every=2),
        impl="pallas", pallas_interpret=True, pair_batch=True)


def _clip(seed=0, t=5):
    frames, _ = moving_blob_clip(num_frames=t, height=96, width=128,
                                 num_points=6, seed=seed)
    return frames


def _assert_rows(got, ref):
    assert np.abs(got["pos"] - ref["pos"]).max() < 1e-3
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_array_equal(got["track_id"], ref["track_id"])
    assert np.abs(got["nis"] - ref["nis"]).max() < 1e-3


@pytest.mark.parametrize("bf16", [False, True])
def test_path_b_matches_reference(bf16):
    """Path B: track_arrays with pair_batch on both sides; positions
    < 1e-3 px, alive and track_id identical."""
    clip = _clip()
    cfg = pair_config(bf16)
    ref = jax.device_get(jax.jit(jp.track_arrays, static_argnames="cfg")(
        jnp.asarray(clip), cfg))
    got = {k: v.numpy() for k, v in tp.track_arrays(
        torch.from_numpy(clip), TRunConfig.from_json(cfg.to_json())).items()}
    assert got["pos"].shape == (5, 24, 2)
    _assert_rows(got, ref)
    assert got["alive"][-1].any()


def test_path_c_matches_reference():
    """Path C: two clips chained through shared launches (clip_len) on
    both sides; per clip, positions < 1e-3 px, alive and track_id
    identical."""
    clips = np.stack([_clip(0), _clip(1)])
    cfg = pair_config(True)
    ref = jax.device_get(jax.jit(jp.track_clips_pairflow,
                                 static_argnames="cfg")(
        jnp.asarray(clips), cfg))
    got = {k: v.numpy() for k, v in tp.track_clips_pairflow(
        torch.from_numpy(clips), TRunConfig.from_json(cfg.to_json())).items()}
    assert got["pos"].shape == (2, 5, 24, 2)
    for b in range(2):
        _assert_rows({k: v[b] for k, v in got.items()},
                     {k: v[b] for k, v in ref.items()})


@pytest.mark.parametrize("T,reinit_every", [(40, 4), (67, 1)])
def test_pair_path_equals_per_frame_path_on_long_clips(T, reinit_every):
    """With no frame chunks, the pair path over 40 and 67 frames gives the
    per-frame path's trajectories (fi_level_fused=False, the reference
    pair path's own flow graph): positions < 1e-3 px, alive and track_id
    identical. Port only, 48x64, K=8."""
    frames, _ = moving_blob_clip(num_frames=T, height=48, width=64,
                                 num_points=4, seed=2)
    cfg = tp.main_path_config(8)
    cfg = cfg.replace(
        flow=cfg.flow.__class__(fast_warp=8, bf16_poly=True,
                                fi_level_fused=False),
        tracks=cfg.tracks.__class__(num_tracks=8, corner_pool=256,
                                    reinit_every=reinit_every))
    x = torch.from_numpy(frames)
    a = tp.track_arrays(x, cfg)
    b = tp.track_arrays(x, cfg.replace(pair_batch=True))
    assert b["pos"].shape == (T, 8, 2)
    assert (a["pos"] - b["pos"]).abs().max().item() < 1e-3
    assert torch.equal(a["alive"], b["alive"])
    assert torch.equal(a["track_id"], b["track_id"])


@pytest.mark.parametrize("clip_len", [0, 3])
def test_flow_update_pairs_is_per_pair_flow_update(clip_len, rng):
    """K8-pairs' plain version equals per-pair K8 bit for bit (f32, no
    rounding), pair b reading frames p and p + 1 of the stack, the gather
    in K8; with round_m it rounds M to bf16 (a different, close result);
    a wrong pair count is refused."""
    N, h, w = 6, 20, 28
    Rall = torch.from_numpy(rng.normal(size=(N, 5, h, w)).astype(
        np.float32))
    B = N - 1 if not clip_len else (N // clip_len) * (clip_len - 1)
    fl = torch.from_numpy(rng.uniform(-3, 3, (B, 2, h, w)).astype(
        np.float32))
    got = flow_update_pairs(Rall, fl, 15, False, clip_len)
    frames = [b + b // (clip_len - 1) if clip_len else b for b in range(B)]
    want = torch.stack([flow_update_plain(Rall[p], Rall[p + 1], fl[b], 15)
                        for b, p in enumerate(frames)])
    assert torch.equal(got, want)
    rounded = flow_update_pairs(Rall, fl, 15, False, clip_len,
                                round_m=True)
    assert not torch.equal(rounded, got)
    assert (rounded - got).abs().max().item() < 0.1
    with pytest.raises(ValueError, match="pairs"):
        flow_update_pairs(Rall, fl[:-1], 15, False, clip_len)


def test_warp_poly_planar_batched_is_per_pair(rng):
    """The exact gather over a leading pair dimension equals the per-pair
    gather bit for bit."""
    R1 = torch.from_numpy(rng.normal(size=(3, 5, 17, 23)).astype(
        np.float32)).to(torch.bfloat16)
    fl = torch.from_numpy(rng.uniform(-30, 30, (3, 2, 17, 23)).astype(
        np.float32))
    got = warp_poly_planar(R1, fl)
    assert got.dtype == torch.float32
    for b in range(3):
        assert torch.equal(got[b], warp_poly_planar(R1[b], fl[b]))


@pytest.mark.parametrize("clip_len,bf16", [(0, False), (5, True)])
def test_pair_exact_warp_flow_matches_reference(clip_len, bf16):
    """farneback_pairs_from_pyramids at fast_warp=0 (the exact gather and
    K8-pairs, M rounded to bf16 with bf16 planes as the reference's
    update_matrices_p stores it) against the reference's vmapped XLA
    pair path on its own planes: < 1e-4."""
    clip = _clip()
    frames = np.concatenate([clip, clip[::-1]]) if clip_len else clip
    cfg = FlowConfig(levels=3, bf16_poly=bf16)
    Rs = j_pyr_b(j_gray(jnp.asarray(frames)), cfg, impl="pallas",
                 interpret=True)
    ref = np.asarray(j_pairs(Rs, cfg, clip_len=clip_len, impl="pallas",
                             interpret=True))
    dt = torch.bfloat16 if bf16 else torch.float32
    got = farneback_pairs_from_pyramids(
        tuple(torch.from_numpy(_np(r)).to(dt) for r in Rs),
        TFlowConfig(levels=3, bf16_poly=bf16), clip_len=clip_len).numpy()
    assert got.shape == ref.shape == (8 if clip_len else 4, 96, 128, 2)
    assert np.abs(got - ref).max() < 1e-4


def exact_pair_config(bf16: bool) -> RunConfig:
    """Path BX: the reference's defaults (the exact warp), pair-batched,
    at 96x128 (3 levels), K=24, a corner-pool refresh every 2 frames."""
    return RunConfig(flow=FlowConfig(levels=3, bf16_poly=bf16),
                     tracks=TrackConfig(num_tracks=24, reinit_every=2),
                     impl="pallas", pallas_interpret=True, pair_batch=True)


@pytest.mark.parametrize("bf16", [False, True])
def test_path_bx_matches_reference(bf16):
    """Path BX: track_arrays (pair-batched, exact warp) on both sides;
    positions < 1e-3 px, alive and track_id identical."""
    clip = _clip()
    cfg = exact_pair_config(bf16)
    ref = jax.device_get(jax.jit(jp.track_arrays, static_argnames="cfg")(
        jnp.asarray(clip), cfg))
    got = {k: v.numpy() for k, v in tp.track_arrays(
        torch.from_numpy(clip), TRunConfig.from_json(cfg.to_json())).items()}
    assert got["pos"].shape == (5, 24, 2)
    _assert_rows(got, ref)
    assert got["alive"][-1].any()


def test_path_cx_matches_reference():
    """Two clips chained through shared K8-pairs launches (clip_len) at
    the exact warp on both sides: per clip, positions < 1e-3 px, alive
    and track_id identical."""
    clips = np.stack([_clip(0), _clip(1)])
    cfg = exact_pair_config(False)
    ref = jax.device_get(jax.jit(jp.track_clips_pairflow,
                                 static_argnames="cfg")(
        jnp.asarray(clips), cfg))
    got = {k: v.numpy() for k, v in tp.track_clips_pairflow(
        torch.from_numpy(clips), TRunConfig.from_json(cfg.to_json())).items()}
    for b in range(2):
        _assert_rows({k: v[b] for k, v in got.items()},
                     {k: v[b] for k, v in ref.items()})


def test_exact_pair_path_equals_per_frame_path():
    """At f32 the exact-warp pair path gives the per-frame path's
    trajectories (the same gather and K8 arithmetic per pair): positions
    < 1e-3 px, alive and track_id identical. Port only, 48x64, T=12."""
    frames, _ = moving_blob_clip(num_frames=12, height=48, width=64,
                                 num_points=4, seed=2)
    cfg = TRunConfig.from_json(exact_pair_config(False).to_json())
    x = torch.from_numpy(frames)
    a = tp.track_arrays(x, cfg.replace(pair_batch=False))
    b = tp.track_arrays(x, cfg)
    assert (a["pos"] - b["pos"]).abs().max().item() < 1e-3
    assert torch.equal(a["alive"], b["alive"])
    assert torch.equal(a["track_id"], b["track_id"])


def test_flow_sequence_pair_exact_warp_matches_reference():
    """api.flow_sequence with RunConfig(pair_batch=True) (the exact warp,
    pair-batched) gives the reference's flows (< 1e-4)."""
    from kalman_hydra_tpu_torch import api
    clip = _clip(t=4)
    cfg = RunConfig(flow=FlowConfig(levels=2), pair_batch=True)
    ref = np.asarray(jax.jit(jp.flow_sequence, static_argnames="cfg")(
        jnp.asarray(clip), cfg))
    got = api.flow_sequence(clip, TRunConfig.from_json(cfg.to_json()),
                            device="cpu")
    assert got.shape == ref.shape == (3, 96, 128, 2)
    assert np.abs(got - ref).max() < 1e-4
