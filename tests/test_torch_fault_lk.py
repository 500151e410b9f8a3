"""Lucas-Kanade at 10 levels (past the 8 levels one K10 launch or one
K12 walk takes) against the JAX package on the CPU: sparse pyrLK and
dense LK on frames 0 and 1 of a 96x128 moving-blob clip, whose 10-level
pyramid runs down to 1x1. (On a random-texture pair a pyramid that deep
sends some points tens of pixels off, where f32 summation order can move
the two packages' answers apart past the bar; the clip's smooth blobs
keep every point tracked.) The launch splits are pinned in
test_torch_fault_levels.py; the kernels run on the card, in
chip_smoke.py's F5 phase."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalman_hydra_tpu.config import FlowConfig
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu.ops import lk as jlk
from kalman_hydra_tpu_torch.config import FlowConfig as TFlowConfig
from kalman_hydra_tpu_torch.ops import lk as tlk

_RNG = np.random.default_rng(11)
_PTS = np.stack([_RNG.uniform(12, 115, 24), _RNG.uniform(12, 83, 24)],
                -1).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    frames, _ = moving_blob_clip(num_frames=2, height=96, width=128,
                                 num_points=8, seed=0)
    gray = frames.astype(np.float32) @ np.float32([0.299, 0.587, 0.114])
    return gray[0], gray[1]


def _t(cfg: FlowConfig) -> TFlowConfig:
    return TFlowConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("halo", (0, 8))
def test_lk_sparse_at_10_levels_matches_reference(pair, halo):
    """Sparse pyrLK at levels 10 (halo 0, the exact window; halo 8 with
    the block-halo solver): status identical, every point tracked,
    < 1e-3 px."""
    cfg = FlowConfig(method="lk_sparse", levels=10, lk_block_halo=halo,
                     lk_solver="blockhalo")
    ref, ref_st = jax.jit(lambda x, y, p: jlk.lk_sparse(x, y, p, cfg))(
        *(jnp.asarray(v) for v in pair + (_PTS,)))
    got, st = tlk.lk_sparse(*(torch.from_numpy(v) for v in pair + (_PTS,)),
                            _t(cfg))
    ref_st = np.asarray(ref_st)
    np.testing.assert_array_equal(st.numpy(), ref_st)
    assert ref_st.all()
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-3


def test_lk_dense_at_10_levels_matches_reference(pair):
    """Dense LK at levels 10, fast warp 8: mean EPE < 1e-3 px."""
    cfg = FlowConfig(method="lk_dense", levels=10, fast_warp=8)
    a, b = pair
    ref = np.asarray(jax.jit(lambda x, y: jlk.lk_dense(x, y, cfg))(
        jnp.asarray(a), jnp.asarray(b)))
    got = tlk.lk_dense(torch.from_numpy(a), torch.from_numpy(b),
                       _t(cfg)).numpy()
    epe = np.linalg.norm(got - ref, axis=-1)
    assert got.shape == ref.shape == (96, 128, 2)
    assert epe.mean() < 1e-3
