"""Farneback windows past 61 taps against the JAX package on the CPU
(Pallas in interpret mode): the exact-warp setting (fast_warp 0, K8 on
every level iteration) end to end at winsize 63, 81 and 101, and the two
iterations alone, K2 (the select-sum warp) and K8 (the exact gather).
test_torch_fault_window.py holds the plans and the fast-warp setting."""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalman_hydra_tpu.config import FlowConfig
from kalman_hydra_tpu.io.synthetic import translating_pair
from kalman_hydra_tpu.kernels.flow_iter_pallas import flow_iter as fi_pl
from kalman_hydra_tpu.kernels.flow_update_pallas import (
    flow_update as fu_pl)
from kalman_hydra_tpu.ops import farneback as FB
from kalman_hydra_tpu_torch.config import FlowConfig as TFlowConfig
from kalman_hydra_tpu_torch.ops import farneback as TFB

fi = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_iter")
fu = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_update")

WIDE = (63, 81, 101)


@pytest.mark.parametrize("winsize", WIDE)
def test_wide_window_exact_warp_flow_matches_reference(winsize):
    """The F3 setting at fast_warp 0 (the reference's default warp) end to
    end, 2 levels, against the reference's impl="pallas" in interpret
    mode: < 1e-3 px."""
    a, b, _ = translating_pair(height=96, width=128, shift=(2.0, -1.5),
                               seed=0)
    kw = dict(levels=2, winsize=winsize, fast_warp=0)
    ref = np.asarray(FB.farneback(jnp.asarray(a), jnp.asarray(b),
                                  FlowConfig(**kw), impl="pallas",
                                  interpret=True))
    got = TFB.farneback(torch.from_numpy(a).float(),
                        torch.from_numpy(b).float(), TFlowConfig(**kw))
    assert np.abs(got.numpy() - ref).max() < 1e-3


@pytest.mark.parametrize("winsize", WIDE)
def test_wide_window_iterations_match_pallas(winsize, rng):
    """K2 (select-sum warp, D = 8) and K8 (the exact gather, which the
    reference leaves to XLA before its kernel) at wide windows, 48x64 f32,
    flows beyond the clamp: < 1e-4 against the Pallas kernels in
    interpret mode."""
    h, w = 48, 64
    R0 = rng.normal(size=(5, h, w)).astype(np.float32)
    R1 = rng.normal(size=(5, h, w)).astype(np.float32)
    fl = rng.uniform(-10, 10, (2, h, w)).astype(np.float32)
    ref = np.asarray(fi_pl(jnp.asarray(R0), jnp.asarray(R1), jnp.asarray(fl),
                           winsize, 8, interpret=True))
    got = fi.flow_iter(*(torch.from_numpy(a) for a in (R0, R1, fl)),
                       winsize, 8)
    assert np.abs(got.numpy() - ref).max() < 1e-4
    fl2 = fl * 0.2
    R1w = FB._warp_poly_planar(jnp.asarray(R1), jnp.asarray(fl2))
    ref = np.asarray(fu_pl(jnp.asarray(R0), R1w.astype(jnp.float32),
                           jnp.asarray(fl2), winsize, interpret=True))
    got = fu.flow_update(*(torch.from_numpy(a) for a in (R0, R1, fl2)),
                         winsize)
    assert np.abs(got.numpy() - ref).max() < 1e-4
