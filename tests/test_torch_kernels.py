"""The port's four kernel modules against the JAX reference's Pallas
kernels (interpret mode on the CPU), on identical NumPy inputs.

On the CPU each wrapper runs its plain PyTorch version, so these tests pin
the arithmetic that the CUDA kernels are held to on the card
(chip_smoke.py compares kernel and plain version there)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu.config import EkfConfig
from kalman_hydra_tpu.kernels.ekf_pallas import ekf_fused_step as ekf_pl
from kalman_hydra_tpu.kernels.flow_iter_pallas import flow_iter as fi_pl
from kalman_hydra_tpu.kernels.level_image_pallas import (
    _band_mats_padded, coarse_polyexp_fused as coarse_pl)
from kalman_hydra_tpu.kernels.polyexp_pallas import (
    poly_expansion_planar as pe_pl)
from kalman_hydra_tpu.models import dynamics as jdyn
from kalman_hydra_tpu_torch.kernels import (coarse_polyexp_fused,
                                            ekf_fused_step, flow_iter,
                                            poly_expansion_planar)
from kalman_hydra_tpu_torch.kernels.level_image import level_tables
from kalman_hydra_tpu_torch.models import dynamics as tdyn


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits). The f32 moment sums of
    u8-scale images carry ~2e-5 absolute noise (summation order), so below
    |x| = 2^-6 the ulp is taken at 2^-6 (1.2e-4): a smaller one would
    measure that noise, not the bf16 rounding."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -6)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("state_dim", [4, 6])
@pytest.mark.parametrize("per_track_H", [False, True])
def test_ekf_matches_pallas(state_dim, per_track_H, rng):
    """K1 at K=200 (a ragged tail for any tile), both H forms: <1e-4."""
    cfg = EkfConfig(state_dim=state_dim)
    K, n = 200, state_dim
    F, Q = jdyn.transition(cfg), jdyn.process_noise(cfg)
    np.testing.assert_array_equal(F, tdyn.transition(cfg))
    np.testing.assert_array_equal(Q, tdyn.process_noise(cfg))
    x = rng.normal(size=(K, n)).astype(np.float32) * 5
    A = rng.normal(size=(K, n, n)).astype(np.float32)
    P = (A @ A.transpose(0, 2, 1) + np.eye(n, dtype=np.float32)).astype(
        np.float32)
    y = rng.normal(size=(K, 2)).astype(np.float32) * 2
    H = jdyn.position_H(cfg)
    if per_track_H:
        H = (H[None] + 0.1 * rng.normal(size=(K, 2, n))).astype(np.float32)
    ref = ekf_pl(jnp.asarray(x), jnp.asarray(P), jnp.asarray(y),
                 jnp.asarray(H), F, Q, cfg.r, interpret=True)
    got = ekf_fused_step(_t(x), _t(P), _t(y), _t(H), F, Q, cfg.r)
    for r, g in zip(ref, got):
        assert np.abs(np.asarray(r) - g.numpy()).max() < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_polyexp_matches_pallas(dtype, rng):
    """K3 at 100x130: f32 <1e-3; bf16 within one bf16 ulp."""
    img = rng.uniform(0, 255, (100, 130)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = _np(pe_pl(jnp.asarray(img), 5, 1.1, out_dtype=jdt,
                    interpret=True))
    got = poly_expansion_planar(_t(img), 5, 1.1,
                                out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    got = got.to(torch.float32).numpy()
    assert got.shape == ref.shape == (5, 100, 130)
    if dtype == "float32":
        assert np.abs(got - ref).max() < 1e-3
    else:
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref))


@pytest.mark.parametrize("shape", [(150, 200), (256, 256)])
def test_coarse_polyexp_matches_pallas(shape, rng):
    """K4, levels=3: the per-stage plain version vs the band-matrix
    kernel, <1e-3 on every coarse level."""
    img = rng.uniform(0, 255, shape).astype(np.float32)
    ref = coarse_pl(jnp.asarray(img), 3, 0.5, 5, 1.1, interpret=True)
    got = coarse_polyexp_fused(_t(img), 3, 0.5, 5, 1.1)
    assert len(got) == len(ref) >= 2
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        assert np.abs(np.asarray(r) - g.numpy()).max() < 1e-3


@pytest.mark.parametrize("shape,levels", [((150, 200), 3), ((256, 256), 3),
                                          ((1080, 1920), 5)])
def test_level_tap_tables_are_the_band_matrices(shape, levels):
    """The CUDA K4's tap tables hold exactly the reference's padded band
    matrices (entry for entry, float32), including the 79-tap 1080p
    level."""
    h, w = shape
    n = 5
    mats = [m for m in _band_mats_padded(h, w, levels, 0.5, n)
            if m is not None]
    tabs = level_tables(h, w, levels, 0.5, n)
    assert len(tabs) == len(mats)
    for (V, HmT), (lh, lw, iv, wv, ih, wh) in zip(mats, tabs):
        assert V.shape == (lh + 2 * n, h) and HmT.shape == (w, lw + 2 * n)
        Vt = np.zeros_like(V)
        np.add.at(Vt, (np.arange(V.shape[0])[:, None], iv), wv)
        Ht = np.zeros_like(HmT.T)
        np.add.at(Ht, (np.arange(Ht.shape[0])[:, None], ih), wh)
        np.testing.assert_array_equal(Vt, V)
        np.testing.assert_array_equal(Ht, HmT.T)


@pytest.mark.parametrize("win,gaussian", [(15, False), (13, False),
                                          (15, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flow_iter_matches_pallas(win, gaussian, dtype, rng):
    """K2 at 70x90, D=8, flows beyond the clamp: <1e-4 in f32 and with
    bf16 planes (both sides widen bf16 to f32; flow and M stay f32)."""
    h, w = 70, 90
    R0 = rng.normal(size=(5, h, w)).astype(np.float32)
    R1 = rng.normal(size=(5, h, w)).astype(np.float32)
    fl = rng.uniform(-10, 10, (2, h, w)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    R0j, R1j = jnp.asarray(R0).astype(jdt), jnp.asarray(R1).astype(jdt)
    ref = np.asarray(fi_pl(R0j, R1j, jnp.asarray(fl), win, 8, gaussian,
                           interpret=True))
    R0t = _t(_np(R0j)).to(getattr(torch, dtype))
    R1t = _t(_np(R1j)).to(getattr(torch, dtype))
    got = flow_iter(R0t, R1t, _t(fl), win, 8, gaussian)
    assert got.shape == (2, h, w) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() < 1e-4


def test_cpu_wrappers_do_not_count_launches(rng):
    """Only a kernel launch bumps a wrapper's counter; the CPU path runs
    the plain version and leaves every counter alone."""
    from kalman_hydra_tpu_torch import kernels
    kernels.reset_launches()
    img = _t(rng.uniform(0, 255, (64, 80)).astype(np.float32))
    R = poly_expansion_planar(img, 5, 1.1)
    coarse_polyexp_fused(img, 2, 0.5, 5, 1.1)
    flow_iter(R, R, torch.zeros(2, 64, 80), 15, 8)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
