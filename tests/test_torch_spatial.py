"""Row-band spatial sharding (kalman_hydra_tpu_torch/parallel/spatial.py)
on meshes of repeated CPU devices, against NumPy and the reference's
sharded ops on its fake 8-device CPU mesh (tests/conftest.py). Each JAX
result is computed once per module."""

import dataclasses

import numpy as np
import pytest
import torch

from kalman_hydra_tpu_torch.config import FlowConfig
from kalman_hydra_tpu_torch.io.synthetic import translating_pair
from kalman_hydra_tpu_torch.parallel import (Mesh, farneback_sharded,
                                             halo_exchange, lk_dense_sharded)


def _cpu_mesh(n, axis="space"):
    return Mesh(["cpu"] * n, (axis,))


def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh as JMesh
    return JMesh(np.array(jax.devices()[:n]), ("space",))


def _jcfg(cfg):
    """The reference's FlowConfig with the port's fields."""
    from kalman_hydra_tpu.config import FlowConfig as JFlowConfig
    return JFlowConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def pair128():
    return translating_pair(height=128, width=128, shift=(2.0, -1.5), seed=0)


@pytest.mark.parametrize("pad_mode", ("edge", "reflect"))
@pytest.mark.parametrize("n", (2, 4, 8))
def test_halo_exchange_matches_numpy(n, pad_mode):
    """Each block extended by its neighbours' rows, the first and last by
    np.pad's edge or reflect rows of the whole array; on each block's
    device; along another row axis too."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(8 * n, 5, 3)).astype(np.float32)
    halo = 3
    blocks = [torch.from_numpy(b) for b in np.split(x, n)]
    padded = np.pad(x, ((halo, halo), (0, 0), (0, 0)), mode=pad_mode)
    got = halo_exchange(blocks, halo, pad_mode)
    for i, g in enumerate(got):
        assert g.device == blocks[i].device
        np.testing.assert_array_equal(g.numpy(),
                                      padded[i * 8:(i + 1) * 8 + 2 * halo])
    moved = halo_exchange([b.movedim(0, 1) for b in blocks], halo, pad_mode,
                          dim=1)
    for a, b in zip(moved, got):
        assert torch.equal(a, b.movedim(0, 1))


_LK = {n: FlowConfig(levels=3 if n == 2 else 2, lk_max_iter=5,
                     lk_winsize=9) for n in (2, 4)}


@pytest.fixture(scope="module")
def lk_ref(pair128):
    from kalman_hydra_tpu.parallel.spatial import lk_dense_sharded as jlk
    a, b, _ = pair128
    return {n: jlk(a, b, _jcfg(cfg), mesh=_jax_mesh(n))
            for n, cfg in _LK.items()}


@pytest.mark.parametrize("n", (2, 4))
def test_lk_dense_sharded_matches_the_reference(pair128, lk_ref, n):
    """lk_dense_sharded on n CPU shards against the reference's on n fake
    devices: mean EPE < 1e-3 px (test_torch_lk.py's bar for dense LK)."""
    a, b, _ = pair128
    got = lk_dense_sharded(a, b, _LK[n], _cpu_mesh(n))
    assert got.shape == (128, 128, 2) and got.dtype == np.float32
    epe = np.linalg.norm(got - lk_ref[n], axis=-1)
    assert epe.mean() < 1e-3


_FB = FlowConfig(levels=3, fast_warp=8)


@pytest.fixture(scope="module")
def fb_ref(pair128):
    """The reference's XLA route on its 8 fake devices. Its result does
    not depend on the shard count (2 and 8 shards give the same bytes:
    the halo holds every row a band's window and warp reach), so one
    call serves every n."""
    from kalman_hydra_tpu.parallel.spatial import farneback_sharded as jfb
    a, b, _ = pair128
    return jfb(a, b, _jcfg(_FB), mesh=_jax_mesh(8))


@pytest.mark.parametrize("n", (2, 8))
def test_farneback_sharded_matches_the_reference_xla_route(pair128, fb_ref,
                                                           n):
    """farneback_sharded on n CPU shards against the reference's XLA
    route, at its bars: rows >= 8 px from the border < 5e-3, all < 0.1
    (the XLA route's band rows at the image's top and bottom differ from
    the kernel's band semantics, which the port follows)."""
    a, b, _ = pair128
    got = farneback_sharded(a, b, _FB, _cpu_mesh(n))
    d = np.abs(got - fb_ref)
    assert d[8:-8, 8:-8].max() < 5e-3
    assert d.max() < 0.1


def test_farneback_sharded_matches_the_reference_kernel_route():
    """The tight check: against the reference's impl="pallas" route (K2's
    band mode in interpret mode) at the smallest size its checks allow, 2
    shards of 32 rows, 2 levels (winsize 9, fast_warp 4, to keep the
    interpret-mode run short): max < 1e-3 px over every row."""
    from kalman_hydra_tpu.parallel.spatial import farneback_sharded as jfb
    a, b, _ = translating_pair(height=64, width=64, shift=(2.0, -1.5),
                               seed=0)
    cfg = FlowConfig(levels=2, fast_warp=4, winsize=9)
    ref = jfb(a, b, _jcfg(cfg), mesh=_jax_mesh(2), impl="pallas",
              interpret=True)
    got = farneback_sharded(a, b, cfg, _cpu_mesh(2), impl="pallas",
                            interpret=True)
    assert np.abs(got - ref).max() < 1e-3


@pytest.mark.parametrize("case", ("fast_warp", "indivisible", "halo",
                                  "lk_indivisible", "lk_halo"))
def test_sharded_flows_refuse_what_the_reference_refuses(pair128, case):
    """The reference's ValueErrors: Farneback needs fast_warp > 0, H
    divisible by the shards and bands of at least RPAD rows; dense LK
    needs H divisible by shards * 2^(levels-1) and its coarsest bands
    as tall as its widest halo."""
    a, b, _ = pair128
    calls = {
        "fast_warp": lambda: farneback_sharded(a, b, FlowConfig(levels=3),
                                               _cpu_mesh(2)),
        "indivisible": lambda: farneback_sharded(a[:100], b[:100], _FB,
                                                 _cpu_mesh(8)),
        "halo": lambda: farneback_sharded(a, b, _FB, _cpu_mesh(16)),
        "lk_indivisible": lambda: lk_dense_sharded(
            a[:100], b[:100], FlowConfig(levels=4), _cpu_mesh(8)),
        "lk_halo": lambda: lk_dense_sharded(
            a, b, FlowConfig(levels=3, lk_winsize=21), _cpu_mesh(8)),
    }
    with pytest.raises(ValueError):
        calls[case]()
