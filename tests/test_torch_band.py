"""K2's band mode (kernels/flow_iter.py::flow_iter with row0/img_h;
csrc/flow_iter.cu with flow_tile.cuh::SelectSumM): the
plain band version against the reference's Pallas band mode in interpret
mode, the band's interior against the full image bit for bit, and the C
call's row0/img_h on every tile route with the launch stubbed. The
kernel itself runs only on the card (chip_smoke.py's K2-band phase)."""

import importlib

import numpy as np
import pytest
import torch

from kalman_hydra_tpu_torch import kernels
from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.kernels.flow_iter import (MEM, band_rows,
                                                      flow_iter_plain,
                                                      tile_plan)

fi = importlib.import_module("kalman_hydra_tpu_torch.kernels.flow_iter")

H, W = 96, 90            # tests/unit/test_kernels.py's band-mode case
RP = 16                  # winsize 15, max_disp 8: bw + D + 1


def _inputs(h=H, w=W, seed=1234):
    rng = np.random.default_rng(seed)
    R0 = rng.normal(size=(5, h, w)).astype(np.float32)
    R1 = rng.normal(size=(5, h, w)).astype(np.float32)
    fl = rng.uniform(-5, 5, (2, h, w)).astype(np.float32)
    return R0, R1, fl


def _slab(x, a, b):
    """Rows a..b-1 of x, the rows outside the image replicating its edge
    rows (the slab layout of farneback_sharded's edge bands)."""
    h = x.shape[1]
    return x[:, np.clip(np.arange(a, b), 0, h - 1)]


def _kept(n, row0, img_h, bw):
    """Slab rows whose window stays in the slab or leaves it only past the
    image's edge: the rows a caller keeps."""
    r = np.arange(n)
    return ((r >= bw) | (row0 <= 0)) & ((r < n - bw) | (row0 + n >= img_h))


@pytest.mark.parametrize("a,b,dtype", [
    (32 - RP, 64 + RP, "float32"),     # the reference test's mid slab
    (-RP, 32 + RP, "float32"),         # the top band, above the image
    (64 - RP, H + RP, "bfloat16"),     # the bottom band, bf16 planes
])
def test_band_plain_matches_the_reference_band_mode(a, b, dtype):
    """flow_iter_plain's band mode against the reference's flow_iter(...,
    row0, img_h, interpret=True) on the same slab (< 1e-5), at every row a
    caller keeps."""
    import jax.numpy as jnp
    from kalman_hydra_tpu.kernels.flow_iter_pallas import flow_iter
    R0, R1, fl = (_slab(x, a, b) for x in _inputs())
    R0j, R1j = (jnp.asarray(x).astype(dtype) for x in (R0, R1))
    ref = np.asarray(flow_iter(R0j, R1j, jnp.asarray(fl), 15, 8, False,
                               interpret=True, row0=a, img_h=H))
    tdt = getattr(torch, dtype)
    got = flow_iter_plain(
        torch.from_numpy(np.array(R0j.astype(jnp.float32))).to(tdt),
        torch.from_numpy(np.array(R1j.astype(jnp.float32))).to(tdt),
        torch.from_numpy(fl), 15, 8, False, row0=a, img_h=H).numpy()
    keep = _kept(b - a, a, H, 7)
    assert keep.sum() >= b - a - 14
    assert np.abs(got - ref)[:, keep].max() < 1e-5


@pytest.mark.parametrize("n_bands,dtype,gaussian", [
    (2, "float32", False), (3, "bfloat16", True), (4, "float32", True),
    (4, "bfloat16", False)])
def test_band_interior_is_the_full_image_bit_for_bit(n_bands, dtype,
                                                     gaussian):
    """Cut into bands in farneback_sharded's slab layout (band rows +- RP,
    the image's edge rows replicated past it), each band's interior
    equals the full-image iteration's rows bit for bit: the taper and M's
    replicate border sit at the image's rows, not the slab's."""
    tdt = getattr(torch, dtype)
    R0, R1, fl = _inputs()
    full = flow_iter_plain(*(torch.from_numpy(x).to(tdt) for x in (R0, R1)),
                           torch.from_numpy(fl), 15, 8, gaussian)
    hb = H // n_bands
    for i in range(n_bands):
        r0 = i * hb
        R0s, R1s, fs = (torch.from_numpy(_slab(x, r0 - RP, r0 + hb + RP))
                        for x in (R0, R1, fl))
        band = flow_iter_plain(R0s.to(tdt), R1s.to(tdt), fs, 15, 8, gaussian,
                               row0=r0 - RP, img_h=H)
        assert torch.equal(band[:, RP:RP + hb], full[:, r0:r0 + hb])


def test_band_rows_and_refusals():
    """band_rows is the slab's rows inside the image; a band call without
    img_h, or with a slab that misses the image, raises (as the
    reference's does for a missing img_h)."""
    assert band_rows(48, -16, 96) == (16, 47)
    assert band_rows(48, 64, 96) == (0, 31)
    assert band_rows(48, 0, 48) == (0, 47)
    R0, R1, fl = (torch.from_numpy(x) for x in _inputs(24, 20))
    with pytest.raises(ValueError, match="img_h"):
        fi.flow_iter(R0, R1, fl, 15, 8, row0=0)
    with pytest.raises(ValueError, match="miss"):
        fi.flow_iter(R0, R1, fl, 15, 8, row0=40, img_h=40)


@pytest.mark.parametrize("winsize", (15, 81, 101))
def test_kh_flow_iter_gets_row0_and_img_h_on_every_route(monkeypatch,
                                                         winsize):
    """The wrappers' C calls, with the launch recorded on meta tensors
    (no card): the band mode passes its row0 (negative too) and img_h to
    kh_flow_iter on the 32 x 64 tile (winsize 15), a smaller tile (81)
    and M in device memory (101); full-frame K2 and K6 pass row0 = 0 and
    img_h = h. The band mode counts in flow_iter.band, apart from K2's
    full-frame launches."""
    calls = []

    def function(fname, *argtypes):
        def fn(*args):
            calls.append((fname, args))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(_build, "require", lambda *a: None)
    h, w, img_h, row0 = 80, 53, 300, -24
    R = torch.empty(5, h, w, device="meta")
    fl = torch.empty(2, h, w, device="meta")
    kernels.reset_launches()
    fi.flow_iter(R, R, fl, winsize, 8, row0=row0, img_h=img_h)
    fi.flow_iter(R, R, fl, winsize, 8, True, 250, img_h)
    fi.flow_iter(R, R, fl, winsize, 8)
    fi.flow_iter_pairs(torch.empty(3, 5, h, w, device="meta"),
                       torch.empty(2, 2, h, w, device="meta"), winsize, 8)
    plan = tile_plan(h, w, winsize)
    assert (plan.shape == MEM) == (winsize == 101)
    assert plan.shape == {15: 0, 81: 2, 101: MEM}[winsize]
    got = []
    for fname, args in calls:
        assert fname == "kh_flow_iter"
        (_, _, _, pairs, _, _, hh, ww, D, r0, ih, _, _, taps, _, shape,
         smem, scratch, _, _) = args
        assert (hh, ww, D, taps) == (h, w, 8, plan.taps)
        assert (shape, smem) == (plan.shape, plan.smem)
        assert (scratch is None) == (plan.shape != MEM)
        got.append((pairs, r0, ih))
    assert got == [(1, row0, img_h), (1, 250, img_h), (1, 0, h), (2, 0, h)]
    counts = kernels.launch_counts()
    assert (counts["flow_iter_band"], counts["flow_iter"],
            counts["flow_iter_pairs"]) == (2, 1, 1)
