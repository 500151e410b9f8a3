"""CPU tests of the fused K7b/K4 launch (csrc/level_image.cu): its tile
plan (every output pixel of every coarse level written once, shared
memory within the card's), a NumPy float32 model of its level tile and
K3's tile body against the plain version and the JAX reference in
interpret mode, and its C interface as the wrapper calls it."""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalman_hydra_tpu.kernels import level_image_pallas
from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.kernels import level_image as li
from kalman_hydra_tpu_torch.kernels.polyexp import poly_taps

CSRC = Path(li.__file__).resolve().parents[1] / "csrc"
SIGMA = {5: 1.1, 7: 1.5, 9: 1.9}


def _fma(a, b, c):
    """float32 fused multiply-add, through float64 (the product is exact
    there; the sum rounds twice only on a tie, which a 1e-3 bar does not
    see)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _level_tile(img, lv, tabs, r0, c0, n):
    """The tile's padded level tile as csrc/level_image.cu builds it: each
    of the tile's `split` blocks takes its contiguous share of the level
    rows the padded rows replicate and, a group of them at a time, runs
    the vertical taps over the tile's source columns into the skewed row
    buffers, then the horizontal taps into every padded row that
    replicates each; every padded entry is written once."""
    rows = min(lv.tile_h + 2 * n, lv.ho - r0)
    cols = min(lv.tile_w + 2 * n, lv.wo - c0)
    xlo, span = lv.xs[c0 // lv.tile_w]
    stride = li._skew(span - 1) + 1
    assert lv.group * stride <= max(li.ROW_FLOATS, li.GROUP_MIN * stride)
    vt0, vt1 = max(r0 - n, 0), min(r0 + rows - 1 - n, lv.lh - 1)
    tile = np.full((lv.tile_h + 2 * n, li.pe_in_w(n)), np.nan, np.float32)
    for part in range(lv.split):
        va0 = vt0 + part * (vt1 - vt0 + 1) // lv.split
        nv = vt0 + (part + 1) * (vt1 - vt0 + 1) // lv.split - va0
        _level_rows(img, lv, tabs, r0, c0, n, rows, cols, xlo, span, va0,
                    nv, tile)
    assert not np.isnan(tile[:rows, :cols]).any()
    return tile


def _level_rows(img, lv, tabs, r0, c0, n, rows, cols, xlo, span, va0, nv,
                tile):
    """One block's share of a level tile: level rows va0 .. va0 + nv - 1."""
    wv, fv, wht, fh = tabs
    stride = li._skew(span - 1) + 1
    skewed = np.array([li._skew(x) for x in range(span)])
    for g0 in range(0, nv, lv.group):
        gn = min(lv.group, nv - g0)
        rb = np.full(lv.group * stride, np.nan, np.float32)
        for dv in range(gn):
            v = va0 + g0 + dv
            f, c = fv[v + n]
            acc = np.zeros(span, np.float32)
            for t in range(c):
                acc = _fma(wv[v + n, t], img[f + t, xlo:xlo + span], acc)
            assert np.isnan(rb[dv * stride + skewed]).all()
            rb[dv * stride + skewed] = acc
        for dv in range(gn):
            v = va0 + g0 + dv
            row = rb[((v - va0) % lv.group) * stride:]
            o_lo = max(0 if v == 0 else v + n, r0)
            o_hi = min(lv.ho - 1 if v == lv.lh - 1 else v + n, r0 + rows - 1)
            for pl in range(cols):
                f, c = fh[c0 + pl]
                a = np.float32(0)
                for t in range(c):
                    assert f - xlo + t < span
                    a = _fma(wht[t, c0 + pl], row[li._skew(f - xlo + t)], a)
                assert np.isnan(tile[o_lo - r0:o_hi - r0 + 1, pl]).all()
                tile[o_lo - r0:o_hi - r0 + 1, pl] = a


def _polyexp_tile(tile, taps, n):
    """K3's tile body (polyexp.cuh::polyexp_tile) on one 16-row band:
    (5, 16, 64) planes."""
    t = 2 * n + 1
    g, xg, xxg = (taps[j * t:(j + 1) * t] for j in range(3))
    ig11, ig03, ig33, ig55 = taps[3 * t:]
    tin_w = li.TILE_W_MAX + 2 * n
    vs = np.zeros((3, li.PE_TH, tin_w), np.float32)
    for k in range(t):
        s = tile[k:k + li.PE_TH, :tin_w]
        vs = np.stack([_fma(g[k], s, vs[0]), _fma(xg[k], s, vs[1]),
                       _fma(xxg[k], s, vs[2])])
    m = np.zeros((6, li.PE_TH, li.TILE_W_MAX), np.float32)
    for k in range(t):
        a, b, d = (vs[j][:, k:k + li.TILE_W_MAX] for j in range(3))
        m = np.stack([_fma(g[k], a, m[0]), _fma(xg[k], a, m[1]),
                      _fma(xxg[k], a, m[2]), _fma(g[k], b, m[3]),
                      _fma(xg[k], b, m[4]), _fma(g[k], d, m[5])])
    m00, m10, m20, m01, m11, m02 = m
    return np.stack([m10 * ig11, m01 * ig11, _fma(m00, ig03, m20 * ig33),
                     _fma(m00, ig03, m02 * ig33), m11 * ig55])


def _fused_model(img, levels, n):
    """Every block of the fused launch on one frame, in NumPy float32:
    list of (5, lh, lw) planes, coarsest first; each output pixel must be
    written exactly once."""
    h, w = img.shape
    plan = li.fused_plan(h, w, levels, 0.5, n, 1)
    taps = poly_taps(n, SIGMA[n])
    outs = []
    for lv, (lh, lw, iv, wv, ih, wh) in zip(
            plan.levels, li.level_tables(h, w, levels, 0.5, n)):
        tabs = (wv, li.first_count(iv, wv), wh.T, li.first_count(ih, wh))
        out = np.full((5, lh, lw), np.nan, np.float32)
        for r0 in range(0, lh, lv.tile_h):
            for c0 in range(0, lw, lv.tile_w):
                tile = _level_tile(img, lv, tabs, r0, c0, n)
                r_end, c_end = min(lh, r0 + lv.tile_h), min(lw, c0 + lv.tile_w)
                for band in range(0, min(lv.tile_h, lh - r0), li.PE_TH):
                    planes = _polyexp_tile(tile[band:], taps, n)
                    r1 = min(r0 + band + li.PE_TH, r_end)
                    blk = out[:, r0 + band:r1, c0:c_end]
                    assert np.isnan(blk).all()
                    out[:, r0 + band:r1, c0:c_end] = \
                        planes[:, :r1 - r0 - band, :c_end - c0]
        assert not np.isnan(out).any()
        outs.append(out)
    return outs


@pytest.mark.parametrize("frames", (1, 36))
@pytest.mark.parametrize("n", (5, 7))
@pytest.mark.parametrize("levels", (3, 4, 5, 6))
@pytest.mark.parametrize("shape", ((1080, 1920), (720, 1280), (37, 53),
                                   (148, 212)))
def test_fused_plan_covers_every_output_pixel_once(shape, levels, n, frames):
    """The plan's tiles cover each coarse level's output once; each tile's
    level rows and columns and source column span are the ones its
    outputs need; shared memory stays within the card's 227 KB; each
    level's blocks fill whole clusters; one 1080p frame splits its
    deepest tiles across a cluster and 36 frames do not."""
    h, w = shape
    plan = li.fused_plan(h, w, levels, 0.5, n, frames)
    tables = li.level_tables(h, w, levels, 0.5, n)
    assert len(plan.levels) == len(tables)
    assert plan.blocks == sum(lv.blocks for lv in plan.levels) <= 65535
    assert 0 < plan.smem <= li.SMEM_MAX or not plan.levels
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.cluster == max((lv.split for lv in plan.levels), default=1)
    for lv, (lh, lw, iv, wv, ih, wh) in zip(plan.levels, tables):
        assert (lv.lh, lv.lw, lv.ho, lv.wo) == (lh, lw, lh + 2 * n,
                                                lw + 2 * n)
        assert lv.tile_h % li.PE_TH == 0 and lv.tile_w <= li.TILE_W_MAX
        assert lv.smem <= plan.smem
        # whole clusters of one level: the level's blocks, padded
        assert plan.cluster % lv.split == 0 and lv.blocks % plan.cluster == 0
        assert 0 <= lv.blocks - lv.tiles * lv.split < plan.cluster
        cover = np.zeros((lh, lw), np.int32)
        fh = li.first_count(ih, wh)
        for ty in range(-(-lh // lv.tile_h)):
            for tx in range(lv.tiles_x):
                r0, c0 = ty * lv.tile_h, tx * lv.tile_w
                cover[r0:r0 + lv.tile_h, c0:c0 + lv.tile_w] += 1
                f = fh[c0:min(c0 + lv.tile_w + 2 * n, lv.wo)]
                lo, span = lv.xs[tx]
                assert lo == f[:, 0].min()
                assert lo + span == (f[:, 0] + f[:, 1]).max() <= w
        assert (cover == 1).all()
        assert lv.tiles == lv.tiles_x * -(-lh // lv.tile_h)
    if (shape, levels) == ((1080, 1920), 5):
        assert plan.levels[0].split == (li.SPLIT_MAX if frames == 1 else 1)


@pytest.mark.parametrize("split_max", (1, li.SPLIT_MAX))
@pytest.mark.parametrize("row_floats", (li.ROW_FLOATS, 300))
@pytest.mark.parametrize("n", (5, 7))
@pytest.mark.parametrize("shape,levels", (((64, 96), 3), ((37, 53), 3),
                                          ((148, 212), 3)))
def test_fused_model_meets_the_plain_bar(monkeypatch, shape, levels, n,
                                         row_floats, split_max):
    """The NumPy model of the fused kernel's arithmetic (the level tile's
    vertical then horizontal fused multiply-adds in tap order, K3's tile
    body) against coarse_polyexp_fused_plain (bar 1e-3, PARITY.md's for
    the Pallas kernel) and, at 37x53 and 64x96, against the JAX
    coarse_polyexp_fused in interpret mode; with the row buffers cut to
    300 floats (one or two level rows), the ring wraps many times; with
    splits allowed (one frame's plan splits these tiles 8 ways) and not."""
    monkeypatch.setattr(li, "ROW_FLOATS", row_floats)
    monkeypatch.setattr(li, "SPLIT_MAX", split_max)
    li.fused_plan.cache_clear()
    rs = np.random.RandomState(3)
    img = (rs.random_sample(shape) * 255).astype(np.float32)
    try:
        got = _fused_model(img, levels, n)
    finally:
        li.fused_plan.cache_clear()   # no plan of this budget outlives it
    plain = li.coarse_polyexp_fused_plain(torch.from_numpy(img), levels, 0.5,
                                          n, SIGMA[n])
    assert len(got) == len(plain)
    for a, b in zip(got, plain):
        assert np.abs(a - b.numpy()).max() < 1e-3
    if shape != (148, 212):
        ref = level_image_pallas.coarse_polyexp_fused(
            jnp.asarray(img), levels, 0.5, n, SIGMA[n], interpret=True)
        assert len(ref) == len(got)
        for a, b in zip(got, ref):
            assert np.abs(a - np.asarray(b, np.float32)).max() < 1e-3


def test_fused_model_takes_a_wide_poly_n():
    """poly_n 9 (the generic build: the level tile's rows and the shared
    taps widened to n, polyexp.cuh::pe_in_w and pe_tap_stride): the NumPy
    model of the fused kernel against coarse_polyexp_fused_plain and the
    JAX coarse_polyexp_fused in interpret mode (bar 1e-3)."""
    img = (np.random.RandomState(3).random_sample((64, 96)) * 255).astype(
        np.float32)
    got = _fused_model(img, 3, 9)
    plain = li.coarse_polyexp_fused_plain(torch.from_numpy(img), 3, 0.5, 9,
                                          SIGMA[9])
    ref = level_image_pallas.coarse_polyexp_fused(
        jnp.asarray(img), 3, 0.5, 9, SIGMA[9], interpret=True)
    assert len(got) == len(plain) == len(ref)
    for a, b, c in zip(got, plain, ref):
        assert np.abs(a - b.numpy()).max() < 1e-3
        assert np.abs(a - np.asarray(c, np.float32)).max() < 1e-3


@pytest.mark.parametrize("shape,levels", (((64, 96), 3), ((148, 212), 4)))
def test_k11_model_meets_the_plain_bar(shape, levels):
    """K11 in one launch: the fused kernel's level tiles at n = 0 (its
    plan, split across a cluster where one frame's plan splits), stored
    as they are, against coarse_level_images_plain and, at 64x96, the
    JAX farneback_images_pallas in interpret mode (bar 1e-2, PARITY.md's
    for the Pallas kernel; the model's own error is far below it)."""
    rs = np.random.RandomState(4)
    img = (rs.random_sample(shape) * 255).astype(np.float32)
    h, w = shape
    plan = li.fused_plan(h, w, levels, 0.5, 0, 1, li.IMG_SPLIT_MAX)
    got = []
    for lv, (lh, lw, iv, wv, ih, wh) in zip(
            plan.levels, li.level_tables(h, w, levels, 0.5, 0)):
        assert (lv.ho, lv.wo) == (lh, lw)
        tabs = (wv, li.first_count(iv, wv), wh.T, li.first_count(ih, wh))
        out = np.full((lh, lw), np.nan, np.float32)
        for r0 in range(0, lh, lv.tile_h):
            for c0 in range(0, lw, lv.tile_w):
                tile = _level_tile(img, lv, tabs, r0, c0, 0)
                r1, c1 = min(lh, r0 + lv.tile_h), min(lw, c0 + lv.tile_w)
                assert np.isnan(out[r0:r1, c0:c1]).all()
                out[r0:r1, c0:c1] = tile[:r1 - r0, :c1 - c0]
        assert not np.isnan(out).any()
        got.append(out)
    plain = li.coarse_level_images_plain(torch.from_numpy(img), levels, 0.5)
    assert len(got) == len(plain)
    for a, b in zip(got, plain):
        assert np.abs(a - b.numpy()).max() < 1e-3
    if shape == (64, 96):
        ref = level_image_pallas.farneback_images_pallas(
            jnp.asarray(img), levels, 0.5, interpret=True)[:-1]
        for a, b in zip(got, ref):
            assert np.abs(a - np.asarray(b, np.float32)).max() < 1e-2


def test_tap_tables_are_contiguous_runs():
    """The tables the kernel reads as (first, count) runs: each row's
    non-zero taps are contiguous (first_count raises otherwise) and the
    counts never exceed the table width."""
    for (h, w, levels) in ((1080, 1920, 6), (720, 1280, 5), (148, 212, 3),
                           (33, 2000, 2)):
        for n in (5, 7):
            for (lh, lw, iv, wv, ih, wh) in li.level_tables(h, w, levels,
                                                            0.5, n):
                for idx, wt, size in ((iv, wv, h), (ih, wh, w)):
                    fc = li.first_count(idx, wt)
                    assert (fc[:, 1] >= 1).all()
                    assert (fc[:, 1] <= idx.shape[1]).all()
                    assert (fc[:, 0] + fc[:, 1] <= size).all()
    with pytest.raises(ValueError):
        li.first_count(np.array([[0, 2]]), np.array([[0.5, 0.5]]))


_C_TYPES = {"const void*": _build.P, "void*": _build.P, "int": _build.I,
            "const unsigned long long*": _build.P, "const int*": _build.P}


def _c_signature(source, name):
    src = (CSRC / source).read_text()
    args = re.search(rf"KH_API int {name}\(([^)]*)\)", src).group(1)
    return [_C_TYPES[re.sub(r"\s+\w+$", "", a.strip())]
            for a in args.split(",")]


@pytest.mark.parametrize("frames", (1, 3))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_level_polyexp_calls_the_c_interface_as_declared(monkeypatch,
                                                         frames, dtype):
    """_launch, run on a CPU stack with the library call recorded, makes
    ONE kh_level_polyexp call for all coarse levels, with the types of
    the C signature, the plan's blocks and shared memory, its per-level
    pointer and dimension tables, and K3's taps in host memory."""
    calls = []

    def function(fname, *argtypes):
        def fn(*args):       # the host tables live only during the call
            nl, ptrs, dims, taps = args[4], args[5], args[6], args[7]
            calls.append((fname, argtypes, args, np.ctypeslib.as_array(
                (ctypes.c_uint64 * (6 * nl)).from_address(ptrs)).copy(),
                np.ctypeslib.as_array((ctypes.c_int * (12 * nl))
                                      .from_address(dims)).copy(),
                np.ctypeslib.as_array((ctypes.c_float * (3 * 11 + 4))
                                      .from_address(taps)).copy()))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    h, w, levels, n = 148, 212, 3, 5
    imgs = torch.zeros(frames, h, w)
    outs, launches = li._launch(imgs, levels, 0.5, n, 1.1, dtype)
    assert launches == 1
    (fname, argtypes, args, p, d, got), = calls
    assert fname == "kh_level_polyexp"
    assert list(argtypes) == _c_signature("level_image.cu", fname)
    assert len(args) == len(argtypes)
    (img, nf, hh, ww, nl, ptrs, dims, taps, taps_dev, nn, bf16, blocks,
     cluster, smem, _stream) = args
    assert taps_dev is None         # n <= 8: the taps by value
    plan = li.fused_plan(h, w, levels, 0.5, n, frames)
    assert (img, nf, hh, ww, nl, nn) == (imgs.data_ptr(), frames, h, w,
                                         len(plan.levels), n)
    assert (bf16, blocks, cluster, smem) == (
        int(dtype == torch.bfloat16), plan.blocks, plan.cluster, plan.smem)
    p = p.reshape(nl, 6)
    block0 = 0
    for i, (lv, out) in enumerate(zip(plan.levels, outs)):
        assert out.shape == (frames, 5, lv.lh, lv.lw) and out.dtype == dtype
        assert list(d[12 * i:12 * i + 12]) == [
            lv.lh, lv.lw, lv.ho, lv.wo, lv.tv, lv.th, lv.tile_h, lv.tile_w,
            lv.tiles_x, block0, lv.group, lv.split]
        assert p[i, 5] == out.data_ptr()
        block0 += lv.blocks
    assert np.array_equal(got, poly_taps(n, 1.1))
