"""K9's and K10's level entry points on the CPU: pyr_down_levels and
scharr_gradients_levels (one launch a pyramid on the card) against the
per-level plain chain and the reference's XLA ops (ops/pyramid.py's
pyrDown chain, ops/lk.py::scharr_gradients), and their launch plans:
level shapes, tile counts, buffer alignment, shared memory and the level
limits, on 37 x 53, 1 x 5 and 2 x 2 and at 1080p."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalman_hydra_tpu.ops import lk as jlk
from kalman_hydra_tpu.ops import pyramid as jpyr
from kalman_hydra_tpu_torch.kernels import pyramid as tp
from kalman_hydra_tpu_torch.kernels import scharr as ts
from kalman_hydra_tpu_torch.ops import lk as tlk
from kalman_hydra_tpu_torch.ops import pyramid as tpyr

_SHAPES = [(37, 53), (128, 96), (1, 5), (2, 2)]


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", _SHAPES)
def test_pyr_down_levels_matches_chain_and_reference(shape):
    """All levels below the image in one call equal the one-level chain
    bit for bit, and the reference's pyrDown chain (build_pyramid under
    jit) within 1e-3, down to 1 x 1."""
    img = _img(shape)
    n = 4
    got = tp.pyr_down_levels(torch.from_numpy(img), n)
    chain = [torch.from_numpy(img)]
    for _ in range(n):
        chain.append(tp.pyr_down(chain[-1]))
    ref = jax.jit(lambda x: jpyr.build_pyramid(x, n + 1))(jnp.asarray(img))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref[1:]] \
        == list(tp.pyr_plan(*shape, n).shapes)
    for g, c, r in zip(got, chain[1:], ref[1:]):
        assert torch.equal(g, c)
        assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-3
    assert tp.pyr_down_levels(torch.from_numpy(img), 0) == []


@pytest.mark.parametrize("shape", _SHAPES)
def test_scharr_gradients_levels_matches_levels_and_reference(shape):
    """The gradients of every level of a pyramid in one call equal the
    one-level calls bit for bit and the reference's scharr_gradients
    within 1e-3; lk_pyramid's gradients are that call's."""
    img = torch.from_numpy(_img(shape, 1))
    pyr = tpyr.build_pyramid(img, 5)
    got = ts.scharr_gradients_levels(pyr)
    assert len(got) == 5
    for (gx, gy), lvl in zip(got, pyr):
        one = ts.scharr_gradients(lvl)
        assert torch.equal(gx, one[0]) and torch.equal(gy, one[1])
        for g, r in zip((gx, gy), jlk.scharr_gradients(
                jnp.asarray(lvl.numpy()))):
            assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-3
    cfg = tlk.FlowConfig(method="lk_sparse", levels=5)
    lp, lg = tlk.lk_pyramid(img, cfg)
    for (a, b), (c, d) in zip(lg, got):
        assert torch.equal(a, c) and torch.equal(b, d)
    assert ts.scharr_gradients_levels(()) == ()


@pytest.mark.parametrize("shape", [(37, 53), (1, 5), (2, 2), (1080, 1920),
                                   (1079, 1919)])
def test_pyr_plan(shape):
    """K9's launch plan: the chained level shapes, each level 16-byte
    aligned in one buffer, one launch for up to LAUNCH_LEVELS levels
    (a 5-level pyramid's four) whose tiles cover the coarsest level and
    whose staged region fits a block's shared memory; 16-byte loads only
    for an aligned image whose width is a multiple of 4."""
    h, w = shape
    n = 4 if min(shape) > 2 else 1
    plan = tp.pyr_plan(h, w, n)
    shapes, lh, lw = [], h, w
    for _ in range(n):
        lh, lw = (lh + 1) // 2, (lw + 1) // 2
        shapes.append((lh, lw))
    assert list(plan.shapes) == shapes
    assert all(o % 4 == 0 for o in plan.offsets)
    assert plan.size >= plan.offsets[-1] + lh * lw
    (ln,) = plan.launches
    assert ln.src == 0 and ln.levels == n
    th, tw, tiles_x, tiles, vec = list(ln.table)[:5]
    assert tiles == ln.tiles == tiles_x * -(-lh // th)
    assert tiles_x == -(-lw // tw) and (th, tw, ln.threads) in tp.TILES[n]
    assert ln.smem <= tp.SMEM_LIMIT
    assert vec == int(w % 4 == 0)
    assert list(tp.pyr_plan(h, w, n, aligned=False).launches[0].table)[4] \
        == 0
    assert list(ln.table)[8:] == [v for s in shapes for v in s]
    if shape == (1080, 1920):
        assert (ln.tiles, ln.threads) == (120, 1024)


def test_pyr_plan_level_limits():
    """Beyond LAUNCH_LEVELS levels the plan chains a launch from the last
    level the one before wrote, however many levels (9, an LK pyramid of
    10, takes three); for no level or an empty image it raises."""
    plan = tp.pyr_plan(1080, 1920, 7)
    assert [(ln.src, ln.levels) for ln in plan.launches] == [(0, 4), (4, 3)]
    assert list(plan.launches[1].table)[8:] == [
        v for s in plan.shapes[4:] for v in s]
    plan = tp.pyr_plan(1080, 1920, 9)
    assert [(ln.src, ln.levels) for ln in plan.launches] == [
        (0, 4), (4, 4), (8, 1)]
    assert plan.shapes[-1] == (3, 4)
    for n in (0, -1):
        with pytest.raises(ValueError, match="levels"):
            tp.pyr_plan(37, 53, n)
    with pytest.raises(ValueError, match="empty"):
        tp.pyr_plan(0, 5, 1)


@pytest.mark.parametrize("shape", [(37, 53), (1, 5), (2, 2)])
def test_scharr_plan(shape):
    """K10's launch plan over a 5-level pyramid (or the one level of a
    tiny image): gx and gy of each level 16-byte aligned in one buffer,
    16 x 128 tiles walked level after level, 16-byte access only on an
    aligned level whose width is a multiple of 4; 1..8 levels."""
    n = 5 if min(shape) > 2 else 1
    shapes = [tuple(p.shape) for p in tpyr.build_pyramid(
        torch.zeros(shape), n)]
    plan = ts.scharr_plan(tuple(shapes), (True,) * n)
    table = np.array(list(plan.table)).reshape(n, 5)
    tile0 = 0
    for (h, w), row, (gx, gy) in zip(shapes, table, plan.offsets):
        assert gx % 4 == 0 and gy % 4 == 0 and gy >= gx + h * w
        assert list(row) == [h, w, -(-w // ts.TILE_W), tile0, int(w % 4 == 0)]
        tile0 += row[2] * -(-h // ts.TILE_H)
    assert plan.tiles == tile0
    assert plan.size >= plan.offsets[-1][1] + shapes[-1][0] * shapes[-1][1]
    assert list(ts.scharr_plan(tuple(shapes), (False,) * n).table)[4] == 0
    for levels in ((), ((4, 4),) * (ts.MAX_LEVELS + 1)):
        with pytest.raises(ValueError, match="levels"):
            ts.scharr_plan(levels, (True,) * len(levels))
