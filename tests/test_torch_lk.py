"""Lucas-Kanade ops and kernels of the port against the JAX reference on
the CPU: pyr_down / build_pyramid (K9's plain version) and the Scharr
gradients (K10's) against ops.pyramid, ops.lk and their Pallas kernels in
interpret mode; lk_pyramid against both reference impls; K12's plain
version against lk_pallas._lk_level in interpret mode; lk_sparse against
ops.lk.lk_sparse at lk_block_halo 0, 4 and 8 under every lk_solver, with
a motion beyond the halo and the tiny-level fallback; lk_dense at both
warps; the fast single-plane warp against _warp_poly_selectsum."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu.config import FlowConfig
from kalman_hydra_tpu.io.synthetic import translating_pair
from kalman_hydra_tpu.kernels import lk_pallas, pyramid_pallas, scharr_pallas
from kalman_hydra_tpu.ops import farneback as jfb
from kalman_hydra_tpu.ops import lk as jlk
from kalman_hydra_tpu.ops import pyramid as jpyr
from kalman_hydra_tpu.ops import warp as jwarp
from kalman_hydra_tpu_torch.config import FlowConfig as TFlowConfig
from kalman_hydra_tpu_torch.kernels import lk as klk
from kalman_hydra_tpu_torch.kernels.lk import lk_level_plain
from kalman_hydra_tpu_torch.ops import lk as tlk
from kalman_hydra_tpu_torch.ops import pyramid as tpyr
from kalman_hydra_tpu_torch.ops import warp as twarp

# 20 interior points (their 21 x 21 windows inside the 96 x 128 image at
# level 0) and the nine border points of the reference's
# test_lk_sparse_kernel_border_points, moved onto this image's edges
_RNG = np.random.default_rng(7)
_INTERIOR = np.stack([_RNG.uniform(12, 115, 20), _RNG.uniform(12, 83, 20)],
                     -1).astype(np.float32)
_BORDER = np.array([[1.0, 1.0], [126.0, 1.0], [1.0, 94.0], [126.0, 94.0],
                    [0.0, 48.0], [127.0, 48.0], [48.0, 0.3], [47.7, 95.0],
                    [48.0, 48.0]], np.float32)
_PTS = np.concatenate([_INTERIOR, _BORDER])


def _t(cfg: FlowConfig) -> TFlowConfig:
    return TFlowConfig(**dataclasses.asdict(cfg))


def _ref_sparse(a, b, pts, cfg: FlowConfig, jit: bool = False):
    """ops.lk.lk_sparse as numpy; `jit` where one whole-graph compile is
    quicker than the eager ops' (a new image shape: the eager ops of the
    other tests are compiled once for the shared pair)."""
    fn = lambda x, y, p: jlk.lk_sparse(x, y, p, cfg)   # noqa: E731
    out = (jax.jit(fn) if jit else fn)(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(pts))
    return np.asarray(out[0]), np.asarray(out[1])


@pytest.fixture(scope="module")
def pair():
    a, b, _ = translating_pair(height=96, width=128, shift=(2.0, -1.5),
                               seed=0)
    return a, b


@pytest.mark.parametrize("shape", [(64, 96), (37, 53)])
def test_pyr_down_and_build_pyramid_match_reference(shape):
    """Every level of a 5-level pyramid (37 x 53 reaches 3 x 4, odd
    edges on the way) against ops.pyramid, and one level against the
    Pallas pyr_down (each call a compile in interpret mode): 64 x 96's
    first, 37 x 53's last (5 x 7 -> 3 x 4)."""
    img = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    got = tpyr.build_pyramid(torch.from_numpy(img), 5)
    ref = jax.jit(lambda x: jpyr.build_pyramid(x, 5))(jnp.asarray(img))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for lvl in range(1, 5):
        g = got[lvl].numpy()
        assert np.abs(g - np.asarray(ref[lvl])).max() < 1e-3
        if lvl == (4 if shape[0] < 64 else 1):
            pal = pyramid_pallas.pyr_down(jnp.asarray(ref[lvl - 1]),
                                          interpret=True)
            assert np.abs(g - np.asarray(pal)).max() < 1e-3


def test_scharr_gradients_match_reference(pair):
    a = pair[0].astype(np.float32)
    got = tlk.scharr_gradients(torch.from_numpy(a))
    for ref in (jlk.scharr_gradients(jnp.asarray(a)),
                scharr_pallas.scharr_gradients(jnp.asarray(a),
                                               interpret=True)):
        for g, r in zip(got, ref):
            assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-3


def test_lk_pyramid_matches_both_reference_impls(pair):
    cfg = FlowConfig(levels=3)
    got_pyr, got_grads = tlk.lk_pyramid(torch.from_numpy(pair[0]), _t(cfg))
    for kw in (dict(impl="xla"), dict(impl="pallas", interpret=True)):
        ref_pyr, ref_grads = jax.jit(lambda x: jlk.lk_pyramid(x, cfg, **kw))(
            jnp.asarray(pair[0]))
        assert len(got_pyr) == len(ref_pyr) == 3
        for g, r in zip(got_pyr, ref_pyr):
            assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-3
        for gg, rg in zip(got_grads, ref_grads):
            for g, r in zip(gg, rg):
                assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-3


def test_lk_level_plain_matches_pallas_kernel(pair):
    """K12's plain version (one level at lk_block_halo 0) against the
    Pallas per-point kernel in interpret mode: 12 points, border points
    included, guesses off the points by up to 3 px."""
    cfg = FlowConfig(levels=1)
    a, b = (p.astype(np.float32) for p in pair)
    gx, gy = jlk.scharr_gradients(jnp.asarray(a))
    pts = np.concatenate([_INTERIOR[:6], _BORDER[[0, 3, 4, 5, 6, 7]]])
    guess = pts + np.random.default_rng(3).uniform(-3, 3, pts.shape
                                                   ).astype(np.float32)
    ref, ref_ok = lk_pallas._lk_level(
        jnp.asarray(a), jnp.asarray(b), gx, gy, jnp.asarray(pts),
        jnp.asarray(guess), cfg, interpret=True)
    tc = _t(cfg)
    args = klk.level_args(
        *(torch.from_numpy(np.array(x)) for x in (a, b, gx, gy, pts,
                                                  guess)),
        tc.lk_winsize, tc.lk_max_iter, tc.lk_eps, tc.lk_min_eig,
        tc.lk_block_halo)
    got, ok = klk.lk_level(*args)
    got = got - args[8]
    ref_ok = np.asarray(ref_ok)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    assert ref_ok.sum() >= 8
    err = np.abs(got.numpy() - np.asarray(ref))[ref_ok].max()
    assert err < 1e-3, err


_SPARSE = [(0, "blockhalo")] + [(h, s) for h in (4, 8)
                                for s in ("blockhalo", "corr", "corr_conv")]


@pytest.fixture(scope="module")
def sparse_refs(pair):
    """The reference's lk_sparse on `pair` at _PTS per (halo, solver),
    computed once each, at 2 levels (each level's shapes are a new
    compile of every eager op)."""
    cache = {}

    def get(halo, solver):
        if (halo, solver) not in cache:
            cfg = FlowConfig(levels=2, lk_block_halo=halo, lk_solver=solver)
            cache[halo, solver] = _ref_sparse(*pair, _PTS, cfg)
        return cache[halo, solver]
    return get


@pytest.mark.parametrize("halo,solver", _SPARSE)
def test_lk_sparse_matches_reference(pair, sparse_refs, halo, solver):
    """ops.lk.lk_sparse at every lk_block_halo / lk_solver the bench
    uses, status identical everywhere. The 20 interior points: < 1e-3 px
    from the patch-form solvers (halo 0 and "blockhalo", the port's own
    math); from "corr" and "corr_conv" < 1e-3 px beyond the distance
    between those and "blockhalo" at the same point: their correlation
    tables subtract two sums of ~1e7 in f32, which can move the
    reference's own answers by more than 1e-3 px from its blockhalo
    solver's (1.6e-3 px on this pair at 3 levels). The
    nine border points: < 0.05 px (the bar of the reference's
    test_lk_sparse_kernel_border_points: windows across the edge leave G
    ill-conditioned)."""
    cfg = FlowConfig(levels=2, lk_block_halo=halo, lk_solver=solver)
    ref, ref_st = sparse_refs(halo, solver)
    got, st = tlk.lk_sparse(*(torch.from_numpy(x) for x in pair + (_PTS,)),
                            _t(cfg))
    np.testing.assert_array_equal(st.numpy(), ref_st)
    assert ref_st[:20].all()
    err = np.abs(got.numpy() - ref).max(-1)
    spread = np.zeros_like(err)
    if solver != "blockhalo":
        spread = np.abs(sparse_refs(halo, "blockhalo")[0] - ref).max(-1)
    print(f"halo {halo} {solver}: interior max {err[:20].max():.3e} px "
          f"(reference solvers' own spread {spread[:20].max():.3e}), "
          f"border max {err[20:][ref_st[20:]].max():.3e} px")
    assert (err[:20] < 1e-3 + spread[:20]).all(), err[:20].max()
    assert err[20:][ref_st[20:]].max() < 0.05


def test_lk_sparse_motion_beyond_the_halo():
    """One level, a 6.5 x -5 px shift, halo 4 (corr_conv, the bench's
    solver): the port follows the reference under the block window
    (interior points < 1e-3 px, status identical), and the window binds
    (the patch read stops halo px from the initial guess, so the answers
    leave the exact window's, which reach the shift)."""
    a, b, _ = translating_pair(height=96, width=128, shift=(6.5, -5.0),
                               seed=4)
    cfg = FlowConfig(levels=1, lk_block_halo=4, lk_solver="corr_conv")
    ref, ref_st = _ref_sparse(a, b, _PTS, cfg)
    args = [torch.from_numpy(x) for x in (a, b, _PTS)]
    got, st = tlk.lk_sparse(*args, _t(cfg))
    np.testing.assert_array_equal(st.numpy(), ref_st)
    assert np.abs(got.numpy() - ref)[:20].max() < 1e-3
    exact, _ = tlk.lk_sparse(*args, _t(dataclasses.replace(
        cfg, lk_block_halo=0)))
    assert np.abs(exact.numpy() - _PTS)[:20].max() > 4.0
    assert np.abs(exact.numpy() - got.numpy())[:20].max() > 0.5


def test_lk_sparse_tiny_level_fallback():
    """25 x 53 at 2 levels and halo 8: level 1 (13 x 27, padded 37 x 51)
    is smaller than the 38-px block, so it takes the exact window, as the
    reference falls back there; level 0 keeps the block."""
    a, b, _ = translating_pair(height=25, width=53, shift=(1.5, 1.0),
                               seed=5)
    cfg = FlowConfig(levels=2, lk_block_halo=8, lk_solver="corr_conv")
    g = torch.zeros(1, 2)
    win, halo = cfg.lk_winsize, cfg.lk_block_halo
    assert klk.window(13, 27, g, win, halo)[1] != (16.0, 16.0)
    assert klk.window(25, 53, g, win, halo)[1] == (16.0, 16.0)
    pts = np.array([[20.0, 12.0], [30.0, 14.0], [12.0, 10.0], [40.0, 8.0],
                    [26.0, 16.0]], np.float32)
    ref, ref_st = _ref_sparse(a, b, pts, cfg, jit=True)
    got, st = tlk.lk_sparse(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(pts), _t(cfg))
    np.testing.assert_array_equal(st.numpy(), np.asarray(ref_st))
    assert np.asarray(ref_st).any()
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-3


def test_lk_level_plain_counts_its_steps(pair):
    """with_iters: the Gauss-Newton steps each point took, between 1 and
    lk_max_iter for a gated point and 0 for one that failed the gate;
    the results equal those without it."""
    cfg = _t(FlowConfig(levels=1))
    a, b = (torch.from_numpy(p.astype(np.float32)) for p in pair)
    gx, gy = tlk.scharr_gradients(a)
    pts = torch.from_numpy(_PTS) + 12.0
    base, span = klk.window(96, 128, pts, cfg.lk_winsize,
                            cfg.lk_block_halo)
    args = (a, b, gx, gy, pts, pts, base, span, 12, 21, 10, 0.01, 1e-4)
    g, ok, iters = lk_level_plain(*args, with_iters=True)
    g2, ok2 = lk_level_plain(*args)
    assert torch.equal(g, g2) and torch.equal(ok, ok2)
    assert (iters[ok] >= 1).all() and (iters[ok] <= 10).all()
    assert (iters[~ok] == 0).all()


@pytest.mark.parametrize("fast_warp", [0, 8])
def test_lk_dense_matches_reference(pair, fast_warp):
    """Dense LK at the exact and the fast warp, 2 levels: mean EPE <
    1e-3 px against ops.lk.lk_dense (the max is printed)."""
    cfg = FlowConfig(method="lk_dense", levels=2, fast_warp=fast_warp)
    a, b = pair
    ref = np.asarray(jax.jit(lambda x, y: jlk.lk_dense(x, y, cfg))(
        jnp.asarray(a), jnp.asarray(b)))
    got = tlk.lk_dense(torch.from_numpy(a), torch.from_numpy(b),
                       _t(cfg)).numpy()
    epe = np.linalg.norm(got - ref, axis=-1)
    print(f"lk_dense fast_warp={fast_warp}: mean EPE {epe.mean():.3e}, "
          f"max {epe.max():.3e} px; mean |flow| "
          f"{np.linalg.norm(ref, axis=-1).mean():.3f} px")
    assert got.shape == ref.shape == (96, 128, 2)
    assert epe.mean() < 1e-3


def test_warp_selectsum_single_plane_matches_reference(pair):
    """The fast warp of one plane against _warp_poly_selectsum, with a
    flow that reaches past +-max_disp and off every edge."""
    img = pair[1].astype(np.float32)
    fl = np.random.default_rng(2).uniform(-12, 12, img.shape + (2,)
                                          ).astype(np.float32)
    ref = np.asarray(jax.jit(
        lambda i, f: jfb._warp_poly_selectsum(i[..., None], f, 8))(
            jnp.asarray(img), jnp.asarray(fl)))[..., 0]
    f = torch.from_numpy(fl)
    got = twarp.warp_selectsum(torch.from_numpy(img)[None], f[..., 0],
                               f[..., 1], 8)[0].numpy()
    assert np.abs(got - ref).max() < 1e-3
    ref_exact = np.asarray(jax.jit(jwarp.warp_image)(jnp.asarray(img),
                                                     jnp.asarray(fl)))
    got_exact = twarp.warp_image(torch.from_numpy(img), f).numpy()
    assert np.abs(got_exact - ref_exact).max() < 1e-3
