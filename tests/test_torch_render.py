"""The mesh-render measurement channel (models/render.py) against the JAX
reference on the CPU, on identical NumPy inputs: the template (byte for
byte), the warp and the residual, J^T r against jax.grad (sample points on
the image border included), the lumped Gauss-Newton measurement against
the reference's and its float64 NumPy twin, the per-vertex sums against
jax.ops.segment_sum (bit for bit), and render_step / render_refine. The
reference has no Pallas kernel here; the port is plain torch, so these
tests pin what runs on the card too."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu.config import EkfConfig
from kalman_hydra_tpu.io.synthetic import (_bilinear, _textured_background,
                                           deforming_body_clip,
                                           translating_pair)
from kalman_hydra_tpu.models import dynamics as jdyn
from kalman_hydra_tpu.models import ekf as jekf
from kalman_hydra_tpu.models import mesh as jmesh
from kalman_hydra_tpu.models import render as jrender
from kalman_hydra_tpu.ops import segment as jseg
from kalman_hydra_tpu.ops.color import grayscale_u8 as jgray
from kalman_hydra_tpu_torch import convert
from kalman_hydra_tpu_torch.config import EkfConfig as TEkfConfig
from kalman_hydra_tpu_torch.models import dynamics as tdyn
from kalman_hydra_tpu_torch.models import ekf as tekf
from kalman_hydra_tpu_torch.models import mesh as tmesh
from kalman_hydra_tpu_torch.models import render as trender
from kalman_hydra_tpu_torch.ops import warp as twarp

_t = torch.from_numpy
_FIELDS = ("tri", "bary", "tvals", "rest", "pix")


def _grid(cx, cy, half, n):
    """n x n vertex grid centred at (cx, cy)."""
    xs = np.linspace(cx - half, cx + half, n)
    ys = np.linspace(cy - half, cy + half, n)
    return np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2).astype(
        np.float32)


def _textured(h, w, seed):
    rng = np.random.default_rng(seed)
    return (_textured_background(h, w, rng) * 255.0).astype(np.float32)


def _body():
    """Frame 0 of a deforming body and the reference's mesh of its
    segmented body (24 vertices)."""
    frames, _, _ = deforming_body_clip(num_frames=2, height=96, width=120,
                                       seed=4, color=False)
    gray0 = np.asarray(jgray(jnp.asarray(frames[0])))
    mask = np.asarray(jseg.segment_body(jnp.asarray(gray0)))
    return gray0, jmesh.mesh_from_mask(mask, n_points=24, seed=1)


def _pair_and_mesh(n=5):
    a, b, _ = translating_pair(height=96, width=96, shift=(1.4, -0.8))
    pts = _grid(48, 48, 26, n)
    return (np.asarray(a, np.float32), np.asarray(b, np.float32),
            jmesh.build_mesh(pts), tmesh.build_mesh(pts))


def _templates(img, jm, tm, **kw):
    return (jrender.make_template(img, jm, **kw),
            trender.make_template(img, tm, device="cpu", **kw))


@pytest.mark.parametrize("case", ["grid", "body", "body_max_pixels"])
def test_make_template_matches_reference(case):
    """tri, bary, tvals, rest and pix equal the reference's byte for byte
    (tri as int64): the rasterization's tie rule (the first triangle
    claims a shared-edge pixel), np.nonzero's row-major order and the
    max_pixels stride survive the copy; order/lengths sort the
    incidences by vertex."""
    if case == "grid":
        img, _, jm, tm = _pair_and_mesh()
        kw = {}
    else:
        img, jm = _body()
        tm = tmesh.BodyMesh(vertices=jm.vertices, triangles=jm.triangles)
        kw = {"max_pixels": 300} if case == "body_max_pixels" else {}
    jt, tt = _templates(img, jm, tm, **kw)
    for f in _FIELDS:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert b.dtype == (np.int64 if f == "tri" else a.dtype), f
        np.testing.assert_array_equal(a, b, err_msg=f)
    ids = tt.tri.reshape(-1)
    assert torch.equal(ids[tt.order], torch.sort(ids, stable=True).values)
    assert torch.equal(tt.lengths,
                       torch.bincount(ids, minlength=tt.rest.shape[0]))
    if case == "body_max_pixels":
        assert tt.tvals.shape[0] <= 300
    # the converter's template from the reference's arrays is the same
    ct = convert.template_to_torch(jt, "cpu")
    for a, b in zip(ct, tt):
        assert torch.equal(a, b)


def test_segment_sum_matches_jax_segment_sum(rng):
    """The per-vertex sums equal jax.ops.segment_sum bit for bit on the
    CPU (the same order of additions), empty vertices 0."""
    img, _, jm, tm = _pair_and_mesh()
    _, tt = _templates(img, jm, tm)
    n = tt.tri.numel()
    vals = (rng.standard_normal((n, 5)) * 100).astype(np.float32)
    ids = tt.tri.reshape(-1).numpy()
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                         num_segments=len(jm.vertices)))
    np.testing.assert_array_equal(trender.segment_sum(_t(vals), tt).numpy(),
                                  ref)


def test_warp_and_residual_match_reference():
    """warp_to_rest and render_residual < 1e-5 of the intensity (u8
    scale: one f32 ulp of an intensity near 128 is 7.6e-6, and XLA's dot
    rounds q = sum_m bary_m v_m with an FMA on one of its components,
    the port without: ~10 ulps) at perturbed vertices; the identity warp
    reproduces the template."""
    img, b, jm, tm = _pair_and_mesh()
    jt, tt = _templates(img, jm, tm)
    v = jm.vertices + np.float32([0.7, -0.3])
    iw_ref = np.asarray(jrender.warp_to_rest(jnp.asarray(b), jnp.asarray(v),
                                             jt))
    np.testing.assert_allclose(
        trender.warp_to_rest(_t(b), _t(v), tt).numpy(), iw_ref, rtol=1e-5,
        atol=0)
    r = trender.render_residual(_t(b), _t(v), tt).numpy()
    r_ref = np.asarray(jrender.render_residual(jnp.asarray(b),
                                               jnp.asarray(v), jt))
    assert np.abs(r - r_ref).max() < 1e-5 * np.abs(iw_ref).max()
    iw = trender.warp_to_rest(_t(img), tt.rest, tt).numpy()
    np.testing.assert_allclose(iw, tt.tvals.numpy(), atol=1e-3)


def _border_vertices(rest, w, h):
    """Vertices moved off the grid by (0.3, -0.2), and four of them onto
    the image border (x = 0, x = w - 1, y = 0, y = h - 1), each with its
    other coordinate at a pixel centre: the template pixel at that rest
    vertex then samples exactly on the border, where the clamp's
    gradient splits."""
    v = rest + np.float32([0.3, -0.2])
    for i, (x, y) in zip((0, 4, 20, 24), ((0.0, None), (w - 1.0, None),
                                         (None, 0.0), (None, h - 1.0))):
        v[i] = [rest[i, 0] if x is None else x, rest[i, 1] if y is None
                else y]
    return v


@pytest.mark.parametrize("where", ["interior", "border"])
def test_render_jtz_matches_jax_grad(where, monkeypatch):
    """J^T r by torch.autograd against -jax.grad of the render energy,
    < 1e-4 relative to its largest entry; on the border the clamp passes
    half the gradient in both (torch.clamp's full gradient misses the
    bar there)."""
    h = w = 96
    img = _textured(h, w, seed=5)
    pts = np.round(_grid(48, 48, 30, 5))
    jm, tm = jmesh.build_mesh(pts), tmesh.build_mesh(pts)
    jt, tt = _templates(img, jm, tm)
    b = _textured(h, w, seed=6)
    v = (pts + np.float32([0.3, -0.2]) if where == "interior"
         else _border_vertices(pts, w, h))
    g_ref = np.asarray(jrender.render_jtz(jnp.asarray(b), jnp.asarray(v),
                                          jt))
    g = trender.render_jtz(_t(b), _t(v), tt).numpy()
    scale = np.abs(g_ref).max()
    assert np.abs(g - g_ref).max() < 1e-4 * scale
    if where == "border":
        monkeypatch.setattr(twarp, "_clip", lambda x, lo, hi:
                            torch.clamp(x, lo, hi))
        g_full = trender.render_jtz(_t(b), _t(v), tt).numpy()
        assert np.abs(g_full - g_ref).max() > 1e-2 * scale


@pytest.mark.parametrize("iters", [1, 5, 8])
def test_render_measure_matches_reference(iters):
    """z < 1e-4 px, Rk < 1e-4 relative, valid identical to the
    reference's render_measure at render_iters 1, 5 and 8."""
    img, b, jm, tm = _pair_and_mesh()
    jt, tt = _templates(img, jm, tm)
    v_pred = jm.vertices + np.float32([1.0, -0.4])
    z_r, R_r, ok_r = jrender.render_measure(
        jnp.asarray(b), jt, jnp.asarray(v_pred), EkfConfig(render_iters=iters))
    z, R, ok = trender.render_measure(_t(b), tt, _t(v_pred),
                                      TEkfConfig(render_iters=iters))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_r), atol=1e-4)
    R_r = np.asarray(R_r)
    assert (np.abs(R.numpy() - R_r) / np.maximum(np.abs(R_r), 1e-6)).max() \
        < 1e-4
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))


def test_render_measure_matches_numpy_twin():
    """Against the reference's float64 NumPy twin at PARITY.md's bars (z <
    2e-2 px, R < 5e-2 relative, valid identical), and the Gauss-Newton
    lands on the true shift for the valid vertices."""
    img, b, jm, tm = _pair_and_mesh()
    jt, tt = _templates(img, jm, tm)
    v_pred = jm.vertices + np.float32([1.0, -0.4])
    z_np, R_np, ok_np = jrender.render_measure_np(b, jt, v_pred, EkfConfig())
    z, R, ok = trender.render_measure(_t(b), tt, _t(v_pred), TEkfConfig())
    np.testing.assert_allclose(z.numpy(), z_np, atol=2e-2)
    np.testing.assert_allclose(R.numpy(), R_np, rtol=5e-2, atol=1e-5)
    np.testing.assert_array_equal(ok.numpy(), ok_np)
    np.testing.assert_allclose(z.numpy()[ok_np],
                               (jm.vertices + [1.4, -0.8])[ok_np], atol=0.2)


def test_render_recovers_affine_deformation():
    """A known affine warp of a textured frame (rotation and stretch):
    8 sweeps from the rest vertices land within 0.25 px (median) of the
    deformed vertices, as in the reference's test."""
    h = w = 96
    img = _textured(h, w, seed=3)
    c = np.float32([w / 2, h / 2])
    th, sx, sy = 0.06, 1.05, 0.97
    A = np.float32([[sx * np.cos(th), -np.sin(th)],
                    [np.sin(th), sy * np.cos(th)]])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    Ai = np.linalg.inv(A).astype(np.float32)
    qx = Ai[0, 0] * (xx - c[0]) + Ai[0, 1] * (yy - c[1]) + c[0]
    qy = Ai[1, 0] * (xx - c[0]) + Ai[1, 1] * (yy - c[1]) + c[1]
    obs = _bilinear(img, qx, qy).astype(np.float32)
    tm = tmesh.build_mesh(_grid(c[0], c[1], 22, 5))
    tt = trender.make_template(img, tm, device="cpu")
    z, _R, ok = trender.render_measure(_t(obs), tt, _t(tm.vertices),
                                       TEkfConfig(render_iters=8))
    z, ok = z.numpy(), ok.numpy()
    v_true = (tm.vertices - c) @ A.T + c
    assert ok.sum() >= 0.8 * len(ok)
    assert float(np.median(np.linalg.norm(z - v_true, axis=-1)[ok])) < 0.25


def _state(rng, k, n):
    """A live track pool at the mesh's vertices (some dead, adaptive Q
    off), as the reference's TrackState and the port's."""
    x = np.zeros((k, n), np.float32)
    x[:, 2:4] = rng.normal(0, 0.5, (k, 2))
    P = np.broadcast_to(np.eye(n, dtype=np.float32) * 2.0, (k, n, n)).copy()
    alive = np.ones(k, bool)
    alive[[3, 7]] = False
    return x, P, alive


@pytest.mark.parametrize("n", [4, 6])
def test_render_step_and_refine_match_reference(rng, n):
    """render_step (predict, measure, plain update, commit) and
    render_refine (the second update of flow_render) < 1e-4 against the
    reference's, the NIS and alive identical where they are discrete."""
    img, b, jm, tm = _pair_and_mesh()
    jt, tt = _templates(img, jm, tm)
    k = len(jm.vertices)
    x, P, alive = _state(rng, k, n)
    x[:, 0:2] = jm.vertices + rng.normal(0, 0.3, (k, 2))
    jcfg = EkfConfig(measurement="render", state_dim=n, q=0.5)
    tcfg = TEkfConfig(measurement="render", state_dim=n, q=0.5)
    js = jekf.TrackState(x=jnp.asarray(x), P=jnp.asarray(P),
                         alive=jnp.asarray(alive),
                         misses=jnp.zeros(k, jnp.int32),
                         track_id=jnp.zeros(k, jnp.int32))
    ts = convert.tracks_to_torch(js, "cpu")
    F, Q = jdyn.transition(jcfg), jdyn.process_noise(jcfg)
    s_r, aux_r = jrender.render_step(js, jnp.asarray(b), jcfg,
                                     jnp.asarray(F), jnp.asarray(Q), jt)
    s, aux = trender.render_step(ts, _t(b), tcfg,
                                 _t(tdyn.transition(tcfg)),
                                 _t(tdyn.process_noise(tcfg)), tt)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(s_r.x), atol=1e-4)
    np.testing.assert_allclose(s.P.numpy(), np.asarray(s_r.P), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(aux["nis"].numpy(), np.asarray(aux_r["nis"]),
                               atol=1e-4, rtol=1e-4)
    r_r, _ = jrender.render_refine(s_r, aux_r, jnp.asarray(b), jcfg, jt)
    r, _ = trender.render_refine(s, aux, _t(b), tcfg, tt)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(r_r.x), atol=1e-4)
    np.testing.assert_allclose(r.P.numpy(), np.asarray(r_r.P), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(r.alive.numpy(), np.asarray(r_r.alive))
