"""The mesh layer (models/mesh.py) and the deforming-body clip against
the JAX reference on the CPU: the clip byte for byte, the host mesh
builders and the remesh functions identical (the same random draws, the
same Delaunay, argmin's lowest index on ties), the per-triangle
deformation < 1e-5 (degenerate triangles included) and the strain
sequences < 1e-5 with the same remesh events."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu.io import synthetic as jsyn
from kalman_hydra_tpu.models import mesh as jmesh
from kalman_hydra_tpu.ops import segment as jseg
from kalman_hydra_tpu.ops.color import grayscale_u8 as jgray
from kalman_hydra_tpu_torch.io import synthetic as tsyn
from kalman_hydra_tpu_torch.models import mesh as tmesh


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_frames=5, height=90, width=120, stretch=(0.1, -0.07),
         omega=0.5, velocity=(0.5, 0.25), num_points=6, seed=3, color=False),
])
def test_deforming_body_clip_matches_reference(kw):
    """Frames byte for byte, the truth and the analytic strain equal."""
    fa, ta, sa = tsyn.deforming_body_clip(**kw)
    fb, tb, sb = jsyn.deforming_body_clip(**kw)
    assert fa.dtype == fb.dtype == np.uint8
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ta.positions, tb.positions)
    np.testing.assert_array_equal(ta.velocity, tb.velocity)
    np.testing.assert_array_equal(sa, sb)


def _body_mask():
    frames, _, _ = jsyn.deforming_body_clip(num_frames=1, height=96,
                                            width=120, seed=2, color=False)
    gray = np.asarray(jgray(jnp.asarray(frames[0])))
    return np.asarray(jseg.segment_body(jnp.asarray(gray)))


def _disk(T=24, V=40, stretch=2.2, seed=0):
    """A disk of V points stretching to `stretch` x along x over T frames
    (the reference's remesh scenario)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, V)
    rad = np.sqrt(rng.uniform(0.05, 1.0, V)) * 30.0
    base = np.stack([64 + rad * np.cos(ang), 64 + rad * np.sin(ang)],
                    axis=-1).astype(np.float32)
    pos = np.empty((T, V, 2), np.float32)
    for t in range(T):
        s = 1.0 + (stretch - 1.0) * t / (T - 1)
        pos[t] = base * np.array([s, 1.0]) + np.array([64 * (1 - s), 0.0])
    return pos


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.triangles, b.triangles)
    assert a.vertices.dtype == b.vertices.dtype
    assert a.triangles.dtype == b.triangles.dtype


def test_mesh_builders_match_reference():
    """sample_mask_points, build_mesh (with max_edge and min_quality),
    mesh_from_mask, triangle_quality, remesh_topology and remesh_resample
    (its vertex map too) give the reference's arrays exactly."""
    mask = _body_mask()
    np.testing.assert_array_equal(
        tmesh.sample_mask_points(mask, 20, seed=3),
        jmesh.sample_mask_points(mask, 20, seed=3))
    _same_mesh(tmesh.mesh_from_mask(mask, n_points=24, seed=1),
               jmesh.mesh_from_mask(mask, n_points=24, seed=1))
    pos = _disk()
    for kw in (dict(), dict(max_edge=20.0), dict(min_quality=0.3)):
        _same_mesh(tmesh.build_mesh(pos[0], **kw),
                   jmesh.build_mesh(pos[0], **kw))
        _same_mesh(tmesh.remesh_topology(pos[-1], **kw),
                   jmesh.remesh_topology(pos[-1], **kw))
    m = jmesh.build_mesh(pos[0])
    np.testing.assert_array_equal(
        tmesh.triangle_quality(pos[-1], m.triangles),
        jmesh.triangle_quality(pos[-1], m.triangles))
    tm, tv = tmesh.remesh_resample(pos[-1], n_points=32, radius=10.0, seed=1)
    jm, jv = jmesh.remesh_resample(pos[-1], n_points=32, radius=10.0, seed=1)
    _same_mesh(tm, jm)
    np.testing.assert_array_equal(tv, jv)
    assert tv.dtype == jv.dtype
    # ties: a new vertex equidistant from two old ones maps to the lower
    # index in both
    twins = np.concatenate([pos[-1], pos[-1]])
    np.testing.assert_array_equal(
        tmesh.remesh_resample(twins, n_points=32, radius=10.0, seed=1)[1],
        jmesh.remesh_resample(twins, n_points=32, radius=10.0, seed=1)[1])


def test_triangle_deformation_matches_reference(rng):
    """F < 1e-5 (relative, or absolute below 1) on random triangles and
    on degenerate rest triangles (two coincident vertices, three
    collinear ones, one vertex thrice: the 1e-8 det guard); area_ratio
    and max_shear < 1e-5 on the triangles of non-zero rest area. On the
    degenerate ones they are the rounding noise of a cancellation between
    entries of F ~1e6-1e10 (or inf), which XLA contracts into FMAs and
    the port does not."""
    rest = rng.uniform(0, 50, (30, 2)).astype(np.float32)
    rest[5] = rest[4]                                   # coincident
    rest[8] = (rest[6] + rest[7]) * 0.5                 # collinear
    cur = (rest + rng.normal(0, 2.0, rest.shape)).astype(np.float32)
    tris = np.argsort(rng.random((60, 30)), axis=1)[:, :3].astype(np.int32)
    tris[0] = [4, 5, 9]
    tris[1] = [6, 7, 8]
    tris[2] = [3, 3, 3]
    ref = jmesh.triangle_deformation(jnp.asarray(rest), jnp.asarray(cur),
                                     jnp.asarray(tris))
    got = tmesh.triangle_deformation(torch.from_numpy(rest),
                                     torch.from_numpy(cur),
                                     torch.from_numpy(tris))
    p = rest.astype(np.float64)[tris]
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    area2 = np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    flat = area2 < 1e-3
    assert flat[:3].all() and (~flat).sum() > 50
    np.testing.assert_allclose(got["F"].numpy(), np.asarray(ref["F"]),
                               rtol=1e-5, atol=1e-5)
    for k in ("area_ratio", "max_shear"):
        g, r = got[k].numpy(), np.asarray(ref[k])
        np.testing.assert_allclose(g[~flat], r[~flat], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_deformation_detects_scaling():
    rest = np.array([[0, 0], [10, 0], [0, 10], [10, 10]], np.float32)
    tris = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    cur = rest * np.array([1.2, 1.0], np.float32)   # 20% x stretch
    out = tmesh.triangle_deformation(torch.from_numpy(rest),
                                     torch.from_numpy(cur),
                                     torch.from_numpy(tris))
    np.testing.assert_allclose(out["area_ratio"].numpy(), 1.2, atol=1e-5)
    np.testing.assert_allclose(out["max_shear"].numpy(), 1.2, atol=1e-5)


def test_mesh_strain_sequence_matches_reference():
    """The stacked per-frame deformation of a stretching disk < 1e-5."""
    pos = _disk(T=8)
    tm = tmesh.build_mesh(pos[0], min_quality=0.2)
    jm = jmesh.build_mesh(pos[0], min_quality=0.2)
    got = tmesh.mesh_strain_sequence(tm, pos, device="cpu")
    ref = jmesh.mesh_strain_sequence(jm, pos)
    for k in ("F", "area_ratio", "max_shear"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("threshold", [1.4, 1.8])
def test_mesh_strain_sequence_dynamic_matches_reference(threshold):
    """The remesh events identical, the per-frame shear and quality <
    1e-5; the remesh bounds the shear as in the reference's test."""
    pos = _disk(T=8)
    tm = tmesh.build_mesh(pos[0], min_quality=0.2)
    jm = jmesh.build_mesh(pos[0], min_quality=0.2)
    got = tmesh.mesh_strain_sequence_dynamic(
        tm, pos, shear_threshold=threshold, min_quality=0.2, device="cpu")
    ref = jmesh.mesh_strain_sequence_dynamic(
        jm, pos, shear_threshold=threshold, min_quality=0.2)
    assert got["events"] == ref["events"] and len(got["events"]) >= 1
    for k in ("max_shear_p95", "quality_min", "quality_mean"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert got["max_shear_p95"].max() <= threshold + 0.05


@pytest.mark.parametrize("fn", ["mesh_strain_sequence",
                                "mesh_strain_sequence_dynamic"])
def test_strain_sequences_default_to_the_card(fn):
    """device defaults to "cuda": without a card the call raises."""
    pos = _disk(T=2)
    m = tmesh.build_mesh(pos[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tmesh, fn)(m, pos)
    assert getattr(tmesh, fn)(m, pos, device="cpu") is not None
