"""Whole mesh-render runs against the JAX reference on the CPU:
api.track_mesh with the render and flow_render channels (the same
segmentation, mesh, template and trajectories), two render
configurations of tests/integration/test_config_matrix.py through
pipeline.track_clip, the streamed run against the array run, a render
stream resumed from a checkpoint against the uninterrupted one, and the
CLI's `mesh` (the reference's npz keys)."""

import numpy as np
import jax.numpy as jnp
import pytest

from kalman_hydra_tpu import api as japi
from kalman_hydra_tpu import pipeline as jp
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     SmoothConfig, TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu.models import mesh as jmesh
from kalman_hydra_tpu.models import render as jrender
from kalman_hydra_tpu.ops.color import grayscale_u8 as jgray
from kalman_hydra_tpu_torch import api, convert
from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.cli import main
from kalman_hydra_tpu_torch.config import RunConfig as TRunConfig
from kalman_hydra_tpu_torch.io.synthetic import deforming_body_clip
from kalman_hydra_tpu_torch.models.mesh import BodyMesh

_NPZ_KEYS = {"vertices", "triangles", "positions", "alive", "nis",
             "track_id", "exx", "eyy", "max_shear", "area_ratio"}


def _ported(cfg: RunConfig) -> TRunConfig:
    return TRunConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def body():
    """The reference's track_mesh test clip: 8 frames of 128 x 160."""
    frames, _, strain = deforming_body_clip(
        num_frames=8, height=128, width=160, stretch=(0.10, -0.07),
        omega=0.5, velocity=(0.5, 0.25), seed=2, color=False)
    return frames, strain


def _same(a, b, bar=1e-3):
    assert a.positions.shape == b.positions.shape
    assert np.abs(a.positions - b.positions).max() < bar
    np.testing.assert_array_equal(a.alive, b.alive)
    np.testing.assert_array_equal(a.track_id, b.track_id)


_FLOW_RENDER = RunConfig(flow=FlowConfig(levels=1),
                         ekf=EkfConfig(measurement="flow_render", q=0.5),
                         tracks=TrackConfig(reinit=False))


@pytest.mark.parametrize("meas", ["render", "flow_render"])
def test_track_mesh_matches_reference(body, meas):
    """api.track_mesh (device="cpu") against the reference's on the same
    clip (flow_render on its first 4 frames, 1 level, 16 vertices): the
    mesh identical (segment_body, Lloyd sampling, Delaunay), positions <
    1e-3 px and NIS < 1e-3, alive and track_id identical; with no config
    (render) every vertex stays alive and the median strain follows the
    clip's e_xx through its sign change (< 0.02)."""
    frames, strain = body
    cfg, n = None, 24
    if meas == "flow_render":
        cfg, n, frames = _FLOW_RENDER, 16, frames[:4]
    jm, jt = japi.track_mesh(frames, cfg, n_vertices=n, seed=1)
    tm, tt = api.track_mesh(frames, None if cfg is None else _ported(cfg),
                            n_vertices=n, seed=1, device="cpu")
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.triangles, jm.triangles)
    _same(tt, jt)
    assert np.abs(tt.nis - jt.nis).max() < 1e-3
    if meas == "render":
        from kalman_hydra_tpu_torch.models.mesh import mesh_strain_sequence
        assert tt.alive[-1].all()
        s = mesh_strain_sequence(tm, tt.positions, device="cpu")
        exx = np.median(s["F"][:, :, 0, 0] - 1.0, axis=1)
        assert float(np.max(np.abs(exx - strain[:, 0]))) < 0.02


def test_track_mesh_streaming_and_given_mesh(body):
    """A given mesh skips the segmentation, and streaming=True (frame 0
    apart, the mesh's vertices as seeds) gives the array run's
    trajectories bit for bit."""
    frames, _ = body
    mesh, arr = api.track_mesh(frames, n_vertices=16, seed=3, device="cpu")
    given = BodyMesh(vertices=mesh.vertices.copy(),
                     triangles=mesh.triangles.copy())
    m2, st = api.track_mesh(frames, mesh=given, streaming=True,
                            device="cpu")
    assert m2 is given
    for f in ("positions", "alive", "nis", "track_id"):
        np.testing.assert_array_equal(getattr(st, f), getattr(arr, f))


def test_render_stream_resumes_from_a_checkpoint(body, tmp_path):
    """A render stream checkpointed every frame and cut after 4 frames,
    then resumed over 6 frames, gives the uninterrupted stream's
    tail bit for bit (the template is the caller's; the checkpoint holds
    the filter state)."""
    from kalman_hydra_tpu_torch.models.mesh import mesh_from_mask
    from kalman_hydra_tpu_torch.models.render import make_template
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    from kalman_hydra_tpu_torch.ops.segment import segment_body
    import torch
    frames = body[0][:6]
    g0 = grayscale_u8(torch.from_numpy(frames[0]))
    mesh = mesh_from_mask(segment_body(g0).numpy(), n_points=16, seed=0)
    tmpl = make_template(g0, mesh, device="cpu")
    cfg = TRunConfig.from_json(RunConfig(
        ekf=EkfConfig(measurement="render", q=0.5),
        tracks=TrackConfig(num_tracks=16, reinit=False)).to_json())
    kw = dict(render_tmpl=tmpl, device="cpu")
    full = tp.track_stream(iter(frames), cfg, seeds=mesh.vertices, **kw)
    ck = str(tmp_path / "ck.npz")
    tp.track_stream(iter(frames[:4]), cfg, seeds=mesh.vertices,
                    checkpoint_path=ck, checkpoint_every=1, **kw)
    tail = tp.track_stream(iter(frames), cfg, checkpoint_path=ck,
                           resume=True, **kw)
    assert tail.positions.shape[0] == len(frames) - 4
    for f in ("positions", "alive", "nis", "track_id"):
        np.testing.assert_array_equal(getattr(tail, f),
                                      getattr(full, f)[4:])


_RENDER_TRACKS = TrackConfig(num_tracks=9, corner_pool=16, reinit=False)
_MATRIX = {
    "render_smooth_lag": RunConfig(
        flow=FlowConfig(levels=2), ekf=EkfConfig(measurement="render", q=0.5),
        tracks=_RENDER_TRACKS, smooth=SmoothConfig(enabled=True, lag=2)),
    "render_ca6": RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="render", q=0.5, state_dim=6),
        tracks=_RENDER_TRACKS),
}


@pytest.mark.parametrize("name", sorted(_MATRIX))
def test_render_config_matrix_matches_reference(name):
    """tests/integration/test_config_matrix.py's render_smooth_lag and
    render_ca6 (a 3 x 3 vertex grid over its 48 x 48 clip and the
    template of frame 0) through pipeline.track_clip, against the
    reference's: positions (and smoothed positions) < 1e-3 px, alive and
    track_id identical; the port's template built from the reference's
    arrays by the converter."""
    cfg = _MATRIX[name]
    clip, _ = moving_blob_clip(num_frames=5, height=48, width=48,
                               num_points=4, seed=0)
    xs = np.linspace(12, 36, 3)
    verts = np.stack(np.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
    mesh = jmesh.build_mesh(verts.astype(np.float32))
    jt = jrender.make_template(np.asarray(jgray(jnp.asarray(clip[0]))), mesh)
    ref = jp.track_clip(clip, cfg, seeds=mesh.vertices, render_tmpl=jt)
    got = tp.track_clip(clip, _ported(cfg), mesh.vertices, False,
                        convert.template_to_torch(jt, "cpu"), device="cpu")
    _same(got, ref)
    if cfg.smooth.enabled:
        assert np.abs(got.smoothed - ref.smoothed).max() < 1e-3


def test_cli_mesh_writes_the_reference_keys(body, tmp_path, capsys):
    """`mesh --device cpu` writes the reference's npz keys, its
    trajectories those of api.track_mesh, and the reference's summary
    line."""
    frames, _ = body
    path = str(tmp_path / "clip.npz")
    np.savez_compressed(path, frames=frames)
    out = str(tmp_path / "mesh.npz")
    assert main(["mesh", path, "--out", out, "--vertices", "16",
                 "--max-frames", "4", "--device", "cpu"]) == 0
    with np.load(out) as z:
        assert set(z.keys()) == _NPZ_KEYS
        mesh, tr = api.track_mesh(frames[:4], n_vertices=16, device="cpu")
        np.testing.assert_array_equal(z["positions"], tr.positions)
        np.testing.assert_array_equal(z["vertices"], mesh.vertices)
        T, V = tr.positions.shape[:2]
        assert z["exx"].shape == (T, len(mesh.triangles))
        assert z["alive"].shape == (T, V)
    line = capsys.readouterr().out
    assert line.startswith("meshed 16 vertices / ") and "final strain exx" \
        in line
