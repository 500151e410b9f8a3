"""Clip data parallelism (kalman_hydra_tpu_torch/parallel/mesh.py) and
the sharded entry points on meshes of repeated CPU devices: against the
reference's sharded tracking on its fake 8-device CPU mesh (one JAX
call), and the path variants against the port's own track_clips_batch,
which the CPU tests already hold to the reference."""

import dataclasses

import numpy as np
import pytest
import torch

from kalman_hydra_tpu_torch import api
from kalman_hydra_tpu_torch.config import (EkfConfig, FlowConfig, RunConfig,
                                           SmoothConfig, TrackConfig)
from kalman_hydra_tpu_torch.io.synthetic import (moving_blob_clip,
                                                 translating_pair)
from kalman_hydra_tpu_torch.parallel import (Mesh, make_mesh,
                                             track_clips_batch,
                                             track_clips_sharded)

CFG = RunConfig(flow=FlowConfig(levels=2),
                tracks=TrackConfig(num_tracks=4, reinit=False))


def _cpu_mesh(n):
    return Mesh(["cpu"] * n, ("data",))


@pytest.fixture(scope="module")
def clip_batch():
    """tests/integration/test_sharding.py's fixture: 8 clips of 64x64,
    T=4, seeded at their blobs."""
    clips, seeds = [], []
    for s in range(8):
        frames, truth = moving_blob_clip(num_frames=4, height=64, width=64,
                                         num_points=4, seed=s)
        clips.append(frames)
        seeds.append(truth.positions[0])
    return np.stack(clips), np.stack(seeds).astype(np.float32)


def test_mesh_and_make_mesh():
    """A Mesh is its devices in order (repeats allowed) and one axis
    name; make_mesh takes the first n visible devices: the CPU's one, or
    the cards, and without a card "cuda" raises."""
    m = _cpu_mesh(8)
    assert m.size == 8 and m.axis_names == ("data",)
    assert m.distinct() == (torch.device("cpu"),)
    assert Mesh(["cpu", "meta", "cpu"], "space").distinct() == (
        torch.device("cpu"), torch.device("meta"))
    cpu = make_mesh(device="cpu")
    assert cpu.devices == (torch.device("cpu"),)
    assert cpu.axis_names == ("data",)
    assert make_mesh(4, "space", device="cpu").axis_names == ("space",)
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        Mesh(["cpu"], ("a", "b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    else:
        assert make_mesh().size == torch.cuda.device_count()


@pytest.fixture(scope="module")
def reference_sharded(clip_batch):
    """The reference's track_clips_sharded on its 8 fake devices, with the
    metric reduction: computed once."""
    from kalman_hydra_tpu.config import RunConfig as JRunConfig
    from kalman_hydra_tpu.parallel import make_mesh as jmake_mesh
    from kalman_hydra_tpu.parallel import track_clips_sharded as jsharded
    clips, seeds = clip_batch
    return jsharded(clips, JRunConfig.from_json(CFG.to_json()),
                    mesh=jmake_mesh(8), seeds=seeds, reduce_metrics=True)


def test_track_clips_sharded_matches_the_reference(clip_batch,
                                                   reference_sharded):
    """8 clips over 8 CPU shards against the reference's 8 fake devices:
    positions < 1e-5 px, alive identical, and the reduced metrics (mean
    NIS, live fraction a frame) < 1e-6 relative."""
    clips, seeds = clip_batch
    trajs, metrics = track_clips_sharded(clips, CFG, _cpu_mesh(8), seeds,
                                         True)
    ref_trajs, ref_metrics = reference_sharded
    assert len(trajs) == 8
    for a, b in zip(trajs, ref_trajs):
        assert np.array_equal(a.alive, b.alive)
        assert np.array_equal(a.track_id, b.track_id)
        assert np.abs(a.positions - b.positions).max() < 1e-5
    assert metrics["live_fraction"].shape == (4,)
    for k in ("mean_nis", "live_fraction"):
        ref = np.asarray(ref_metrics[k])
        assert np.abs(metrics[k] - ref).max() <= 1e-6 * np.abs(ref).max()


def _same(a, b, atol=0.0):
    for x, y in zip(a, b):
        assert np.array_equal(x.alive, y.alive)
        assert np.array_equal(x.track_id, y.track_id)
        assert np.abs(x.positions - y.positions).max() <= atol
        assert (x.smoothed is None) == (y.smoothed is None)
        if x.smoothed is not None:
            assert np.abs(x.smoothed - y.smoothed).max() <= atol


@pytest.mark.parametrize("variant", ("pair_batch", "smoothing"))
def test_sharded_variants_equal_track_clips_batch(clip_batch, variant):
    """pair_batch (each shard runs its clips through shared launches)
    and RTS smoothing, 2 clips on 2 CPU shards: the single-device batch's
    trajectories exactly."""
    clips, seeds = clip_batch
    cfg = {"pair_batch": CFG.replace(pair_batch=True),
           "smoothing": CFG.replace(smooth=SmoothConfig(enabled=True))}[
        variant]
    single = track_clips_batch(clips[:2], cfg, seeds[:2], device="cpu")
    sharded, metrics = track_clips_sharded(clips[:2], cfg, _cpu_mesh(2),
                                           seeds[:2], True)
    _same(single, sharded)
    assert np.isfinite(metrics["mean_nis"])
    assert (metrics["live_fraction"] > 0).all()


def _template(clip):
    from kalman_hydra_tpu_torch.models.mesh import build_mesh
    from kalman_hydra_tpu_torch.models.render import make_template
    from kalman_hydra_tpu_torch.ops.color import grayscale_u8
    xs = np.linspace(16, 48, 2)
    verts = np.stack(np.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
    body = build_mesh(verts.astype(np.float32))
    gray0 = grayscale_u8(torch.from_numpy(clip[0]))
    return body, make_template(gray0, body, device="cpu")


def test_sharded_render_channel_equals_track_clips_batch(clip_batch):
    """One render template, copied to each distinct device, shared by 2
    clips on 2 shards: track_clips_batch's trajectories exactly; a
    template with pair_batch raises, as in the reference."""
    clips, _ = clip_batch
    body, tmpl = _template(clips[0])
    cfg = RunConfig(flow=FlowConfig(levels=2),
                    ekf=EkfConfig(measurement="render", q=0.5),
                    tracks=TrackConfig(num_tracks=4, reinit=False))
    seeds = np.broadcast_to(body.vertices, (2, 4, 2)).copy()
    single = track_clips_batch(clips[:2], cfg, seeds, tmpl, device="cpu")
    sharded = track_clips_sharded(clips[:2], cfg, _cpu_mesh(2), seeds,
                                  render_tmpl=tmpl)
    _same(single, sharded)
    for fn in (track_clips_batch, track_clips_sharded):
        with pytest.raises(ValueError, match="render channel"):
            fn(clips[:2], CFG.replace(pair_batch=True), seeds=seeds,
               render_tmpl=tmpl, device="cpu")


def test_indivisible_batch_raises(clip_batch):
    clips, seeds = clip_batch
    with pytest.raises(ValueError, match="not divisible"):
        track_clips_sharded(clips[:3], CFG, _cpu_mesh(8), seeds[:3])


def test_api_sharded_entry_points_run_on_the_cpu(clip_batch):
    """api.track_videos(sharded=True) on the default CPU mesh gives
    track_videos' trajectories; api.flow_sharded (Farneback at its
    default FlowConfig(fast_warp=8), and dense LK) gives api.flow's flow
    inside (the default mesh is one CPU shard: the same rows)."""
    clips, _ = clip_batch
    _same(api.track_videos(clips[:2], CFG, True, device="cpu"),
          api.track_videos(clips[:2], CFG, device="cpu"))
    a, b, truth = translating_pair(height=64, width=64, shift=(2.0, -1.5),
                                   seed=0)
    for method, cfg in (("farneback", None),
                        ("lk_dense", FlowConfig(method="lk_dense",
                                                levels=2, lk_winsize=9))):
        got = api.flow_sharded(a, b, cfg, method, device="cpu")
        flat = api.flow(a, b, cfg or FlowConfig(fast_warp=8), device="cpu")
        assert got.shape == (64, 64, 2)
        assert np.abs(got - flat)[8:-8, 8:-8].max() < 1e-3
        epe = np.linalg.norm(got - truth, axis=-1)[12:-12, 12:-12]
        assert epe.mean() < 0.1
    with pytest.raises(ValueError, match="unknown sharded method"):
        api.flow_sharded(a, b, None, "lk_sparse", device="cpu")
