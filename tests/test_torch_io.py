"""The port's host IO against the reference's on the CPU: FrameStream over
.npz, .npy and a cv2-written MJPG .avi (and gray=True); PrefetchStream's
order, error propagation and abandonment; device_prefetch on the CPU
(order, errors, abandonment) and its refusal to fall back to the CPU
without a card; the native loader against FrameStream and feeding a
stream; write_video; the synthetic clips, flow_to_rgb and the track
overlay byte for byte; and a clean import of the new modules."""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from kalman_hydra_tpu.io import native_loader as jnative
from kalman_hydra_tpu.io import overlay as joverlay
from kalman_hydra_tpu.io import synthetic as jsyn
from kalman_hydra_tpu.io import video as jvideo
from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.config import FlowConfig, RunConfig, TrackConfig
from kalman_hydra_tpu_torch.io import Trajectories, native_loader, overlay
from kalman_hydra_tpu_torch.io import synthetic as tsyn
from kalman_hydra_tpu_torch.io.video import (FrameStream, PrefetchStream,
                                             device_prefetch, write_video)
from kalman_hydra_tpu_torch.ops.color import grayscale_u8

REPO = Path(__file__).resolve().parents[1]
SMALL = RunConfig(flow=FlowConfig(levels=2),
                  tracks=TrackConfig(num_tracks=8, corner_pool=16))


@pytest.fixture(scope="module")
def clip():
    return tsyn.moving_blob_clip(num_frames=5, height=64, width=64,
                                 seed=1)[0]


@pytest.fixture(scope="module")
def avi(clip, tmp_path_factory):
    """The clip written by cv2 as MJPG, the codec the reference's native
    loader test uses."""
    import cv2
    path = str(tmp_path_factory.mktemp("avi") / "clip.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 64))
    for f in clip:
        wr.write(np.ascontiguousarray(f))
    wr.release()
    return path


def _bad_stream():
    yield np.zeros((4, 4), np.uint8)
    raise RuntimeError("decode failed")


@pytest.mark.parametrize("fmt", ["npz", "npy", "avi", "avi_gray"])
def test_frame_stream_matches_reference(clip, avi, tmp_path, fmt):
    """The same frames as the reference's FrameStream (the clip itself
    for .npz/.npy), with its size, frame count and fps."""
    gray = fmt.endswith("gray")
    if fmt == "npz":
        path = str(tmp_path / "clip.npz")
        np.savez_compressed(path, frames=clip)
    elif fmt == "npy":
        path = str(tmp_path / "clip.npy")
        np.save(path, clip)
    else:
        path = avi
    fs, ref = FrameStream(path, gray=gray), jvideo.FrameStream(path, gray=gray)
    got = fs.read_all()
    np.testing.assert_array_equal(got, ref.read_all())
    if fmt in ("npz", "npy"):
        np.testing.assert_array_equal(got, clip)
    assert (fs.num_frames, fs.height, fs.width, fs.fps) == \
        (ref.num_frames, ref.height, ref.width, ref.fps)
    assert got.shape == ((5, 64, 64) if gray else (5, 64, 64, 3))
    fs.close()
    ref.close()
    fs = FrameStream(path, gray=gray)     # a codec is read once
    np.testing.assert_array_equal(fs.read_all(limit=2), got[:2])
    fs.close()


def test_prefetch_stream_order_errors_and_abandonment(clip):
    """PrefetchStream yields the frames in order; a decode error reaches
    the consumer (not a clean end); a consumer that stops early does not
    pin the worker thread."""
    got = np.stack(list(PrefetchStream(iter(clip), depth=2)))
    np.testing.assert_array_equal(got, clip)
    it = iter(PrefetchStream(_bad_stream(), depth=2))
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)
    ps = PrefetchStream(iter(np.zeros((50, 4, 4), np.uint8)), depth=2)
    it = iter(ps)
    next(it)
    it.close()
    ps._thread.join(timeout=10)
    assert not ps._thread.is_alive()


def test_device_prefetch_on_the_cpu(clip):
    """device="cpu": CPU tensors in order; a worker error reaches the
    consumer; an abandoned consumer lets the worker end."""
    got = list(device_prefetch(iter(clip), depth=2, device="cpu"))
    assert all(isinstance(g, torch.Tensor) and g.device.type == "cpu"
               for g in got)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), clip)
    it = device_prefetch(_bad_stream(), depth=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)
    before = set(threading.enumerate())
    it = device_prefetch(iter(np.zeros((50, 4, 4), np.uint8)), depth=2,
                         device="cpu")
    next(it)
    workers = set(threading.enumerate()) - before
    assert workers
    it.close()
    for w in workers:
        w.join(timeout=10)
        assert not w.is_alive()


def test_device_prefetch_needs_a_card_for_cuda(clip):
    """Asked for the card without one, device_prefetch, track_stream and
    a streamed api.track_video raise; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only refusal does not apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_prefetch(iter(clip))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.track_stream(iter(clip), SMALL)
    from kalman_hydra_tpu_torch import api
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.track_video(clip, SMALL, streaming=True)


def test_native_loader_matches_frame_stream(clip, avi):
    """The port's binding of native/libframeloader.so decodes what the
    reference's binding does, bit for bit, and what FrameStream does up
    to the JPEG decoders of two OpenCV builds (mean < 2, the reference's
    bar); gray mode is grayscale_u8 of the color frames, bit for bit; the
    frames feed a stream that equals the stream of the same frames."""
    if not native_loader.available():
        pytest.skip("the native frame loader neither loads nor builds here")
    ns = native_loader.NativeFrameStream(avi)
    assert (ns.width, ns.height, ns.num_frames) == (64, 64, 5)
    nat = ns.read_all()
    ns.close()
    py = FrameStream(avi).read_all()
    assert nat.shape == py.shape
    assert np.abs(nat.astype(int) - py.astype(int)).mean() < 2.0
    if jnative.available():
        ref = jnative.NativeFrameStream(avi)
        np.testing.assert_array_equal(nat, ref.read_all())
        ref.close()
    ns = native_loader.NativeFrameStream(avi, gray=True)
    gray = ns.read_all()
    ns.close()
    np.testing.assert_array_equal(
        gray, grayscale_u8(torch.from_numpy(nat)).numpy().astype(np.uint8))
    ns = native_loader.NativeFrameStream(avi)
    tr = tp.track_stream(iter(ns), SMALL, device="cpu")
    ns.close()
    assert tr.positions.shape == (5, 8, 2)
    same = tp.track_stream(iter(nat), SMALL, device="cpu")
    np.testing.assert_array_equal(tr.positions, same.positions)


def test_write_video(clip, tmp_path):
    """.npz keeps the frames exactly; a codec file reads back with the
    clip's shape."""
    p = str(tmp_path / "v.npz")
    write_video(p, clip)
    np.testing.assert_array_equal(FrameStream(p).read_all(), clip)
    p = str(tmp_path / "v.mp4")
    write_video(p, clip)
    fs = FrameStream(p)
    assert fs.read_all().shape == clip.shape
    fs.close()


_CLIPS = {
    "translating_pair": dict(height=40, width=48, shift=(20.0, -3.5)),
    "rotating_pair": dict(height=40, width=56, angle_deg=3.0, seed=2),
    "sinusoidal_warp_clip": dict(num_frames=3, height=36, width=48,
                                 num_points=5),
    "sinusoidal_warp_clip_gray": dict(num_frames=2, height=30, width=40,
                                      color=False, seed=4),
    "circling_blob_clip": dict(num_frames=3, height=40, width=40,
                               num_points=4),
    "circling_blob_clip_gray": dict(num_frames=2, height=32, width=36,
                                    color=False, seed=1),
}


def _leaves(out):
    if isinstance(out, tuple):
        return [x for o in out for x in _leaves(o)]
    if isinstance(out, np.ndarray):
        return [out]
    return [out.positions, out.velocity]


@pytest.mark.parametrize("name", sorted(_CLIPS))
def test_synthetic_clips_match_reference(name):
    """Frames, ground truth and flows byte for byte the reference's."""
    fn = name.replace("_gray", "")
    got = _leaves(getattr(tsyn, fn)(**_CLIPS[name]))
    ref = _leaves(getattr(jsyn, fn)(**_CLIPS[name]))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_flow_to_rgb_and_overlay_match_reference(tmp_path):
    """flow_to_rgb (with and without max_mag) and render_overlay (trails,
    re-seeded generations, dead slots) byte for byte the reference's;
    write_overlay writes the overlay."""
    from kalman_hydra_tpu.io.export import Trajectories as JTrajectories
    rng = np.random.default_rng(0)
    flow = rng.normal(size=(24, 32, 2)).astype(np.float32)
    for kw in ({}, {"max_mag": 1.5}):
        np.testing.assert_array_equal(overlay.flow_to_rgb(flow, **kw),
                                      joverlay.flow_to_rgb(flow, **kw))
    frames = tsyn.moving_blob_clip(num_frames=4, height=48, width=48)[0]
    T, K = 4, 5
    fields = dict(positions=rng.uniform(0, 47, (T, K, 2)).astype(np.float32),
                  alive=rng.random((T, K)) > 0.2,
                  track_id=np.cumsum(rng.random((T, K)) > 0.7,
                                     axis=0).astype(np.int32))
    got = overlay.render_overlay(frames, Trajectories(**fields), trail=2)
    ref = joverlay.render_overlay(frames, JTrajectories(**fields), trail=2)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, frames)
    p = str(tmp_path / "o.npz")
    overlay.write_overlay(p, frames[..., 0], Trajectories(**fields))
    with np.load(p) as z:
        assert z["frames"].shape == (T, 48, 48, 3)


def test_new_modules_import_no_jax():
    """Importing the streaming, checkpoint, report, overlay, native-loader
    and CLI modules, and running the CLI's synth as `python -m`, leaves
    jax, jaxlib and every module of the JAX package out of sys.modules."""
    code = (
        "import runpy, sys, tempfile, os\n"
        "import kalman_hydra_tpu_torch.io.video\n"
        "import kalman_hydra_tpu_torch.io.native_loader as nl\n"
        "import kalman_hydra_tpu_torch.io.overlay\n"
        "import kalman_hydra_tpu_torch.utils.checkpoint\n"
        "import kalman_hydra_tpu_torch.utils.report\n"
        "import kalman_hydra_tpu_torch.cli\n"
        "nl.available()\n"
        "out = os.path.join(tempfile.mkdtemp(), 'c.npz')\n"
        "sys.argv = ['kalman_hydra_tpu_torch', 'synth', '--out', out,\n"
        "            '--frames', '2', '--height', '16', '--width', '16']\n"
        "try:\n"
        "    runpy.run_module('kalman_hydra_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert os.path.exists(out)\n"
        "ref = [m for m in sys.modules if m.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'kalman_hydra_tpu')]\n"
        "print(ref)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
