"""The port's CLI, API file paths and run reports on the CPU: `synth`,
`track` (clip mode, --stream, --checkpoint, --resume, the smoothing and
config flags), `flow`, each with --device cpu; what is not ported yet
raises NotImplementedError naming its ROADMAP item; `api.track_video`
and `api.smooth` over a path, streamed or not, against the array run;
`api.export`; `run_report` and `write_report` against the reference's."""

import json

import numpy as np
import pytest

from kalman_hydra_tpu.cli import main as jmain
from kalman_hydra_tpu.io.export import Trajectories as JTrajectories
from kalman_hydra_tpu.utils import report as jreport
from kalman_hydra_tpu_torch import api
from kalman_hydra_tpu_torch.cli import main
from kalman_hydra_tpu_torch.config import (FlowConfig, RunConfig,
                                           SmoothConfig, TrackConfig)
from kalman_hydra_tpu_torch.io import Trajectories, load, save
from kalman_hydra_tpu_torch.io.synthetic import moving_blob_clip
from kalman_hydra_tpu_torch.utils import report

SMALL = RunConfig(flow=FlowConfig(levels=2),
                  tracks=TrackConfig(num_tracks=8, corner_pool=16))


@pytest.fixture(scope="module")
def clip_path(tmp_path_factory):
    """`synth`'s clip (5 frames of 64 x 64): its path and frames."""
    path = str(tmp_path_factory.mktemp("cli") / "clip.npz")
    assert main(["synth", "--out", path, "--frames", "5", "--height", "64",
                 "--width", "64"]) == 0
    with np.load(path) as z:
        return path, z["frames"]


def _report(path):
    with open(path.rsplit(".", 1)[0] + ".report.json") as f:
        return json.load(f)


def test_synth_matches_reference(clip_path, tmp_path):
    """`synth` writes the reference's clip and truth, byte for byte."""
    path, frames = clip_path
    ref = str(tmp_path / "ref.npz")
    assert jmain(["synth", "--out", ref, "--frames", "5", "--height", "64",
                  "--width", "64"]) == 0
    with np.load(path) as a, np.load(ref) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a.keys():
            np.testing.assert_array_equal(a[k], b[k])


def test_track_stream_checkpoint_resume_flow(clip_path, tmp_path):
    """synth -> track -> track --stream --checkpoint -> track --resume ->
    flow, all with --device cpu: clip mode gives the API's tracks, the
    stream the same rows (< 1e-4 px), the resume the stream's tail;
    every track writes its .report.json (run_report of its tracks), and
    flow writes api.flow's field."""
    path, frames = clip_path
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        f.write(SMALL.to_json())
    out, sout, rout = (str(tmp_path / n) for n in ("t.npz", "s.npz",
                                                   "r.npz"))
    ck = str(tmp_path / "ck.npz")
    assert main(["track", path, "--out", out, "--config", cfg,
                 "--device", "cpu"]) == 0
    clip_tr = load(out)
    ref = api.track_video(frames, SMALL, device="cpu")
    np.testing.assert_array_equal(clip_tr.positions, ref.positions)
    assert main(["track", path, "--out", sout, "--config", cfg, "--stream",
                 "--checkpoint", ck, "--checkpoint-every", "2",
                 "--device", "cpu"]) == 0
    stream_tr = load(sout)
    assert np.abs(stream_tr.positions - clip_tr.positions).max() < 1e-4
    np.testing.assert_array_equal(stream_tr.track_id, clip_tr.track_id)
    with np.load(ck) as z:
        assert int(z["frame_idx"]) == 4
    assert main(["track", path, "--out", rout, "--config", cfg, "--stream",
                 "--checkpoint", ck, "--resume", "--device", "cpu"]) == 0
    res = load(rout)
    assert res.positions.shape == (1, 8, 2)
    np.testing.assert_array_equal(res.positions, stream_tr.positions[-1:])
    for o in (out, sout, rout):
        assert _report(o) == report.run_report(load(o))
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    np.save(a, frames[0, ..., 0])
    np.save(b, frames[1, ..., 0])
    fout = str(tmp_path / "flow.npz")
    assert main(["flow", a, b, "--out", fout, "--device", "cpu"]) == 0
    with np.load(fout) as z:
        np.testing.assert_array_equal(
            z["flow"], api.flow(frames[0, ..., 0], frames[1, ..., 0],
                                device="cpu"))


_FLAGS = {
    "smooth_lag": (["--smooth-lag", "2", "--stream"], 5, True),
    "smooth_chunk": (["--smooth-chunk", "2"], 5, True),
    "temporal_max_frames": (["--temporal", "--max-frames", "3"], 3, False),
    "stream_max_frames": (["--stream", "--max-frames", "3"], 3, False),
    "lk_sparse": (["--method", "lk_sparse", "--tracks", "6"], 5, False),
}


@pytest.mark.parametrize("name", sorted(_FLAGS))
def test_track_flags(clip_path, tmp_path, name):
    """The config flags reach the run: smoothing (fixed-lag streamed,
    chunked) gives smoothed positions, --max-frames bounds clip mode and
    the stream, --tracks sets the slots; the run is the API's with the
    same config."""
    path, frames = clip_path
    flags, t, smoothed = _FLAGS[name]
    out = str(tmp_path / "t.npz")
    assert main(["track", path, "--out", out, "--tracks", "8",
                 "--device", "cpu"] + flags) == 0
    tr = load(out)
    k = 6 if name == "lk_sparse" else 8
    assert tr.positions.shape == (t, k, 2)
    assert (tr.smoothed is not None) == smoothed
    assert np.isfinite(tr.positions).all()
    cfg = RunConfig(tracks=TrackConfig(num_tracks=k))
    if name == "lk_sparse":
        cfg = cfg.replace(flow=FlowConfig(method="lk_sparse"))
    elif name.startswith("smooth"):
        cfg = cfg.replace(smooth=SmoothConfig(
            enabled=True, lag=2 if name == "smooth_lag" else 0,
            chunk=2 if name == "smooth_chunk" else 0))
    elif name.startswith("temporal"):
        cfg = cfg.replace(flow=FlowConfig(temporal_init=True))
    ref = api.track_video(frames[:t], cfg, streaming="--stream" in flags,
                          device="cpu")
    np.testing.assert_array_equal(tr.positions, ref.positions)
    if smoothed:
        np.testing.assert_array_equal(tr.smoothed, ref.smoothed)


_REFUSED = {
    "mesh": (["mesh", "clip.npz"], "P11b"),
    "bench": (["bench", "--quick"], "P6"),
    "profile": (["track", "clip.npz", "--profile", "trace.json"], "P14"),
}


@pytest.mark.parametrize("name", sorted(_REFUSED))
def test_not_ported_yet_raises(name):
    """mesh, bench and track --profile raise NotImplementedError naming
    their ROADMAP item; the port never runs the JAX bench.py."""
    argv, item = _REFUSED[name]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        main(argv + (["--device", "cpu"] if argv[0] == "track" else []))


def test_checkpoint_needs_stream(clip_path):
    with pytest.raises(SystemExit):
        main(["track", clip_path[0], "--checkpoint", "ck.npz",
              "--device", "cpu"])


@pytest.mark.parametrize("streaming", [False, True])
def test_track_video_and_smooth_take_a_path(clip_path, tmp_path,
                                            streaming):
    """api.track_video and api.smooth over the .npz path, streamed or
    not, against the array run (bit for bit clip mode, < 1e-4 px
    streamed); out_path exports. As in the reference, max_frames bounds
    a file read whole and not a streamed one."""
    path, frames = clip_path
    out = str(tmp_path / "t.npz")
    tr = api.track_video(path, SMALL, out, streaming, 3, device="cpu")
    ref = api.track_video(frames, SMALL, device="cpu")
    t = 5 if streaming else 3
    assert tr.positions.shape == (t, 8, 2)
    assert np.abs(tr.positions - ref.positions[:t]).max() < 1e-4
    np.testing.assert_array_equal(tr.track_id, ref.track_id[:t])
    np.testing.assert_array_equal(load(out).positions, tr.positions)
    sm = api.smooth(path, SMALL, device="cpu")
    sm_ref = api.smooth(frames, SMALL, device="cpu")
    np.testing.assert_array_equal(sm.smoothed, sm_ref.smoothed)


def test_export(tmp_path):
    """api.export writes what io.save writes, as .npz and .csv."""
    rng = np.random.default_rng(2)
    tr = Trajectories(positions=rng.random((3, 2, 2)).astype(np.float32),
                      alive=rng.random((3, 2)) > 0.3,
                      nis=rng.random((3, 2)).astype(np.float32),
                      track_id=np.zeros((3, 2), np.int32))
    for ext in ("npz", "csv"):
        a, b = str(tmp_path / f"a.{ext}"), str(tmp_path / f"b.{ext}")
        api.export(tr, a)
        save(tr, b)
        if ext == "csv":
            assert open(a).read() == open(b).read()
        else:
            back = load(a)
            for f in ("positions", "alive", "nis", "track_id"):
                np.testing.assert_array_equal(getattr(back, f),
                                              getattr(tr, f))


@pytest.mark.parametrize("wall", [None, 0.5])
def test_run_report_matches_reference(tmp_path, wall):
    """run_report and write_report give the reference's dict on the same
    trajectories (NIS histogram, gated fraction, live fractions,
    re-seeds, fps)."""
    rng = np.random.default_rng(3)
    T, K = 6, 10
    fields = dict(positions=rng.random((T, K, 2)).astype(np.float32),
                  alive=rng.random((T, K)) > 0.2,
                  nis=(rng.exponential(3.0, (T, K)) *
                       (rng.random((T, K)) > 0.1)).astype(np.float32),
                  track_id=np.cumsum(rng.random((T, K)) > 0.8,
                                     axis=0).astype(np.int32))
    got = report.run_report(Trajectories(**fields), wall, gate_chi2=5.0)
    ref = jreport.run_report(JTrajectories(**fields), wall, gate_chi2=5.0)
    assert got == ref
    assert "nis_hist" in got
    p, q = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert report.write_report(Trajectories(**fields), p, wall, run="x") == \
        jreport.write_report(JTrajectories(**fields), q, wall, run="x")
    assert open(p).read() == open(q).read()
