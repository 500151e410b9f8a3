"""Port-wide contracts: no import of jax or of the JAX package, the
port's own config equal to the reference's, entry points on the card by
default, out-of-slice settings refused, chip_smoke.py fails (and prints
no result) without a card."""

import ast
import dataclasses
import inspect
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kalman_hydra_tpu import config as jconfig
from kalman_hydra_tpu.io import export as jexport
from kalman_hydra_tpu.io import synthetic as jsyn
from kalman_hydra_tpu_torch import api, pipeline
from kalman_hydra_tpu_torch import config as tconfig
from kalman_hydra_tpu_torch.io import export as texport
from kalman_hydra_tpu_torch.io import synthetic as tsyn

REPO = Path(__file__).resolve().parents[1]


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_never_imports_jax(tmp_path):
    """Importing every module of the port, tracking clips on the CPU
    through all three paths, with sparse and dense LK, the pair-batched
    exact warp, fi_pipeline and the measurement channels, calling every
    entry point with its default config (track_video, smooth, flow,
    flow_sequence), track_precomputed_flow, track_mesh streamed with
    flow_render (the render update after the flow's) under debug_checks,
    the mesh strain, the profiler's trace and cost, and the port's
    OpenCV/NumPy oracle (`ref`, imported by the walk) tracking a clip
    leaves jax, jaxlib and every module of the JAX package out of
    sys.modules."""
    code = (
        "import sys, pkgutil, importlib, numpy as np\n"
        "import kalman_hydra_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from kalman_hydra_tpu_torch.io.synthetic import moving_blob_clip\n"
        "from kalman_hydra_tpu_torch import api, pipeline\n"
        "clip, _ = moving_blob_clip(num_frames=3, height=64, width=80)\n"
        "tr = api.track_video(clip, pipeline.main_path_config(16),\n"
        "                     device='cpu')\n"
        "assert tr.positions.shape == (3, 16, 2)\n"
        "tr = api.track_video(clip, pipeline.pair_path_config(16),\n"
        "                     device='cpu')\n"
        "assert tr.positions.shape == (3, 16, 2)\n"
        "trs = api.track_videos(np.stack([clip, clip]),\n"
        "    pipeline.main_path_config(16).replace(pair_batch=True),\n"
        "    device='cpu')\n"
        "assert [t.positions.shape for t in trs] == [(3, 16, 2)] * 2\n"
        "assert api.track_video(clip, device='cpu').positions.shape \\\n"
        "    == (3, 256, 2)\n"
        "assert api.smooth(clip, device='cpu').smoothed.shape == (3, 256, 2)\n"
        "assert api.flow(clip[0], clip[1], device='cpu').shape == (64, 80, 2)\n"
        "assert api.flow_sequence(clip, smooth=True, device='cpu').shape \\\n"
        "    == (2, 64, 80, 2)\n"
        "from kalman_hydra_tpu_torch.config import FlowConfig, RunConfig\n"
        "for m in ('lk_sparse', 'lk_dense'):\n"
        "    c = RunConfig(flow=FlowConfig(method=m, levels=2))\n"
        "    tr = api.track_video(clip, c, device='cpu')\n"
        "    assert tr.positions.shape == (3, 256, 2)\n"
        "from kalman_hydra_tpu_torch.config import EkfConfig, TrackConfig\n"
        "f2 = FlowConfig(levels=2)\n"
        "for c in (RunConfig(flow=f2, pair_batch=True),\n"
        "          RunConfig(flow=FlowConfig(levels=2, fast_warp=8,\n"
        "                    fi_level_fused=False, fi_pipeline=True)),\n"
        "          RunConfig(flow=f2, ekf=EkfConfig(\n"
        "              measurement='implicit_flow', filter_type='ukf')),\n"
        "          RunConfig(flow=f2, ekf=EkfConfig(\n"
        "              measurement='photometric', adaptive_q=0.3)),\n"
        "          RunConfig(flow=f2, ekf=EkfConfig(\n"
        "              measurement='flow_photometric'),\n"
        "              tracks=TrackConfig(seed_in_body=True))):\n"
        "    tr = api.track_video(clip, c, device='cpu')\n"
        "    assert tr.positions.shape == (3, 256, 2)\n"
        "fl = api.flow_sequence(clip, RunConfig(flow=f2), device='cpu')\n"
        "tr = pipeline.track_precomputed_flow(fl, np.ones((4, 2)),\n"
        "                                     RunConfig(), device='cpu')\n"
        "assert tr.positions.shape == (3, 4, 2)\n"
        "from kalman_hydra_tpu_torch.io.synthetic import deforming_body_clip\n"
        "from kalman_hydra_tpu_torch.models import mesh as M\n"
        "from kalman_hydra_tpu_torch.utils import debug, profiling\n"
        "import torch\n"
        "body, _, _ = deforming_body_clip(num_frames=3, height=64, width=80)\n"
        "c = RunConfig(flow=f2, ekf=EkfConfig(measurement='flow_render'),\n"
        "              tracks=TrackConfig(reinit=False))\n"
        "with debug.debug_checks():\n"
        "    mesh, tr = api.track_mesh(body, c, n_vertices=8,\n"
        "                              streaming=True, device='cpu')\n"
        "assert tr.positions.shape == (3, 8, 2)\n"
        "M.mesh_strain_sequence_dynamic(mesh, tr.positions, device='cpu')\n"
        "with profiling.trace(sys.argv[1]):\n"
        "    profiling.cost(torch.mm, torch.ones(4, 4), torch.ones(4, 4))\n"
        "from kalman_hydra_tpu_torch.ref import pipeline as rp\n"
        "tr = rp.track_clip(clip, RunConfig(flow=f2,\n"
        "                   tracks=TrackConfig(num_tracks=8)))\n"
        "assert tr.positions.shape[0] == 3 and tr.alive.all()\n"
        "ref = [m for m in sys.modules if m.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'kalman_hydra_tpu')]\n"
        "print(ref)\n")
    res = _run(["-c", code, str(tmp_path / "prof")], REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_port_import_leaves_the_oracle_out():
    """Importing the port, its API, pipeline, CLI and parallel paths
    imports neither its OpenCV/NumPy oracle (`kalman_hydra_tpu_torch.ref`)
    nor cv2: the port runs on a host without OpenCV."""
    code = (
        "import sys\n"
        "import kalman_hydra_tpu_torch\n"
        "from kalman_hydra_tpu_torch import api, cli, parallel, pipeline\n"
        "print(sorted(m for m in sys.modules if m == 'cv2'\n"
        "             or m.startswith('kalman_hydra_tpu_torch.ref')))\n")
    res = _run(["-c", code], REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names no module of jax or of the JAX package; it
    takes the config and the clip generator from the port."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert "kalman_hydra_tpu_torch.io.synthetic" in mods
    for m in mods:
        top = m.split(".")[0]
        assert top not in ("jax", "jaxlib", "kalman_hydra_tpu"), m


_CONFIG_CLASSES = ("FlowConfig", "EkfConfig", "TrackConfig", "SmoothConfig",
                   "RunConfig")


@pytest.mark.parametrize("name", _CONFIG_CLASSES)
def test_port_config_matches_reference_fields(name):
    """The port's own copy of each config dataclass has the reference's
    field names, in order, and defaults; and it is a copy, not the
    reference's class."""
    tcls, jcls = getattr(tconfig, name), getattr(jconfig, name)
    assert tcls is not jcls
    tf, jf = dataclasses.fields(tcls), dataclasses.fields(jcls)
    assert [f.name for f in tf] == [f.name for f in jf]
    t0, j0 = tcls(), jcls()
    for f in tf:
        a, b = getattr(t0, f.name), getattr(j0, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("which", ["default", "main_path", "pair_path",
                                   "edited"])
def test_port_config_json_round_trip(which):
    """A reference RunConfig crosses into the port through JSON and back
    unchanged, and the port's slice configs cross the other way."""
    jcfgs = {
        "default": jconfig.RunConfig(),
        "edited": jconfig.RunConfig(
            flow=jconfig.FlowConfig(levels=3, winsize=13, gaussian_win=True,
                                    fast_warp=4),
            ekf=jconfig.EkfConfig(state_dim=6, q=0.1),
            tracks=jconfig.TrackConfig(num_tracks=32, reinit_every=2),
            impl="pallas", pair_batch=True),
    }
    if which in jcfgs:
        jcfg = jcfgs[which]
        tcfg = tconfig.RunConfig.from_json(jcfg.to_json())
    else:
        tcfg = getattr(pipeline, f"{which}_config")()
        jcfg = jconfig.RunConfig.from_json(tcfg.to_json())
    assert isinstance(tcfg, tconfig.RunConfig)
    assert tcfg.to_json() == jcfg.to_json()
    assert tconfig.RunConfig.from_json(tcfg.to_json()) == tcfg


_INVALID = {
    "flow_method": lambda c: c.FlowConfig(method="sift"),
    "pyr_scale": lambda c: c.FlowConfig(pyr_scale=1.0),
    "poly_n_even": lambda c: c.FlowConfig(poly_n=4),
    "fi_tile_h": lambda c: c.FlowConfig(fi_tile_h=-1),
    "temporal_init_lk": lambda c: c.FlowConfig(method="lk_dense",
                                               temporal_init=True),
    "state_dim": lambda c: c.EkfConfig(state_dim=5),
    "ct_dynamics": lambda c: c.EkfConfig(dynamics="ct"),
    "smooth_chunk": lambda c: c.SmoothConfig(chunk=-1),
    "impl": lambda c: c.RunConfig(impl="cuda"),
    "pair_batch_lk_sparse": lambda c: c.RunConfig(
        flow=c.FlowConfig(method="lk_sparse"), pair_batch=True),
    "pair_batch_temporal_init": lambda c: c.RunConfig(
        flow=c.FlowConfig(temporal_init=True), pair_batch=True),
    "pair_batch_photometric": lambda c: c.RunConfig(
        ekf=c.EkfConfig(measurement="photometric"), pair_batch=True),
}


@pytest.mark.parametrize("name", sorted(_INVALID))
def test_port_config_refuses_what_reference_refuses(name):
    """The same invalid configs raise the same ValueError in both."""
    msgs = []
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError) as e:
            _INVALID[name](mod)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_port_export_round_trips_with_reference(tmp_path):
    """The port's own Trajectories/save/load read and write the
    reference's files."""
    rng = np.random.default_rng(0)
    tr = texport.Trajectories(
        positions=rng.normal(size=(3, 4, 2)).astype(np.float32),
        alive=rng.random((3, 4)) < 0.5,
        nis=rng.random((3, 4)).astype(np.float32),
        track_id=np.arange(12, dtype=np.int32).reshape(3, 4))
    texport.save(tr, str(tmp_path / "t.npz"))
    back = jexport.load(str(tmp_path / "t.npz"))
    jexport.save(back, str(tmp_path / "j.npz"))
    again = texport.load(str(tmp_path / "j.npz"))
    for f in ("positions", "alive", "nis", "track_id"):
        np.testing.assert_array_equal(getattr(again, f), getattr(tr, f))
    assert again.smoothed is None
    texport.save(tr, str(tmp_path / "t.csv"))
    jexport.save(back, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == \
        (tmp_path / "j.csv").read_text()


_ENTRY_POINTS = {
    "api.track_video": lambda clip, dev: api.track_video(
        clip, pipeline.main_path_config(8), **dev),
    "api.track_videos": lambda clip, dev: api.track_videos(
        clip[None], pipeline.main_path_config(8), **dev),
    "pipeline.track_clip": lambda clip, dev: pipeline.track_clip(
        clip, pipeline.main_path_config(8), **dev),
    "api.flow": lambda clip, dev: api.flow(clip[0], clip[1], **dev),
    "api.flow_sequence": lambda clip, dev: api.flow_sequence(clip, **dev),
    "api.smooth": lambda clip, dev: api.smooth(clip, **dev),
    "pipeline.track_precomputed_flow":
        lambda clip, dev: pipeline.track_precomputed_flow(
            np.zeros((1, 48, 64, 2), np.float32), np.ones((2, 2)),
            tconfig.RunConfig(), **dev),
    "pipeline.track_stream": lambda clip, dev: pipeline.track_stream(
        iter(clip), pipeline.main_path_config(8), **dev),
    "api.track_mesh": lambda clip, dev: api.track_mesh(clip, None, None, 8,
                                                       **dev),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """device defaults to "cuda"; without a card the call raises rather
    than running on the CPU, and device="cpu" runs there."""
    mod, fn = name.split(".")
    fn = getattr(api if mod == "api" else pipeline, fn)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    clip, _ = tsyn.moving_blob_clip(num_frames=2, height=48, width=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _ENTRY_POINTS[name](clip, {})
    _ENTRY_POINTS[name](clip, {"device": "cpu"})


_SMALL = tconfig.RunConfig(flow=tconfig.FlowConfig(levels=2),
                           tracks=tconfig.TrackConfig(num_tracks=8))
# each entry point called as a caller of the reference writes it: every
# parameter of the reference positional, `device` by keyword
_REFERENCE_FORM = {
    "api.track_video": lambda clip, tmp: api.track_video(
        clip, _SMALL, str(tmp / "t.npz"), False, 3, device="cpu"),
    "api.track_videos": lambda clip, tmp: api.track_videos(
        clip[None], _SMALL, False, device="cpu"),
    "api.flow": lambda clip, tmp: api.flow(
        clip[0], clip[1], _SMALL.flow, None, device="cpu"),
    "api.flow_sequence": lambda clip, tmp: api.flow_sequence(
        clip, _SMALL, False, device="cpu"),
    "api.smooth": lambda clip, tmp: api.smooth(clip, _SMALL, device="cpu"),
    "pipeline.track_clip": lambda clip, tmp: pipeline.track_clip(
        clip, _SMALL, np.full((8, 2), 20.0, np.float32), False, None,
        device="cpu"),
    "pipeline.track_precomputed_flow":
        lambda clip, tmp: pipeline.track_precomputed_flow(
            np.zeros((2, 48, 64, 2), np.float32), np.ones((2, 2)), _SMALL,
            device="cpu"),
    "pipeline.track_stream": lambda clip, tmp: pipeline.track_stream(
        iter(clip), _SMALL, None, None, 0, False, None, None,
        device="cpu"),
    "api.track_mesh": lambda clip, tmp: api.track_mesh(
        clip, None, None, 8, 0, False, device="cpu")[1],
}


@pytest.mark.parametrize("name", sorted(_REFERENCE_FORM))
def test_entry_points_take_the_reference_positional_form(name, tmp_path):
    """Each entry point has the reference's positional parameters, in
    its order, and `device` only as a keyword; a call in the reference's
    positional form runs on the CPU with the reference's result shape."""
    from kalman_hydra_tpu import api as japi
    from kalman_hydra_tpu import pipeline as jpipeline
    mod, fn = name.split(".")
    ours = inspect.signature(getattr(api if mod == "api" else pipeline, fn))
    ref = inspect.signature(getattr(japi if mod == "api" else jpipeline, fn))

    def positional(sig):
        return [p.name for p in sig.parameters.values()
                if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]
    assert positional(ours) == positional(ref)
    assert ours.parameters["device"].kind is inspect.Parameter.KEYWORD_ONLY
    clip, _ = tsyn.moving_blob_clip(num_frames=3, height=48, width=64)
    out = _REFERENCE_FORM[name](clip, tmp_path)
    if name == "api.track_videos":
        out = out[0]
    shape = out.shape if isinstance(out, np.ndarray) else out.positions.shape
    assert shape == {"api.flow": (48, 64, 2),
                     "api.flow_sequence": (2, 48, 64, 2)}.get(
        name, (3, 2 if "precomputed" in name else 8, 2))
    if name == "api.track_video":
        assert texport.load(str(tmp_path / "t.npz")).positions.shape == \
            (3, 8, 2)


@pytest.mark.parametrize("kw", [
    dict(num_frames=3, height=64, width=80),
    dict(num_frames=4, height=90, width=120, blob_sigma=9.0,
         velocity=(2.1, -1.4), accel=(0.1, 0.05), num_points=5, seed=3),
    dict(num_frames=2, height=48, width=48, color=False, seed=7),
])
def test_moving_blob_clip_matches_reference(kw):
    """The port's clip generator gives the reference's frames byte for
    byte, and the same ground truth."""
    fa, ta = tsyn.moving_blob_clip(**kw)
    fb, tb = jsyn.moving_blob_clip(**kw)
    assert fa.dtype == fb.dtype == np.uint8 and fa.shape == fb.shape
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ta.positions, tb.positions)
    np.testing.assert_array_equal(ta.velocity, tb.velocity)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card(alone, tmp_path):
    """On a host without CUDA (or with the script alone, away from the
    package) chip_smoke.py exits non-zero and prints no result line."""
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = _run(["chip_smoke.py"], cwd)
    assert res.returncode != 0
    for line in res.stdout.splitlines():
        try:
            assert json.loads(line).get("ok") is not True
        except (json.JSONDecodeError, AttributeError):
            pass


_BASE = pipeline.main_path_config(16)
_RENDER = dict(tracks=tconfig.TrackConfig(num_tracks=16, reinit=False))


def _wrong_template():
    from kalman_hydra_tpu_torch.models.mesh import build_mesh
    from kalman_hydra_tpu_torch.models.render import make_template
    pts = np.float32([[10, 10], [40, 10], [10, 30], [40, 30]])
    return make_template(np.zeros((48, 64), np.float32), build_mesh(pts),
                         device="cpu")


# poly_n past the polynomial expansion's tiles (F4's limit), which the
# sharded paths refuse too
_POLY_53 = tconfig.RunConfig(flow=tconfig.FlowConfig(
    levels=2, fast_warp=8, poly_n=53, poly_sigma=10.0),
    tracks=tconfig.TrackConfig(num_tracks=8))
# name: (call, the exception it raises, what its message names)
_OUTSIDE = {
    "render": (lambda: pipeline.make_step(_BASE.replace(
        ekf=tconfig.EkfConfig(measurement="render"), **_RENDER), "cpu"),
        ValueError, "RenderTemplate"),
    "flow_render": (lambda: pipeline.make_step(_BASE.replace(
        ekf=tconfig.EkfConfig(measurement="flow_render"), **_RENDER), "cpu"),
        ValueError, "RenderTemplate"),
    "track_video_streaming": (lambda: api.track_video(
        np.zeros((2, 48, 64), np.uint8), _BASE.replace(
            ekf=tconfig.EkfConfig(measurement="render"), **_RENDER),
        streaming=True, device="cpu"), ValueError, "RenderTemplate"),
    "track_videos_sharded": (lambda: api.track_videos(
        np.zeros((1, 2, 48, 64), np.uint8), _POLY_53, sharded=True,
        device="cpu"), NotImplementedError, "F4"),
    "flow_sharded": (lambda: api.flow_sharded(
        np.zeros((48, 64), np.uint8), np.zeros((48, 64), np.uint8),
        _POLY_53.flow, device="cpu"), NotImplementedError, "F4"),
    "cli_bench": (lambda: __import__(
        "kalman_hydra_tpu_torch.cli", fromlist=["main"]).main(
        ["bench", "--quick"]), NotImplementedError, "ROADMAP P6"),
    "track_clip_render_tmpl": (lambda: pipeline.track_clip(
        np.zeros((2, 48, 64), np.uint8), tconfig.RunConfig(), None, False,
        _wrong_template(), device="cpu"), ValueError, "vertices"),
}


@pytest.mark.parametrize("name", sorted(_OUTSIDE))
def test_outside_the_slice_raises(name):
    """What the port cannot run raises: the benchmark harness
    (NotImplementedError naming ROADMAP P6) and poly_n past F4's limit,
    on the sharded paths too (clips or frame rows over a mesh run since
    P13); the mesh-render channels, ported since P11b, without their
    template or with a template that is not the track pool (ValueError,
    as the reference's make_step)."""
    call, exc, match = _OUTSIDE[name]
    with pytest.raises(exc, match=match):
        call()


def test_not_implemented_only_for_p6_and_f4():
    """The port raises NotImplementedError in two places only: the CLI's
    bench (naming ROADMAP P6) and check_slice's poly_n limit (F4); the
    sharded paths (P13) run at device="cpu", the mesh-render channels,
    the CLI's mesh and track --profile run, and the render
    configurations pass check_slice."""
    import re
    pkg = REPO / "kalman_hydra_tpu_torch"
    raised = []
    for f in pkg.rglob("*.py"):
        text = f.read_text()
        for m in re.finditer(r"raise NotImplementedError\(", text):
            raised.append(text[m.end():m.end() + 300])
    assert len(raised) == 2
    assert sorted(bool(re.search(r"ROADMAP P6", m)) for m in raised) == \
        [False, True]
    for msg in raised:
        assert re.search(r"ROADMAP P6|F4", msg), msg
    clip, _ = tsyn.moving_blob_clip(num_frames=2, height=48, width=64)
    trs = api.track_videos(np.stack([clip, clip]), _SMALL, sharded=True,
                           device="cpu")
    assert [t.positions.shape for t in trs] == [(2, 8, 2)] * 2
    gray = clip[..., 0]
    for method in ("farneback", "lk_dense"):
        assert api.flow_sharded(
            gray[0], gray[1], dataclasses.replace(_SMALL.flow, fast_warp=8),
            method, device="cpu").shape == (48, 64, 2)
    for meas in ("render", "flow_render"):
        pipeline.check_slice(_BASE.replace(
            ekf=tconfig.EkfConfig(measurement=meas), **_RENDER))


_SETTINGS_CONFIGS = {
    "fi_pipeline": dict(flow=dataclasses.replace(_BASE.flow,
                                                 fi_pipeline=True)),
    "pair_batch_implicit_flow": dict(
        pair_batch=True, ekf=tconfig.EkfConfig(measurement="implicit_flow")),
    "pair_batch_exact_warp": dict(
        pair_batch=True, flow=dataclasses.replace(_BASE.flow, fast_warp=0)),
    "seed_in_body": dict(tracks=tconfig.TrackConfig(num_tracks=16,
                                                    seed_in_body=True)),
    "adaptive_q": dict(ekf=tconfig.EkfConfig(state_dim=6, adaptive_q=0.5)),
    "implicit_flow": dict(ekf=tconfig.EkfConfig(
        measurement="implicit_flow")),
}


@pytest.mark.parametrize("name", sorted(_SETTINGS_CONFIGS))
def test_slice_settings_run(name):
    """The settings the slices before the measurement channels refused
    (fi_pipeline, the pair-batched exact warp, implicit_flow alone and
    pair-batched, seed_in_body, adaptive_q) are accepted and run on the
    CPU with the reference's result shape (T, K, 2)."""
    cfg = _BASE.replace(**_SETTINGS_CONFIGS[name])
    pipeline.check_slice(cfg)
    clip, _ = tsyn.moving_blob_clip(num_frames=3, height=48, width=64)
    tr = api.track_video(clip, cfg.replace(flow=dataclasses.replace(
        cfg.flow, levels=2)), device="cpu")
    assert tr.positions.shape == (3, 16, 2)
    assert np.isfinite(tr.positions).all()


_LK = tconfig.FlowConfig(method="lk_dense")
_LK_RUNS = {
    "api_flow_lk_dense": lambda: api.flow(
        np.zeros((48, 64), np.uint8), np.zeros((48, 64), np.uint8), _LK,
        device="cpu").shape == (48, 64, 2),
    "flow_sequence_lk_dense": lambda: api.flow_sequence(
        np.zeros((2, 48, 64), np.uint8), tconfig.RunConfig(flow=_LK),
        device="cpu").shape == (1, 48, 64, 2),
}


@pytest.mark.parametrize("name", sorted(_LK_RUNS))
def test_lk_entry_points_run(name):
    """The dense-LK calls that the slices before LK refused run, with
    the shape of the reference's result."""
    assert _LK_RUNS[name]()


@pytest.mark.parametrize("method", ["lk_sparse", "lk_dense"])
def test_lk_track_video_defaults_to_the_card(method):
    """api.track_video with an LK config needs a card unless it is given
    device="cpu", and then runs there."""
    cfg = tconfig.RunConfig(flow=tconfig.FlowConfig(method=method,
                                                    levels=2),
                            tracks=tconfig.TrackConfig(num_tracks=8))
    clip, _ = tsyn.moving_blob_clip(num_frames=2, height=48, width=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.track_video(clip, cfg)
    assert api.track_video(clip, cfg, device="cpu").positions.shape == \
        (2, 8, 2)


def test_track_videos_sharded_raises():
    """track_videos(sharded=True) refuses what check_slice refuses (F4's
    poly_n) and a batch that does not split over the mesh."""
    from kalman_hydra_tpu_torch.parallel import Mesh, track_clips_sharded
    clip, _ = tsyn.moving_blob_clip(num_frames=2, height=48, width=64)
    with pytest.raises(NotImplementedError, match="F4"):
        api.track_videos(clip[None], _POLY_53, sharded=True, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        track_clips_sharded(np.stack([clip] * 3), _SMALL, Mesh(["cpu"] * 2))


def test_reference_default_config_is_refused_and_slice_accepted():
    """RunConfig(), the reference's default (the exact warp), is inside
    the slice now, as are the main path and a fast-warp 4-state variant."""
    pipeline.check_slice(tconfig.RunConfig())
    pipeline.check_slice(_BASE)
    pipeline.check_slice(_BASE.replace(
        flow=tconfig.FlowConfig(fast_warp=4, fi_level_fused=False,
                                gaussian_win=True),
        ekf=tconfig.EkfConfig(state_dim=4), impl="xla"))


_ACCEPTED = {
    "main_path": pipeline.main_path_config(),
    "pair_path": pipeline.pair_path_config(),
    "main_path_pair_batch":
        pipeline.main_path_config().replace(pair_batch=True),
    "exact_warp": _BASE.replace(
        flow=dataclasses.replace(_BASE.flow, fast_warp=0)),
    "pe_fused_off": _BASE.replace(
        flow=dataclasses.replace(_BASE.flow, pe_fused=False)),
    "temporal_init": _BASE.replace(
        flow=dataclasses.replace(_BASE.flow, temporal_init=True)),
    "smoothing": _BASE.replace(smooth=tconfig.SmoothConfig(enabled=True)),
    "init_velocity": _BASE.replace(
        tracks=tconfig.TrackConfig(init_velocity=True)),
    "lk_dense": _BASE.replace(flow=dataclasses.replace(_BASE.flow,
                                                       method="lk_dense")),
    "pair_batch_lk_dense": _BASE.replace(
        pair_batch=True, flow=dataclasses.replace(_BASE.flow,
                                                  method="lk_dense")),
    "pair_batch_lk_dense_exact_warp": _BASE.replace(
        pair_batch=True, flow=dataclasses.replace(
            _BASE.flow, method="lk_dense", fast_warp=0)),
    "lk_sparse": tconfig.RunConfig(flow=tconfig.FlowConfig(
        method="lk_sparse")),
    "lk_sparse_block_halo": _BASE.replace(flow=dataclasses.replace(
        _BASE.flow, method="lk_sparse", lk_block_halo=8,
        lk_solver="corr_conv")),
    "fi_pipeline": _BASE.replace(flow=dataclasses.replace(
        _BASE.flow, fi_pipeline=True)),
    "pair_batch_exact_warp": tconfig.RunConfig(pair_batch=True),
    "ukf": _BASE.replace(ekf=tconfig.EkfConfig(
        measurement="implicit_flow", filter_type="ukf")),
    "photometric": _BASE.replace(ekf=tconfig.EkfConfig(
        measurement="photometric")),
    "flow_photometric_adaptive_q_seed_in_body": _BASE.replace(
        ekf=tconfig.EkfConfig(measurement="flow_photometric",
                              adaptive_q=0.3),
        tracks=tconfig.TrackConfig(seed_in_body=True)),
}


@pytest.mark.parametrize("which", sorted(_ACCEPTED))
def test_slice_configs_accepted(which):
    """The headline graph (fi_level_fused=True), bench cfg3's pair path,
    the multi-clip pair path, the main path under each setting the
    earlier slices brought in (the exact warp, pe_fused=False,
    temporal_init, smoothing, init_velocity), Lucas-Kanade (dense per
    frame and pair-batched at both warps, sparse with the reference's
    defaults and with a halo'd block), fi_pipeline, the pair-batched
    exact warp and the measurement channels (UKF, photometric,
    flow_photometric with adaptive_q and seed_in_body) are inside the
    slice."""
    cfg = _ACCEPTED[which]
    assert cfg.flow.fi_level_fused
    pipeline.check_slice(cfg)
