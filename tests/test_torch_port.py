"""Port-wide contracts: no jax import, out-of-slice settings refused,
chip_smoke.py fails (and prints no result) without a card."""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kalman_hydra_tpu import config as jconfig
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     SmoothConfig, TrackConfig)
from kalman_hydra_tpu.io import synthetic as jsyn
from kalman_hydra_tpu_torch import config as tconfig
from kalman_hydra_tpu_torch import pipeline
from kalman_hydra_tpu_torch.io import synthetic as tsyn

REPO = Path(__file__).resolve().parents[1]


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_never_imports_jax():
    """Importing every module of the port and tracking a clip on the CPU
    leaves jax out of sys.modules."""
    code = (
        "import sys, pkgutil, importlib, kalman_hydra_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from kalman_hydra_tpu_torch.io.synthetic import moving_blob_clip\n"
        "from kalman_hydra_tpu_torch import api, pipeline\n"
        "clip, _ = moving_blob_clip(num_frames=3, height=64, width=80)\n"
        "tr = api.track_video(clip, pipeline.main_path_config(16))\n"
        "assert tr.positions.shape == (3, 16, 2)\n"
        "print('jax' in sys.modules, 'jaxlib' in sys.modules)\n")
    res = _run(["-c", code], REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names no module of jax or of the JAX package; it
    reaches the shared config and the clip generator through the port."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert "kalman_hydra_tpu_torch.io.synthetic" in mods
    for m in mods:
        top = m.split(".")[0]
        assert top not in ("jax", "jaxlib", "kalman_hydra_tpu"), m


def test_port_config_is_the_shared_config():
    for name in tconfig.__all__:
        assert getattr(tconfig, name) is getattr(jconfig, name)


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
_OUTSIDE = {
    "fi_level_fused": dict(flow=dataclasses.replace(_BASE.flow,
                                                    fi_level_fused=True)),
    "fi_pipeline": dict(flow=dataclasses.replace(_BASE.flow,
                                                 fi_pipeline=True)),
    "exact_warp": dict(flow=dataclasses.replace(_BASE.flow, fast_warp=0)),
    "pe_fused_off": dict(flow=dataclasses.replace(_BASE.flow,
                                                  pe_fused=False)),
    "temporal_init": dict(flow=dataclasses.replace(_BASE.flow,
                                                   temporal_init=True)),
    "lk_dense": dict(flow=dataclasses.replace(_BASE.flow,
                                              method="lk_dense")),
    "pair_batch": dict(pair_batch=True),
    "smoothing": dict(smooth=SmoothConfig(enabled=True)),
    "init_velocity": dict(tracks=TrackConfig(init_velocity=True)),
    "seed_in_body": dict(tracks=TrackConfig(seed_in_body=True)),
    "adaptive_q": dict(ekf=EkfConfig(state_dim=6, adaptive_q=0.5)),
    "implicit_flow": dict(ekf=EkfConfig(measurement="implicit_flow")),
}


@pytest.mark.parametrize("name", sorted(_OUTSIDE))
def test_outside_the_slice_raises(name):
    cfg = _BASE.replace(**_OUTSIDE[name])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipeline.check_slice(cfg)


def test_reference_default_config_is_refused_and_slice_accepted():
    with pytest.raises(NotImplementedError):
        pipeline.check_slice(RunConfig())
    pipeline.check_slice(_BASE)
    pipeline.check_slice(_BASE.replace(
        flow=FlowConfig(fast_warp=4, fi_level_fused=False, gaussian_win=True),
        ekf=EkfConfig(state_dim=4), impl="xla"))
