"""Debug and profiling (utils/debug.py, utils/profiling.py, the CLI's
`track --profile`) on the CPU: cost and trace to the bars of
tests/unit/test_profiling_utils.py; checked_update raising on a negative
P, as tests/integration/test_fault_injection.py does, and equal to the
plain update (and to the reference's checked update) on sound input;
debug_checks naming the stage and the frame of an injected NaN, and
adding nothing to a step while it is off."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kalman_hydra_tpu.utils import debug as jdebug
from kalman_hydra_tpu_torch import pipeline as tp
from kalman_hydra_tpu_torch.cli import main
from kalman_hydra_tpu_torch.config import FlowConfig, RunConfig, TrackConfig
from kalman_hydra_tpu_torch.io.synthetic import moving_blob_clip
from kalman_hydra_tpu_torch.models import ekf as tekf
from kalman_hydra_tpu_torch.utils import debug
from kalman_hydra_tpu_torch.utils.profiling import cost, trace
import torch_threads  # noqa: F401  (one torch thread a worker)

_SMALL = RunConfig(flow=FlowConfig(levels=2),
                   tracks=TrackConfig(num_tracks=8, corner_pool=16))


def test_cost_analysis_reports_flops():
    """A 64 x 64 matmul: >= 2 * 64^3 * 0.5 FLOPs, and the argument and
    output bytes."""
    out = cost(lambda a, b: a @ b, torch.ones(64, 64), torch.ones(64, 64))
    assert "cost" in out and "memory" in out
    assert out["cost"]["flops"] >= 2 * 64 ** 3 * 0.5
    assert out["memory"]["argument_bytes"] == 2 * 64 * 64 * 4
    assert out["memory"]["output_bytes"] == 64 * 64 * 4
    assert out["memory"]["peak_bytes"] is None       # no card here


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        torch.ones((8, 8)).sum()
    assert os.path.isdir(d) and os.listdir(d)


def _update_inputs(P):
    x = torch.zeros((2, 4))
    y = torch.zeros((2, 2))
    H = torch.zeros((2, 4))
    H[0, 0] = H[1, 1] = 1.0
    return x, P, y, H, 0.25 * torch.eye(2)


def test_checked_update_catches_bad_covariance():
    """A negative P: err.get() names the non-PD innovation covariance
    and err.throw() raises, as the reference's checkify'd update does."""
    err, _ = debug.checked_update(*_update_inputs(-torch.eye(4).expand(
        2, 4, 4)))
    assert err.get() == "innovation covariance not positive definite"
    with pytest.raises(Exception, match="not positive definite"):
        err.throw()


def test_checked_update_catches_nonfinite_residual():
    x, P, y, H, R = _update_inputs(torch.eye(4).expand(2, 4, 4))
    y[1, 0] = float("nan")
    err, _ = debug.checked_update(x, P, y, H, R)
    assert err.get() == "non-finite innovation residual"
    with pytest.raises(Exception):
        err.throw()


def test_checked_update_equals_update_on_sound_input(rng):
    """No error, and the outputs of models.ekf.update (and of the
    reference's checked update, < 1e-5)."""
    k, n = 6, 4
    A = rng.normal(size=(k, n, n)).astype(np.float32)
    P = (A @ A.transpose(0, 2, 1) + np.eye(n, dtype=np.float32)).astype(
        np.float32)
    x = rng.normal(size=(k, n)).astype(np.float32)
    y = rng.normal(size=(k, 2)).astype(np.float32)
    H = np.eye(2, n, dtype=np.float32)
    R = 0.5 * np.eye(2, dtype=np.float32)
    args = [torch.from_numpy(a) for a in (x, P, y, H, R)]
    err, got = debug.checked_update(*args)
    assert err.get() is None
    err.throw()
    for a, b in zip(got, tekf.update(*args)):
        assert torch.equal(a, b)
    jerr, ref = jdebug.checked_update(*(jnp.asarray(a)
                                        for a in (x, P, y, H, R)))
    assert jerr.get() is None
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_debug_checks_name_the_stage_and_frame(monkeypatch):
    """A NaN in frame 2 of a float clip: FloatingPointError naming the
    grayscale stage and frame 2; a NaN that the measurement update
    returns on its second call: the measurement update of frame 2.
    Outside debug_checks the same runs finish silently."""
    clip, _ = moving_blob_clip(num_frames=4, height=48, width=64)
    bad = clip.astype(np.float32)
    bad[2, 10, 10] = np.nan
    ekf_step, calls = tp.ekf_step, []

    def poisoned(state, *a):
        state, aux = ekf_step(state, *a)
        calls.append(1)
        if len(calls) == 2:
            x = state.x.clone()
            x[3, 0] = float("nan")
            state = state._replace(x=x)
        return state, aux
    monkeypatch.setattr(tp, "ekf_step", poisoned)
    with debug.debug_checks():
        with pytest.raises(FloatingPointError,
                           match="grayscale output of frame 2"):
            tp.track_clip(bad, _SMALL, device="cpu")
        calls.clear()
        with pytest.raises(FloatingPointError,
                           match="measurement update output of frame 2"):
            tp.track_clip(clip, _SMALL, device="cpu")
    assert not debug.enabled()
    calls.clear()
    tp.track_clip(clip, _SMALL, device="cpu")


def test_debug_checks_off_adds_nothing(monkeypatch):
    """Off, a step never calls the finiteness check (no sync, no
    launch); on, it checks every stage; nested regions restore the
    previous state."""
    calls = []
    monkeypatch.setattr(debug, "check_finite",
                        lambda stage, *a: calls.append(stage))
    clip, _ = moving_blob_clip(num_frames=3, height=48, width=64)
    tp.track_clip(clip, _SMALL, device="cpu")
    assert calls == []
    with debug.debug_checks():
        with debug.debug_checks():
            assert debug.enabled()
        assert debug.enabled()
        tp.track_clip(clip, _SMALL, device="cpu")
    assert not debug.enabled()
    assert calls[:5] == ["grayscale", "flow pyramid", "flow",
                         "measurement update", "lifecycle"]
    assert len(calls) == 10


def test_cli_track_profile_writes_a_trace(tmp_path):
    """`track --profile DIR` writes a Chrome trace into DIR beside the
    tracks."""
    clip, _ = moving_blob_clip(num_frames=3, height=48, width=64)
    path = str(tmp_path / "clip.npz")
    np.savez_compressed(path, frames=clip)
    prof = tmp_path / "prof"
    assert main(["track", path, "--out", str(tmp_path / "t.npz"),
                 "--tracks", "8", "--profile", str(prof),
                 "--device", "cpu"]) == 0
    files = os.listdir(prof)
    assert files and files[0].endswith(".json")
    assert (tmp_path / "t.npz").exists()
