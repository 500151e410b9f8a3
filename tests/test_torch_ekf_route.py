"""K1's frame-loop route (kernels/ekf.py::ekf_predict_update, one launch
a step from the measurement z, the prediction written too) and its host
side: the plain version against the split route it replaced and the JAX
kernel (Pallas in interpret mode), the C call as the wrapper makes it
(F and Q packed once per pair of arrays), and the constants the frame
loop no longer builds or uploads each step. The kernel runs on the
card, in chip_smoke.py's K1 phases."""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalman_hydra_tpu.kernels.ekf_pallas import ekf_fused_step as ekf_pl
from kalman_hydra_tpu_torch.config import EkfConfig
from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.kernels import ekf as ke
from kalman_hydra_tpu_torch.models import dynamics
from kalman_hydra_tpu_torch.models import ekf as me


def _inputs(rng, K, n, per_track):
    cfg = EkfConfig(state_dim=n)
    x = torch.from_numpy(rng.normal(size=(K, n)).astype(np.float32) * 5)
    A = rng.normal(size=(K, n, n)).astype(np.float32)
    P = torch.from_numpy((A @ A.transpose(0, 2, 1)
                          + np.eye(n, dtype=np.float32)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(K, 2)).astype(np.float32) * 2)
    H = dynamics.position_H(cfg)
    if per_track:
        H = (H[None] + 0.1 * rng.normal(size=(K, 2, n))).astype(np.float32)
    return cfg, x, P, z, torch.from_numpy(H)


@pytest.mark.parametrize("n", (4, 6))
@pytest.mark.parametrize("per_track", (False, True))
def test_predict_update_plain_is_the_split_route(rng, n, per_track):
    """From z: the prediction, then y = z - H x_pred and the update, bit
    for bit the route the frame loop ran before (predict, then K1 on the
    residual; position H makes H x_pred exactly x_pred's position), and
    within 1e-4 of the JAX kernel given that residual."""
    cfg, x, P, z, H = _inputs(rng, 37, n, per_track)
    F, Q = me.transition_noise(cfg)
    xp, Pp, xo, Po, nis = ke.ekf_predict_update(x, P, z, H, F, Q, cfg.r)
    rx, rP = me.predict(x, P, torch.from_numpy(F), torch.from_numpy(Q))
    y = z - (rx[:, 0:2] if not per_track
             else torch.einsum("kij,kj->ki", H, rx))
    ref = ke.ekf_fused_step(x, P, y, H, F, Q, cfg.r)
    assert torch.equal(xp, rx) and torch.equal(Pp, rP)
    if not per_track:
        for a, b in zip((xo, Po, nis), ref):
            assert torch.equal(a, b)
    jref = ekf_pl(*(jnp.asarray(t.numpy()) for t in (x, P, y, H)), F, Q,
                  cfg.r, interpret=True)
    for a, b in zip((xo, Po, nis), jref):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-4


def test_k1_calls_the_c_interface(monkeypatch, rng):
    """One kh_ekf_step call with the C signature's arity: K1's contract
    (y, no prediction out) and the frame loop's (z, x_pred and P_pred
    out); F and Q packed once for a pair of arrays (the same addresses
    on every call, holding F and Q), and no call at K = 0."""
    calls = []

    def function(fname, *argtypes):
        def fn(*args):
            calls.append((fname, len(argtypes), args))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(ke, "_fn", None)      # bound again, to the stub
    monkeypatch.setattr(ke, "_check", lambda t, name: None)
    cfg, x, P, z, H = _inputs(rng, 40, 6, False)
    F, Q = me.transition_noise(cfg)
    ke._launch(x, P, z, H, F, Q, cfg.r, False, False)
    outs = ke._launch(x, P, z, H, F, Q, cfg.r, True, True)
    (_, nargs, a), (_, _, b) = calls
    assert nargs == 17 and len(a) == 17
    assert (a[5], b[5]) == (0, 1) and a[14] is None and a[15] is None
    assert b[14] == outs[0].data_ptr() and b[15] == outs[1].data_ptr()
    assert (a[6], a[7]) == (b[6], b[7])
    got = [np.ctypeslib.as_array((ctypes.c_float * 36).from_address(p))
           for p in a[6:8]]
    assert np.array_equal(got[0].reshape(6, 6), F)
    assert np.array_equal(got[1].reshape(6, 6), Q)
    ke._launch(x[:0], P[:0], z[:0], H, F, Q, cfg.r, True, True)
    assert len(calls) == 2


def test_frame_loop_builds_its_constants_once():
    """F, Q and the position H of a configuration are built (and H
    uploaded) once, not each step."""
    cfg = EkfConfig(state_dim=6)
    assert me.transition_noise(cfg) is me.transition_noise(
        EkfConfig(state_dim=6))
    H = me.position_H_on(cfg, torch.device("cpu"))
    assert H is me.position_H_on(cfg, "cpu")
    assert np.array_equal(H.numpy(), dynamics.position_H(cfg))
