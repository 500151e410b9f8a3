"""Numeric sanitizers (port of kalman_hydra_tpu/utils/debug.py).

`debug_checks()` is the port's `jax_debug_nans`: inside it, each frame
step of `pipeline.make_step` checks that its stage outputs are finite
and raises FloatingPointError naming the stage and the frame. Outside
it the step adds no launch and no host sync: it reads one module flag a
step. `checked_update` is the reference's checkify'd EKF update: it
reports a non-finite innovation residual or an innovation covariance
that is not positive definite instead of returning silent garbage.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_ENABLED = False


@contextlib.contextmanager
def debug_checks():
    """Check every frame step's stage outputs for NaN and inf inside the
    enclosed region (one host sync a stage while on)."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, True
    try:
        yield
    finally:
        _ENABLED = prev


def enabled() -> bool:
    return _ENABLED


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


def check_finite(stage: str, frame: int, *outputs) -> None:
    """Raise FloatingPointError if a floating-point tensor in `outputs`
    (tensors, None, or tuples and lists of them) holds a NaN or an inf."""
    for t in _tensors(outputs):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"debug_checks: non-finite values (nan or inf) in the "
                f"{stage} output of frame {frame}")


class CheckError:
    """The outcome of a checked call, as checkify's Error: `get()` is
    None or the message of the first failed check, `throw()` raises it."""

    def __init__(self, msg: Optional[str] = None):
        self._msg = msg

    def get(self) -> Optional[str]:
        return self._msg

    def throw(self) -> None:
        if self._msg is not None:
            raise ValueError(self._msg)


def checked_update(x, P, y, H, R):
    """models.ekf.update with the reference's two checks: a non-finite
    innovation residual, and an innovation covariance S = H P H^T + R that
    is not positive definite (S[0, 0] > 0 and det S > 0 on every track).
    Returns (err, (x, P, nis)); err.throw() raises. The checks read the
    card's values (one host sync)."""
    from ..models.ekf import update
    msg = None
    if not bool(torch.isfinite(y).all()):
        msg = "non-finite innovation residual"
    else:
        Hb = H if H.ndim == 3 else H.expand((x.shape[0],) + H.shape)
        PHt = torch.einsum("kij,kmj->kim", P, Hb)
        S = torch.einsum("kli,kim->klm", Hb, PHt) + R
        det = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
        if not bool(((S[:, 0, 0] > 0).all() & (det > 0).all())):
            msg = "innovation covariance not positive definite"
    return CheckError(msg), update(x, P, y, H, R)
