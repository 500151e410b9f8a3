"""Per-pixel temporal Kalman smoothing of dense flow fields (port of
kalman_hydra_tpu/models/pixel_ekf.py; BASELINE.json:8, config 2).

Every pixel runs an independent constant-velocity KF per flow component
([value, rate], measurement = that component of the frame's flow), in
closed scalar form over the whole (H, W) grid, innovation-gated: a pixel
whose NIS exceeds the chi^2 gate coasts on its prediction. Plain torch:
the reference leaves it to XLA, with no Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class PixelEkfParams(NamedTuple):
    q: float = 0.01       # process noise spectral density (flow units^2)
    r: float = 0.25       # measurement noise variance
    p0: float = 1.0       # initial value variance
    p0_rate: float = 1.0  # initial rate variance
    gate: float = 6.63    # chi^2(1, 0.99) per-component NIS gate
    dt: float = 1.0


class PixelEkfState(NamedTuple):
    """Each field is (2, H, W) (leading axis = flow component u, v)."""

    x: torch.Tensor       # value
    v: torch.Tensor       # rate
    p11: torch.Tensor     # var(value)
    p12: torch.Tensor     # cov(value, rate)
    p22: torch.Tensor     # var(rate)


def init(flow0: torch.Tensor, params: PixelEkfParams) -> PixelEkfState:
    """flow0: (H, W, 2) first measured flow field."""
    x = flow0.movedim(-1, 0)
    z = torch.zeros_like(x)
    return PixelEkfState(x=x, v=z, p11=torch.full_like(x, params.p0),
                         p12=z, p22=torch.full_like(x, params.p0_rate))


def step(state: PixelEkfState, flow: torch.Tensor,
         params: PixelEkfParams) -> Tuple[PixelEkfState, torch.Tensor]:
    """One frame: predict + gated update against the measured (H, W, 2)
    flow. Returns (new_state, smoothed (H, W, 2))."""
    dt, q, r = params.dt, params.q, params.r
    xp = state.x + state.v * dt
    vp = state.v
    p11 = (state.p11 + dt * (2.0 * state.p12 + dt * state.p22)
           + q * dt ** 3 / 3.0)
    p12 = state.p12 + dt * state.p22 + q * dt ** 2 / 2.0
    p22 = state.p22 + q * dt

    y = flow.movedim(-1, 0) - xp
    s = p11 + r
    ok = y * y / s < params.gate
    k1 = torch.where(ok, p11 / s, 0.0)
    k2 = torch.where(ok, p12 / s, 0.0)
    x_new = xp + k1 * y
    # Joseph form for the scalar-gain 2x2 case
    new = PixelEkfState(
        x=x_new, v=vp + k2 * y,
        p11=(1 - k1) * (1 - k1) * p11 + k1 * k1 * r,
        p12=(1 - k1) * (p12 - k2 * p11) + k1 * k2 * r,
        p22=p22 - 2 * k2 * p12 + k2 * k2 * p11 + k2 * k2 * r)
    return new, x_new.movedim(0, -1)


def smooth_flow_sequence(flows: torch.Tensor,
                         params: PixelEkfParams = PixelEkfParams()
                         ) -> torch.Tensor:
    """Filter a (T, H, W, 2) flow sequence -> (T, H, W, 2) smoothed;
    frame 0 initializes the state and passes through."""
    st = init(flows[0], params)
    out = [flows[0]]
    for fl in flows[1:]:
        st, sm = step(st, fl, params)
        out.append(sm)
    return torch.stack(out)
