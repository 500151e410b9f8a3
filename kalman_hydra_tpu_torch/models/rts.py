"""Rauch-Tung-Striebel smoother, batched over tracks (port of
kalman_hydra_tpu/models/rts.py).

Backward recursion over the stacked filter outputs:
  C_t = P_t F^T (P-_{t+1})^-1
  x_s = x_t + C (x_s_{t+1} - x-_{t+1})
  P_s = P_t + C (P_s_{t+1} - P-_{t+1}) C^T
The n x n inverse is a Cholesky solve (n = 4 or 6), through
`cholesky_ex`, which neither syncs with the host nor raises. The
reference's reverse `lax.scan` is a Python loop; it has no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _chol_solve_spd(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for batched SPD (K, n, n) A against (K, n, m) B."""
    L, _ = torch.linalg.cholesky_ex(A)
    W = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), W, upper=True)


def rts_smooth(F: torch.Tensor, x_filt: torch.Tensor, P_filt: torch.Tensor,
               x_pred: torch.Tensor, P_pred: torch.Tensor,
               init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               breaks: Optional[torch.Tensor] = None):
    """Smooth a (T, K, n) filtered trajectory.

    x_pred[t] / P_pred[t] are the one-step predictions *for* frame t.
    `init` optionally provides (x_s, P_s) at the step after the last frame
    of this chunk (chunked smoothing); it defaults to the final filtered
    state, and then x_pred/P_pred are aligned with x_filt (row 0 unused).
    `breaks` ((T-1, K) bool, or (T, K) with `init`) marks track-segment
    boundaries (re-seed / death between t and t+1): the recursion
    restarts from the filtered state there. Returns (x_smooth, P_smooth).
    """
    if init is None:
        xs_next, Ps_next = x_filt[-1], P_filt[-1]
        x_f, P_f, x_p, P_p = x_filt[:-1], P_filt[:-1], x_pred[1:], P_pred[1:]
    else:
        xs_next, Ps_next = init
        x_f, P_f, x_p, P_p = x_filt, P_filt, x_pred, P_pred
    F = torch.as_tensor(F, device=x_f.device)
    xs_rev, Ps_rev = [], []
    for t in range(x_f.shape[0] - 1, -1, -1):
        xf, Pf, xp, Pp = x_f[t], P_f[t], x_p[t], P_p[t]
        FPf = torch.einsum("ij,kjl->kil", F, Pf)
        C = _chol_solve_spd(Pp, FPf).transpose(-1, -2)
        xs = xf + torch.einsum("kij,kj->ki", C, xs_next - xp)
        Ps = Pf + torch.einsum("kij,kjl,kml->kim", C, Ps_next - Pp, C)
        Ps = 0.5 * (Ps + Ps.transpose(-1, -2))
        if breaks is not None:
            brk = breaks[t]
            xs = torch.where(brk[:, None], xf, xs)
            Ps = torch.where(brk[:, None, None], Pf, Ps)
        xs_rev.append(xs)
        Ps_rev.append(Ps)
        xs_next, Ps_next = xs, Ps
    if init is None:
        xs_rev.insert(0, x_filt[-1])
        Ps_rev.insert(0, P_filt[-1])
    return torch.stack(xs_rev[::-1]), torch.stack(Ps_rev[::-1])


def rts_smooth_chunked(F, x_filt, P_filt, x_pred, P_pred, chunk: int,
                       breaks=None, device="cpu"):
    """Host-chunked RTS for long horizons: the (T, K, ...) history stays
    in host memory and `device` holds one `chunk` of it at a time. The
    smoothed boundary state threads between chunks, so the result equals
    the monolithic `rts_smooth`. Returns host (x_smooth, P_smooth)."""
    T = x_filt.shape[0]
    xs_out = torch.empty_like(x_filt)
    Ps_out = torch.empty_like(P_filt)
    xs_out[-1] = x_filt[-1]
    Ps_out[-1] = P_filt[-1]
    init = (x_filt[-1].to(device), P_filt[-1].to(device))
    hi = T - 1
    while hi > 0:
        lo = max(0, hi - chunk)
        # smooth frames [lo, hi): needs predictions for [lo + 1, hi]
        xs_c, Ps_c = rts_smooth(
            F, x_filt[lo:hi].to(device), P_filt[lo:hi].to(device),
            x_pred[lo + 1:hi + 1].to(device),
            P_pred[lo + 1:hi + 1].to(device), init=init,
            breaks=None if breaks is None else breaks[lo:hi].to(device))
        xs_out[lo:hi] = xs_c.cpu()
        Ps_out[lo:hi] = Ps_c.cpu()
        init = (xs_c[0], Ps_c[0])
        hi = lo
    return xs_out, Ps_out


def segment_breaks(track_id: torch.Tensor,
                   alive: torch.Tensor) -> torch.Tensor:
    """(T, K) lifecycle fields -> (T - 1, K) segment breaks: a re-seed or
    a dead frame on either side of the step."""
    return ((track_id[1:] != track_id[:-1]) | ~alive[1:] | ~alive[:-1])


def fixed_lag_smooth(F: torch.Tensor, xf, Pf, xp, Pp, tid, alive):
    """Online fixed-lag smoothing step over the (L+1)-deep window carried
    by the pipeline, oldest first: the smoothed (x, P) of the OLDEST entry,
    the frame leaving the window this step."""
    xs, Ps = rts_smooth(F, xf, Pf, xp, Pp, breaks=segment_breaks(tid, alive))
    return xs[0], Ps[0]
