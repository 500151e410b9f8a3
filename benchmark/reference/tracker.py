"""Plain PyTorch reference of the tracker around the flow: the corner
pool (Shi-Tomasi response, one candidate a min_distance tile, top-k),
the constant-acceleration Kalman filter with position measurements
(predict, Cholesky update, Joseph form), NIS gating, loss and re-seeding
from the corner pool, and the clip loop that strings them together.

Copied, like flow.py, from the arithmetic of kalman_hydra_tpu_torch's
plain versions and imports nothing of the program. The filter always
runs in float32; `ct` only sets the flow layer's dtype.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from . import flow as fl

F32 = torch.float32
_SOBEL = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SMOOTH = np.array([1.0, 2.0, 1.0], dtype=np.float32)


# ------------------------------------------------------------ corners

def min_eig_response(gray: torch.Tensor, block: int) -> torch.Tensor:
    """cv2.cornerMinEigenVal (Sobel-3, box window, 1/(4 255 block))."""
    scale = 1.0 / (4.0 * 255.0 * block)
    gx = fl.correlate1d(fl.correlate1d(gray, _SOBEL, -1), _SMOOTH, -2) * scale
    gy = fl.correlate1d(fl.correlate1d(gray, _SOBEL, -2), _SMOOTH, -1) * scale

    def win(v):
        return fl.box_filter(fl.box_filter(v, block, -2, "reflect101",
                                           normalize=False),
                             block, -1, "reflect101", normalize=False)

    a = win(gx * gx) * 0.5
    b = win(gx * gy) * 0.5
    c = win(gy * gy) * 0.5
    return (a + c) - torch.sqrt((a - c) ** 2 + 4.0 * b * b)


def corner_pool(gray: torch.Tensor, trk, pool_size: int):
    """The best corner of each min_distance tile, then the global top-k
    above quality_level x the best response: (pts (P, 2) (x, y), score
    (P,)); empty slots carry score 0. Ties keep the lower index."""
    resp = min_eig_response(gray.to(F32), trk["corner_block"])
    h, w = resp.shape
    tile = max(int(trk["min_distance"]), 1)
    ph, pw = (tile - h % tile) % tile, (tile - w % tile) % tile
    rp = torch.nn.functional.pad(resp, (0, pw, 0, ph), value=-float("inf"))
    th, tw = rp.shape[0] // tile, rp.shape[1] // tile
    tiles = rp.reshape(th, tile, tw, tile).permute(0, 2, 1, 3).reshape(
        th, tw, tile * tile)
    tile_max = tiles.amax(dim=-1)
    tile_arg = tiles.argmax(dim=-1)
    dev = gray.device
    ys = (torch.arange(th, device=dev)[:, None] * tile
          + tile_arg // tile).to(F32)
    xs = (torch.arange(tw, device=dev)[None, :] * tile
          + tile_arg % tile).to(F32)
    flat = tile_max.reshape(-1)
    thresh = resp.max() * trk["quality_level"]
    flat = torch.where(flat >= thresh, flat, torch.full_like(flat, -np.inf))
    k = min(pool_size, flat.shape[0])
    top, idx = torch.sort(flat, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    pts = torch.stack([xs.reshape(-1)[idx], ys.reshape(-1)[idx]], dim=-1)
    score = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    if k < pool_size:
        pts = torch.nn.functional.pad(pts, (0, 0, 0, pool_size - k))
        score = torch.nn.functional.pad(score, (0, pool_size - k))
    return pts, score


# ------------------------------------------------------------- filter

class Tracks(NamedTuple):
    x: torch.Tensor         # (K, n)
    P: torch.Tensor         # (K, n, n)
    alive: torch.Tensor     # (K,) bool
    misses: torch.Tensor    # (K,) int32
    track_id: torch.Tensor  # (K,) int32


def transition(ekf) -> np.ndarray:
    dt, n = ekf["dt"], ekf["state_dim"]
    F = np.eye(n, dtype=np.float32)
    F[0, 2] = F[1, 3] = dt
    if n == 6:
        F[2, 4] = F[3, 5] = dt
        F[0, 4] = F[1, 5] = 0.5 * dt * dt
    return F


def process_noise(ekf) -> np.ndarray:
    dt, q = ekf["dt"], ekf["q"]
    if ekf["state_dim"] == 4:
        Q = np.zeros((4, 4), dtype=np.float32)
        for i, j in ((0, 2), (1, 3)):
            Q[i, i], Q[j, j] = dt ** 3 / 3.0, dt
            Q[i, j] = Q[j, i] = dt ** 2 / 2.0
        return (q * Q).astype(np.float32)
    blk = np.array([[dt ** 5 / 20, dt ** 4 / 8, dt ** 3 / 6],
                    [dt ** 4 / 8, dt ** 3 / 3, dt ** 2 / 2],
                    [dt ** 3 / 6, dt ** 2 / 2, dt]], dtype=np.float32)
    Q = np.zeros((6, 6), dtype=np.float32)
    for axis in range(2):
        idx = [axis, 2 + axis, 4 + axis]
        for a in range(3):
            for b in range(3):
                Q[idx[a], idx[b]] = blk[a, b]
    return (q * Q).astype(np.float32)


def initial_covariance(ekf) -> np.ndarray:
    d = [ekf["p0_pos"]] * 2 + [ekf["p0_vel"]] * 2
    if ekf["state_dim"] == 6:
        d += [ekf["p0_acc"]] * 2
    return np.diag(d).astype(np.float32)


def init_tracks(ekf, seeds: torch.Tensor, valid: torch.Tensor) -> Tracks:
    k, n, dev = seeds.shape[0], ekf["state_dim"], seeds.device
    x = torch.zeros((k, n), dtype=F32, device=dev)
    x[:, 0:2] = seeds
    P0 = torch.as_tensor(initial_covariance(ekf), device=dev)
    return Tracks(x=x, P=P0.expand(k, n, n).clone(), alive=valid,
                  misses=torch.zeros(k, dtype=torch.int32, device=dev),
                  track_id=torch.zeros(k, dtype=torch.int32, device=dev))


def sample_flow(flow: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear (H, W, 2) flow at (K, 2) points, clipped to w - 1.001."""
    h, w = flow.shape[0], flow.shape[1]
    img = flow.movedim(-1, 0)
    x = torch.clamp(pts[:, 0], 0.0, w - 1.001)
    y = torch.clamp(pts[:, 1], 0.0, h - 1.001)
    x0 = torch.clamp(torch.floor(x), 0, w - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, h - 2).to(torch.int64)
    fx = x - x0.to(F32)
    fy = y - y0.to(F32)
    out = (img[:, y0, x0] * (1 - fx) * (1 - fy)
           + img[:, y0, x0 + 1] * fx * (1 - fy)
           + img[:, y0 + 1, x0] * (1 - fx) * fy
           + img[:, y0 + 1, x0 + 1] * fx * fy)
    return out.T


def _solve_chol(l11, l21, l22, b):
    w1 = b[:, 0] / l11
    w2 = (b[:, 1] - l21 * w1) / l22
    z2 = w2 / l22
    z1 = (w1 - l21 * z2) / l11
    return torch.stack([z1, z2], dim=-1)


def predict_update(x, P, z, F, Q, r: float):
    """x_pred = F x, P_pred = F P F^T + Q; the position update from z:
    S = H P H^T + R through its 2x2 Cholesky, x += K y, Joseph-form P.
    Returns (x_pred, P_pred, x_post, P_post, nis)."""
    n = x.shape[1]
    x_p = torch.einsum("ij,kj->ki", F, x)
    P_p = torch.einsum("kil,jl->kij", torch.einsum("ij,kjl->kil", F, P),
                       F) + Q
    H = torch.zeros((2, n), dtype=F32, device=x.device)
    H[0, 0] = H[1, 1] = 1.0
    R = r * torch.eye(2, dtype=F32, device=x.device)
    y = z - torch.einsum("ij,kj->ki", H, x_p)
    Hk = H.expand(x.shape[0], 2, n)
    PHt = torch.einsum("kij,kmj->kim", P_p, Hk)
    S = torch.einsum("kli,kim->klm", Hk, PHt) + R
    l11 = torch.sqrt(torch.clamp(S[:, 0, 0], min=1e-12))
    l21 = S[:, 1, 0] / l11
    l22 = torch.sqrt(torch.clamp(S[:, 1, 1] - l21 * l21, min=1e-12))
    nis = torch.sum(y * _solve_chol(l11, l21, l22, y), dim=-1)
    Kg = torch.stack([_solve_chol(l11, l21, l22, PHt[:, i, :])
                      for i in range(n)], dim=1)
    x_post = x_p + torch.einsum("kim,km->ki", Kg, y)
    IKH = torch.eye(n, dtype=F32, device=x.device) \
        - torch.einsum("kim,kmj->kij", Kg, Hk)
    P_post = (torch.einsum("kij,kjl,kml->kim", IKH, P_p, IKH)
              + torch.einsum("kim,mn,kjn->kij", Kg, R, Kg))
    return x_p, P_p, x_post, P_post, nis


def filter_step(st: Tracks, flow: torch.Tensor, pool, ekf, trk, F, Q,
                P0) -> Tracks:
    """One frame: measurement z = p + flow(p), predict and update the
    live tracks (the rest keep the prediction), gate on the NIS, kill the
    lost and the departed, re-seed dead slots from the pool."""
    h, w = flow.shape[0], flow.shape[1]
    p_prev = st.x[:, 0:2]
    z = p_prev + sample_flow(flow, p_prev)
    x_p, P_p, x_new, P_new, nis = predict_update(st.x, st.P, z, F, Q,
                                                 ekf["r"])
    live = st.alive
    nis = torch.where(live, nis, torch.zeros_like(nis))
    x = torch.where(live[:, None], x_new, x_p)
    P = torch.where(live[:, None, None], P_new, P_p)
    # gate
    missed = live & (nis > ekf["gate_chi2"])
    x = torch.where(missed[:, None], x_p, x)
    P = torch.where(missed[:, None, None], P_p, P)
    misses = torch.where(missed, st.misses + 1,
                         torch.where(live, torch.zeros_like(st.misses),
                                     st.misses))
    # kill
    pos = x[:, 0:2]
    inb = ((pos[:, 0] >= 0) & (pos[:, 0] <= w - 1)
           & (pos[:, 1] >= 0) & (pos[:, 1] <= h - 1))
    alive = live & (misses < ekf["max_misses"]) & inb
    st = Tracks(x=x, P=P, alive=alive, misses=misses, track_id=st.track_id)
    return reseed(st, *pool, ekf, trk, P0) if trk["reinit"] else st


def reseed(st: Tracks, pts, score, ekf, trk, P0) -> Tracks:
    """Dead slots, in index order, take the best candidates not within
    min_distance of a living track (score order, ties by index)."""
    K = st.x.shape[0]
    pos = st.x[:, 0:2]
    d2 = torch.sum((pts[:, None, :] - pos[None, :, :]) ** 2, dim=-1)
    near = torch.any((d2 < trk["min_distance"] ** 2) & st.alive[None, :],
                     dim=1)
    cand = torch.where((score > 0) & ~near, score,
                       torch.full_like(score, -float("inf")))
    dead = ~st.alive
    order = torch.argsort(-cand, stable=True)
    rank = torch.cumsum(dead.to(torch.int32), 0) - 1
    idx = order[torch.clamp(rank, 0, cand.shape[0] - 1)]
    finite = torch.isfinite(cand)
    ok = dead & (rank < finite.sum()) & finite[idx]
    x_seed = torch.zeros((K, st.x.shape[1]), dtype=F32, device=st.x.device)
    x_seed[:, 0:2] = pts[idx]
    return Tracks(x=torch.where(ok[:, None], x_seed, st.x),
                  P=torch.where(ok[:, None, None], P0[None], st.P),
                  alive=st.alive | ok,
                  misses=torch.where(ok, torch.zeros_like(st.misses),
                                     st.misses),
                  track_id=torch.where(ok, st.track_id + 1, st.track_id))


# --------------------------------------------------------------- clips

def covers(run_cfg: dict) -> None:
    """Refuse a configuration whose semantics this reference does not
    follow: Farneback with the select-sum warp, cold flow, position
    measurements with a shared Q and the 4- or 6-state linear models, no
    smoother, corner seeding over the whole frame."""
    f, e, t = run_cfg["flow"], run_cfg["ekf"], run_cfg["tracks"]
    off = {"flow.method": f["method"] != "farneback",
           "flow.fast_warp": f["fast_warp"] <= 0,
           "flow.temporal_init": f["temporal_init"],
           "ekf.measurement": e["measurement"] != "position",
           "ekf.filter_type": e["filter_type"] != "ekf",
           "ekf.dynamics": e["dynamics"] != "auto",
           "ekf.adaptive_q": e["adaptive_q"] > 0,
           "smooth.enabled": run_cfg["smooth"]["enabled"],
           "tracks.seed_in_body": t["seed_in_body"],
           "tracks.init_velocity": t["init_velocity"]}
    bad = sorted(k for k, v in off.items() if v)
    if bad:
        raise ValueError(f"the reference does not cover {bad}")


def track_frames(frames: Iterable[torch.Tensor], run_cfg: dict,
                 ct=F32, keys=None) -> dict:
    """Track a sequence of (H, W, 3) uint8 frames on their device: frame
    0 seeds the pool from its corners; each next frame's flow from the
    previous frame's pyramid moves the filter; the corner pool is
    refreshed every reinit_every frames. With `keys`, one a frame (equal
    keys for equal frames), each distinct frame's pyramid and corner pool
    and each distinct pair's flow are worked out once: a recording that
    walks a pool of frames back and forth costs the filter's steps and
    no more. Returns host arrays stacked over the frames: pos (T, K, 2),
    alive (T, K), track_id (T, K)."""
    flow_cfg, ekf, trk = run_cfg["flow"], run_cfg["ekf"], run_cfg["tracks"]
    plane = torch.bfloat16 if flow_cfg["bf16_poly"] else F32
    memo = {} if keys is not None else None
    it = iter(frames)
    kit = iter(keys) if keys is not None else None

    def once(key, make):
        if memo is None:
            return make()
        if key not in memo:
            memo[key] = make()
        return memo[key]

    frame0 = next(it)
    k_prev = next(kit) if kit is not None else None
    dev = frame0.device
    F = torch.as_tensor(transition(ekf), device=dev)
    Q = torch.as_tensor(process_noise(ekf), device=dev)
    P0 = torch.as_tensor(initial_covariance(ekf), device=dev)
    gray = fl.grayscale_u8(frame0)
    pts, score = corner_pool(gray, trk, trk["num_tracks"])
    st = init_tracks(ekf, pts, score > 0)
    every = trk["reinit_every"]
    cache = once(("pool", k_prev),
                 lambda: corner_pool(gray, trk, trk["corner_pool"]))
    pyr = once(("pyr", k_prev),
               lambda: fl.polyexp_pyramid(gray, flow_cfg, plane, ct))
    rows = [(st.x[:, 0:2].clone(), st.alive, st.track_id)]
    for t, frame in enumerate(it, start=1):
        key = next(kit) if kit is not None else None
        gray = None

        def gray_of(frame=frame):
            nonlocal gray
            if gray is None:
                gray = fl.grayscale_u8(frame)
            return gray
        nxt = once(("pyr", key), lambda: fl.polyexp_pyramid(
            gray_of(), flow_cfg, plane, ct))
        if every <= 1 or t % every == 0:
            cache = once(("pool", key), lambda: corner_pool(
                gray_of(), trk, trk["corner_pool"]))
        flow = once(("flow", k_prev, key),
                    lambda: fl.farneback(pyr, nxt, flow_cfg, ct))
        st = filter_step(st, flow, cache, ekf, trk, F, Q, P0)
        rows.append((st.x[:, 0:2].clone(), st.alive, st.track_id))
        pyr, k_prev = nxt, key
    return {"pos": torch.stack([r[0] for r in rows]).cpu().numpy(),
            "alive": torch.stack([r[1] for r in rows]).cpu().numpy(),
            "track_id": torch.stack([r[2] for r in rows]).cpu().numpy()}
