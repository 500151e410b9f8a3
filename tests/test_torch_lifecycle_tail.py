"""The lifecycle tail (kernels/lifecycle.py, csrc/lifecycle.cu): its plain
version, the chain of models/lifecycle.py's gate, kill_lost and reseed,
against the JAX reference's chain bit for bit (its results read from
tests/torch_ref/); a NumPy float32 model of the CUDA kernel's phases
(the near-live test over a grid of cells, the candidates' 64-bit keys,
each dead slot's look-up at its rank) against the plain version bit for
bit; and the wrapper's CPU path. The kernel itself is held to the plain
version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalman_hydra_tpu.config import EkfConfig, TrackConfig
from kalman_hydra_tpu.models import ekf as jekf
from kalman_hydra_tpu.models import lifecycle as jlife
from kalman_hydra_tpu_torch import config as tconfig
from kalman_hydra_tpu_torch.kernels import lifecycle as klife
from kalman_hydra_tpu_torch.models import dynamics
from kalman_hydra_tpu_torch.models.ekf import TrackState, \
    initial_covariance_on
import torch_threads  # noqa: F401  (one torch thread a worker)
from torch_ref_store import reference

f32 = np.float32

# (K, P, state_dim, adaptive_q, reinit, min_distance, h, w)
CASES = {
    "ties K40 P30 n6": (40, 30, 6, 0.0, True, 8.0, 80, 100),
    "K60 P90 n4 adaptive_q": (60, 90, 4, 0.3, True, 8.0, 80, 100),
    "K1100 P1030 n6": (1100, 1030, 6, 0.0, True, 8.0, 120, 160),
    "reinit off n4 adaptive_q": (50, 0, 4, 0.3, False, 8.0, 80, 100),
    "reinit off n6": (50, 0, 6, 0.0, False, 8.0, 80, 100),
    "min_distance 3": (64, 48, 6, 0.0, True, 3.0, 60, 60),
}


def make_case(name, seed=7):
    """NumPy inputs of one case: dead slots, gated tracks, escapees, tied
    corner scores, nis at f32(gate_chi2) and its neighbours, positions at
    0 and at w - 1 / h - 1 and just outside, candidates exactly
    min_distance from a track."""
    K, Pn, n, aq, reinit, md, h, w = CASES[name]
    rng = np.random.default_rng(seed)
    x = np.zeros((K, n), f32)
    x[:, 0:2] = rng.uniform(-5, [w + 4, h + 4], (K, 2))
    x[:, 2:] = rng.normal(size=(K, n - 2))
    # (XLA on the CPU flushes subnormals to zero, torch does not: the
    # position just below 0 is a normal number)
    below = -f32(2.0 ** -20)
    x[:8, 0] = [0, w - 1, -0.0, np.nextafter(f32(w - 1), f32(w)), below,
                0, w - 1, 3]
    x[:8, 1] = [h - 1, 0, 5, 5, 5, np.nextafter(f32(h - 1), f32(h)), below,
                -0.0]
    x_pred = (x + rng.normal(size=x.shape)).astype(f32)
    x_pred[8:12, 0:2] = x[:4, 0:2]        # gated tracks on the borders
    P = rng.normal(size=(K, n, n)).astype(f32)
    P_pred = rng.normal(size=(K, n, n)).astype(f32)
    g = f32(EkfConfig().gate_chi2)
    nis = rng.uniform(0, 20, K).astype(f32)
    nis[8:14] = [g, np.nextafter(g, f32(0)), np.nextafter(g, f32(99)), g,
                 np.nextafter(g, f32(0)), np.nextafter(g, f32(99))]
    alive = rng.random(K) < 0.7
    alive[:14] = True
    misses = rng.integers(0, 6, K).astype(np.int32)
    misses[:8] = 0
    track_id = rng.integers(0, 3, K).astype(np.int32)
    q_scale = rng.uniform(0.1, 10, K).astype(f32) if aq > 0 else None
    pts = rng.uniform(0, [w, h], (Pn, 2)).astype(f32)
    score = np.round(rng.uniform(-0.2, 1, Pn), 1).astype(f32)   # ties
    inside = (x[:, 0] >= 0) & (x[:, 0] <= w - 1) & (x[:, 1] >= 0) \
        & (x[:, 1] <= h - 1)
    live = np.nonzero(alive[14:] & inside[14:])[0][:min(8, Pn)] + 14
    for j, k in enumerate(live):      # d2 exactly at min_distance^2
        x[k, 0:2] = np.round(x[k, 0:2])
        nis[k], misses[k] = 1, 0
        step = (f32(md) * (-1) ** j, 0) if j % 4 < 2 \
            else (0, f32(md) * (-1) ** j)
        pts[j] = x[k, 0:2] + np.array(step, f32)
        score[j] = 0.9
    return dict(x=x, P=P, x_pred=x_pred, P_pred=P_pred, nis=nis,
                alive=alive, misses=misses, track_id=track_id,
                q_scale=q_scale, pts=pts, score=score, reinit=reinit,
                ekf=dict(state_dim=n, adaptive_q=aq),
                tracks=dict(min_distance=md, num_tracks=K,
                            corner_pool=max(Pn, 1), reinit=reinit),
                h=h, w=w)


def torch_tail(c):
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.array(a))
    ecfg = tconfig.EkfConfig(**c["ekf"])
    state = TrackState(t(c["x"]), t(c["P"]), t(c["alive"]), t(c["misses"]),
                       t(c["track_id"]), t(c["q_scale"]))
    pool = (t(c["pts"]), t(c["score"])) if c["reinit"] else None
    return klife.lifecycle_tail_plain(
        state, t(c["x_pred"]), t(c["P_pred"]), t(c["nis"]), pool,
        initial_covariance_on(ecfg, "cpu"), ecfg,
        tconfig.TrackConfig(**c["tracks"]), c["h"], c["w"])


FIELDS = ("x", "P", "alive", "misses", "track_id", "q_scale")


@pytest.mark.parametrize("name", list(CASES))
def test_tail_plain_matches_reference(name):
    """gate -> kill_lost -> reseed (reseed only with reinit), the port's
    plain tail against the reference's chain: every field bit for bit."""
    c = make_case(name)
    ecfg, tcfg = EkfConfig(**c["ekf"]), TrackConfig(**c["tracks"])
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731

    def chain():
        js = jekf.TrackState(j(c["x"]), j(c["P"]), j(c["alive"]),
                             j(c["misses"]), j(c["track_id"]),
                             j(c["q_scale"]))
        js = jlife.gate(js, j(c["x_pred"]), j(c["P_pred"]), j(c["nis"]),
                        ecfg)
        js = jlife.kill_lost(js, ecfg, c["h"], c["w"])
        if c["reinit"]:
            js = jlife.reseed(js, j(c["pts"]), j(c["score"]), ecfg, tcfg)
        return js
    js = reference(f"lifecycle.tail.{name}", chain,
                   config={"ekf": repr(ecfg), "tracks": repr(tcfg),
                           "reinit": c["reinit"], "h": c["h"],
                           "w": c["w"]},
                   inputs={k: v for k, v in c.items()
                           if isinstance(v, np.ndarray)})
    ts = torch_tail(c)
    for f in FIELDS:
        r, g = getattr(js, f), getattr(ts, f)
        assert (r is None) == (g is None), f
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), f)
    if c["reinit"]:
        assert (ts.track_id.numpy() != c["track_id"]).any()
        if c["q_scale"] is not None:
            assert (ts.q_scale.numpy() == 1).any()


def _ordered(f) -> int:
    u = int(np.array(f, f32).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def kernel_model(c):
    """csrc/lifecycle.cu's phases in NumPy float32: the gate and kill of
    each slot, the dead slots' ranks, the living tracks binned into the
    kernel's grid, each candidate's near-live test over its 3 x 3 cells,
    the keys (inverted order bits over the index) sorted, each dead
    slot's candidate at its rank, then the rows."""
    x, xp, nis, alive = c["x"], c["x_pred"], c["nis"], c["alive"]
    K, n = x.shape
    ecfg = tconfig.EkfConfig(**c["ekf"])
    gate, thr = f32(ecfg.gate_chi2), f32(c["tracks"]["min_distance"] ** 2)
    w1, h1 = f32(c["w"] - 1), f32(c["h"] - 1)
    missed = alive & (nis > gate)
    row = np.where(missed[:, None], xp, x)
    px, py = row[:, 0], row[:, 1]
    m = np.where(missed, c["misses"] + 1,
                 np.where(alive, 0, c["misses"])).astype(np.int32)
    live = alive & (m < ecfg.max_misses) & (px >= 0) & (px <= w1) \
        & (py >= 0) & (py <= h1)
    code = np.where(missed, -2, -1)
    fill = np.zeros(K, bool)
    if c["reinit"]:
        pts, score = c["pts"], c["score"]
        dead = ~live
        rank = np.where(dead, np.cumsum(dead) - 1, -1)
        cell = max(f32(1.01) * np.sqrt(thr, dtype=f32), f32(1),
                   max(w1, h1) * f32(1 / 64))
        inv = f32(1) / f32(cell)
        gx = min(int(np.floor(w1 * inv)) + 1, 65)
        gy = min(int(np.floor(h1 * inv)) + 1, 65)

        def cell_of(v, cells):
            return int(min(max(np.floor(f32(v) * inv), 0), cells - 1))
        bins: dict = {}
        for k in np.nonzero(live)[0]:
            bins.setdefault((cell_of(py[k], gy), cell_of(px[k], gx)),
                            []).append(k)
        cand = np.empty(len(score), f32)
        for i, s in enumerate(score):
            near = False
            if s > 0 and thr > 0:
                cx, cy = cell_of(pts[i, 0], gx), cell_of(pts[i, 1], gy)
                near = any(
                    f32(f32(dx * dx) + f32(dy * dy)) < thr
                    for yy in range(max(cy - 1, 0), min(cy + 1, gy - 1) + 1)
                    for xx in range(max(cx - 1, 0), min(cx + 1, gx - 1) + 1)
                    for k in bins.get((yy, xx), ())
                    for dx, dy in [(f32(pts[i, 0] - px[k]),
                                    f32(pts[i, 1] - py[k]))])
            cand[i] = s if (s > 0 and not near) else -np.inf
        nf = int(np.isfinite(cand).sum())
        keys = sorted(((~_ordered(v) & 0xFFFFFFFF) << 32) | i
                      for i, v in enumerate(cand))
        for k in np.nonzero(dead)[0]:
            if rank[k] < nf and (keys[rank[k]] >> 32) not in (0xFF800000,
                                                              0x007FFFFF):
                fill[k], code[k] = True, keys[rank[k]] & 0xFFFFFFFF
    xo = np.where((code == -2)[:, None], xp, x)
    Po = np.where((code == -2)[:, None, None], c["P_pred"], c["P"])
    P0 = dynamics.initial_covariance(ecfg)
    for k in np.nonzero(fill)[0]:
        xo[k] = 0
        xo[k, 0:2] = c["pts"][code[k]]
        Po[k] = P0
    out = dict(x=xo, P=Po, alive=live | fill,
               misses=np.where(fill, 0, m).astype(np.int32),
               track_id=(c["track_id"] + fill).astype(np.int32),
               q_scale=c["q_scale"])
    if c["q_scale"] is not None:
        out["q_scale"] = np.where(fill, f32(1), c["q_scale"])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_model_matches_plain(name):
    """The kernel's algorithm (the grid's pruning of the near-live test
    at d2 exactly min_distance^2 included) gives the plain tail's bytes."""
    c = make_case(name)
    got, ts = kernel_model(c), torch_tail(c)
    for f in FIELDS:
        r = getattr(ts, f)
        assert (r is None) == (got[f] is None), f
        if r is not None:
            np.testing.assert_array_equal(got[f], r.numpy(), f)


def test_wrapper_on_cpu_runs_the_plain_version():
    """A CPU state takes the plain tail and launches nothing."""
    klife.lifecycle_tail.launches = 0
    c = make_case("K60 P90 n4 adaptive_q")
    ref = torch_tail(c)
    t = torch.from_numpy
    ecfg = tconfig.EkfConfig(**c["ekf"])
    state = TrackState(t(c["x"]), t(c["P"]), t(c["alive"]), t(c["misses"]),
                       t(c["track_id"]), t(c["q_scale"]))
    got = klife.lifecycle_tail(
        state, t(c["x_pred"]), t(c["P_pred"]), t(c["nis"]),
        (t(c["pts"]), t(c["score"])), initial_covariance_on(ecfg, "cpu"),
        ecfg, tconfig.TrackConfig(**c["tracks"]), c["h"], c["w"])
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert klife.lifecycle_tail.launches == 0
    assert initial_covariance_on(ecfg, "cpu") is \
        initial_covariance_on(ecfg, "cpu")


def test_shared_memory_limit():
    """The wrapper's shared-memory count is the kernel's layout, and the
    configurations' sizes up to 8192 tracks and candidates fit."""
    assert klife.smem_bytes(1024, 1024, True) == \
        8 * 1024 + 12 * 1024 + 4 * (65 * 65 + 1)
    assert klife.smem_bytes(2500, 3000, True) == \
        8 * 4096 + 12 * 2500 + 4 * (65 * 65 + 1)
    assert klife.smem_bytes(50, 0, False) == 200
    assert klife.smem_bytes(8192, 8192, True) <= klife.SMEM_MAX
    assert klife.smem_bytes(8192, 16384, True) > klife.SMEM_MAX
