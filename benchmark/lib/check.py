"""The output check: each clip a call tracked against the reference's
rows for the same footage.

A track is a slot's run between re-seeds, known by where it began: the
frame its slot's id last changed (frame 0 for the first) and the corner
it was seeded at. A program track and a reference track match at a
frame where both are alive and began at the same frame on the same
corner, whatever slot holds each: the re-seeds fill dead slots in index
order, so one slot that lives on one side and dies on the other moves
every later re-seed to another slot. Two numbers are compared, each
with its limit (limits/<cell>.json):

- `pos_gap_px`, the largest distance between the positions of matched
  tracks, at any frame of a clip: the flow and the filter;
- `track_mismatch`, the share of the tracks alive on either side at a
  frame that are unmatched, summed over the frames of a clip: the
  lifecycle (alive, kill, re-seed, track_id). Sound runs read a little
  over 0: tracks seeded on the frame's edge rows stand still within
  1e-8 px of the edge, where the kill test (position >= 0) falls either
  way on rounding.

A call fails if it raised, returned another number of clips or rows
than it was given, or any of its clips reads over a limit. `correct`
holds when some call ran and none failed.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("pos_gap_px", "track_mismatch")


def _keys(pos: np.ndarray, tid: np.ndarray) -> np.ndarray:
    """(T, K) int64 key of each (frame, slot)'s track: the frame it began
    (its slot's id last changed; frame 0 for the first) and the corner,
    whole pixels, it began at."""
    start_t = np.zeros(tid.shape, np.int64)
    start_p = np.rint(np.asarray(pos, np.float64)).astype(np.int64)
    for t in range(1, tid.shape[0]):
        new = tid[t] != tid[t - 1]
        start_t[t] = np.where(new, t, start_t[t - 1])
        start_p[t] = np.where(new[:, None], start_p[t], start_p[t - 1])
    xy = np.clip(start_p, 0, (1 << 21) - 1)
    return (start_t << 42) | (xy[..., 0] << 21) | xy[..., 1]


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of one clip (inf where the shapes differ)."""
    pp, pr = np.asarray(prog["pos"]), np.asarray(ref["pos"])
    ap, ar = np.asarray(prog["alive"]), np.asarray(ref["alive"])
    ip, ir = np.asarray(prog["track_id"]), np.asarray(ref["track_id"])
    if not (pp.shape == pr.shape and ap.shape == ar.shape == ip.shape
            == ir.shape == pp.shape[:2]):
        return dict.fromkeys(NUMBERS, math.inf)
    ap, ar = ap.astype(bool), ar.astype(bool)
    kp, kr = _keys(pp, ip), _keys(pr, ir)
    gap, unmatched, either = 0.0, 0, 0
    for t in range(pp.shape[0]):
        sp, sr = np.flatnonzero(ap[t]), np.flatnonzero(ar[t])
        both, i, j = np.intersect1d(kp[t, sp], kr[t, sr],
                                    return_indices=True)
        if both.size:
            d = np.linalg.norm(pp[t, sp[i]].astype(np.float64)
                               - pr[t, sr[j]].astype(np.float64), axis=-1)
            gap = max(gap, float(d.max()) if np.isfinite(d).all()
                      else math.inf)
        either += sp.size + sr.size - both.size
        unmatched += sp.size + sr.size - 2 * both.size
    return {"pos_gap_px": gap,
            "track_mismatch": unmatched / max(either, 1)}


def judge(driver, calls, ref: dict, limits: dict) -> dict:
    """{"failed", "worst" {number: value}, "errors" [first few]} over
    every call."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    failed, errors = 0, []
    for c in calls:
        ok = c.error is None and c.outs is not None \
            and len(c.outs) == driver.expected(c)
        if ok:
            for key, out in driver.answers(c):
                r = compare(out, ref[key])
                worst = {k: max(worst[k], r[k]) for k in NUMBERS}
                ok = ok and all(r[k] <= limits[k] for k in NUMBERS)
        elif c.error is None:
            worst = dict.fromkeys(NUMBERS, math.inf)
        if not ok:
            failed += 1
            if len(errors) < 3:
                errors.append(c.error or f"call on item {c.item} failed "
                              "the output check")
    return {"failed": failed, "worst": worst, "errors": errors}


def lines(worst: dict, limits: dict, failed: int) -> dict:
    """Each number compared beside its limit, as the result line's last
    key carries them."""
    out = {k: {"value": worst[k], "limit": limits[k]} for k in NUMBERS}
    out["calls_failed"] = {"value": failed, "limit": 0}
    return out
