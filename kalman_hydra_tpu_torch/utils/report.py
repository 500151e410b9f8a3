"""Structured run reports (a copy of `kalman_hydra_tpu/utils/report.py`).

Summarizes a tracking run into one JSON-serializable dict: throughput
and filter health (NIS histogram, live-track fraction over time, re-seed
counts).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..io.export import Trajectories


def run_report(tracks: Trajectories, wall_seconds: Optional[float] = None,
               nis_bins=(0.5, 1, 2, 4, 9.21, 50),
               gate_chi2: float = 9.21) -> dict:
    T, K = tracks.alive.shape
    live_frac = tracks.alive.mean(axis=1)
    rep = {
        "frames": int(T),
        "track_slots": int(K),
        "live_fraction_mean": float(tracks.alive.mean()),
        "live_fraction_first": float(live_frac[0]),
        "live_fraction_last": float(live_frac[-1]),
        "live_fraction_min": float(live_frac.min()),
    }
    if wall_seconds is not None and wall_seconds > 0:
        rep["fps"] = float((T - 1) / wall_seconds)
    if tracks.nis is not None:
        nis = tracks.nis[tracks.alive & (tracks.nis > 0)]
        if nis.size:
            hist, _ = np.histogram(nis, bins=[0] + list(nis_bins)
                                   + [np.inf])
            rep["nis_mean"] = float(nis.mean())
            rep["nis_p95"] = float(np.percentile(nis, 95))
            # hist[i] counts [edges[i], edges[i+1]): the label "<b" goes
            # with the bin that ends at b
            rep["nis_hist"] = {f"<{e}": int(c) for e, c in
                               zip(list(nis_bins) + ["inf"], hist)}
            # the fraction above the configured chi^2 gate
            # (EkfConfig.gate_chi2); the bins are for display only
            rep["nis_gated_fraction"] = float((nis > gate_chi2).mean())
    if tracks.track_id is not None:
        rep["reseeds_total"] = int(tracks.track_id[-1].sum())
    return rep


def write_report(tracks: Trajectories, path: str,
                 wall_seconds: Optional[float] = None, **extra) -> dict:
    rep = run_report(tracks, wall_seconds)
    rep.update(extra)
    with open(path, "w") as f:
        json.dump(rep, f, indent=2, sort_keys=True)
    return rep
