#!/usr/bin/env python3
"""The render channel's reach at 1080p, on the CPU, in both packages:
the JAX reference's api.track_mesh and the port's (device="cpu") on
deforming_body_clip at 1080x1920, T=9, V=256 (bench --render's clip and
mesh size), each with its default config.

    JAX_PLATFORMS=cpu python3 tools/torch_render_reach.py [--stretch S]

For each deformation (the clip's default stretch (0.12, -0.08), and
chip_smoke.py's STRETCH_R, the default scaled by 480/1080) it prints,
for each package, the median vertex error against the clip's affine
truth at every frame, and between the two packages: whether the mesh is
identical, the largest position gap and whether alive and track_id are
identical. It ends with each run's wall time and the process's peak
resident memory. A CPU tool: it is the only place where the reference
runs at this size, as a witness for chip_smoke.py's paths R and R-bench;
it runs nothing on a card.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

H, W, T, V = 1080, 1920, 9, 256
OMEGA, VELOCITY = 0.35, (0.6, 0.3)          # deforming_body_clip's defaults
STRETCHES = {"default": (0.12, -0.08),
             "scaled": (0.12 * 480 / 1080, -0.08 * 480 / 1080)}


def truth(vertices: np.ndarray, stretch) -> np.ndarray:
    """(T, V, 2) positions under the clip's forward map x(q, t) = c0 +
    v t + A(t) (q - c0), A(t) = diag(1 + sx sin(w t), 1 + sy sin(w t))."""
    sx, sy = stretch
    v = np.float32(VELOCITY)
    c0 = np.float32([W * 0.5, H * 0.5])
    out = np.empty((T, len(vertices), 2), np.float32)
    for t in range(T):
        a = np.float32([1 + sx * np.sin(OMEGA * t),
                        1 + sy * np.sin(OMEGA * t)])
        out[t] = c0 + v * t + (vertices - c0) * a[None, :]
    return out


def median_errors(positions, tr) -> list:
    err = np.median(np.linalg.norm(positions - tr, axis=-1), axis=1)
    return [round(float(e), 4) for e in err]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stretch", choices=sorted(STRETCHES), nargs="+",
                    default=["default", "scaled"])
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from kalman_hydra_tpu import api as japi
    from kalman_hydra_tpu.io.synthetic import deforming_body_clip
    from kalman_hydra_tpu_torch import api as tapi
    for name in args.stretch:
        stretch = STRETCHES[name]
        frames, _, _ = deforming_body_clip(
            num_frames=T, height=H, width=W, stretch=stretch, omega=OMEGA,
            velocity=VELOCITY, seed=0)
        t0 = time.perf_counter()
        jm, jt = japi.track_mesh(frames, n_vertices=V)
        j_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tm, tt = tapi.track_mesh(frames, n_vertices=V, device="cpu")
        t_s = time.perf_counter() - t0
        jpos = np.asarray(jt.positions)
        tr = truth(np.asarray(jm.vertices), stretch)
        same_mesh = (np.array_equal(jm.vertices, tm.vertices)
                     and np.array_equal(jm.triangles, tm.triangles))
        print(f"[{name} stretch {stretch}] {H}x{W} T={T} V={V}")
        print(f"  mesh identical: {same_mesh}")
        print(f"  median vertex error a frame, reference: "
              f"{median_errors(jpos, tr)} px")
        print(f"  median vertex error a frame, port:      "
              f"{median_errors(tt.positions, tr)} px")
        print(f"  port vs reference: max |pos diff| "
              f"{np.abs(tt.positions - jpos).max():.3e} px; alive identical "
              f"{np.array_equal(tt.alive, np.asarray(jt.alive))}; track_id "
              f"identical {np.array_equal(tt.track_id, np.asarray(jt.track_id))}"
              f"; live at the end: reference "
              f"{int(np.asarray(jt.alive)[-1].sum())}, port "
              f"{int(tt.alive[-1].sum())} of {V}")
        print(f"  wall: reference {j_s:.1f} s (its compile included), "
              f"port {t_s:.1f} s")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"peak resident memory {peak:.2f} GiB (CPU only)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
