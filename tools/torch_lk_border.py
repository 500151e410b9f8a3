#!/usr/bin/env python3
"""Dense LK against cv2's per-point pyramidal LK, by distance to the
border, on the CPU, in both packages: the JAX reference's ops.lk.lk_dense
and the port's api.flow(method="lk_dense", device="cpu") on
translating_pair (shift (6, 3), seed 3), each against
kalman_hydra_tpu_torch.ref.imgproc.lk_dense at stride 4, FlowConfig(
method="lk_dense")'s defaults (5 levels, window 21).

    JAX_PLATFORMS=cpu python3 tools/torch_lk_border.py [--height H --width W]

It prints, for each package, the mean |diff| to cv2 over every grid
point and over bands of distance to the border, the gap between the two
packages, and the band the coarsest level's window reaches at level 0
(chip_smoke.py's OC-LK holds the dense bar outside it). A CPU tool, the
witness that the gap in that band is the dense formulation's (the
reference's as much as the port's); it runs nothing on a card.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BANDS = ((0, 8), (8, 16), (16, 32), (32, 64), (64, 160), (160, None))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    args = ap.parse_args()
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=1")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from kalman_hydra_tpu.config import FlowConfig as JFlowConfig
    from kalman_hydra_tpu.ops import lk as jlk
    from kalman_hydra_tpu_torch import api, ref
    from kalman_hydra_tpu_torch.config import FlowConfig
    from kalman_hydra_tpu_torch.io.synthetic import translating_pair

    h, w = args.height, args.width
    a, b, _ = translating_pair(height=h, width=w, shift=(6.0, 3.0), seed=3)
    a8, b8 = (np.round(x).astype(np.uint8) for x in (a, b))
    fd = FlowConfig(method="lk_dense")
    want = ref.imgproc.lk_dense(a8, b8, fd, stride=4)
    jfd = JFlowConfig(method="lk_dense")
    flows = {
        "reference": np.asarray(jax.jit(lambda x, y: jlk.lk_dense(
            x, y, jfd))(jnp.asarray(a8, jnp.float32),
                        jnp.asarray(b8, jnp.float32)))[::4, ::4],
        "port": api.flow(a8, b8, fd, device="cpu")[::4, ::4]}
    ys, xs = np.mgrid[0:h:4, 0:w:4]
    edge = np.minimum(np.minimum(ys, h - 1 - ys), np.minimum(xs, w - 1 - xs))
    margin = (fd.lk_winsize // 2) << (fd.levels - 1)
    print(f"{h}x{w}, shift (6, 3), {fd.levels} levels, window "
          f"{fd.lk_winsize}; the coarsest window reaches {margin} px")
    for name, f in flows.items():
        d = np.abs(f - want)
        bands = ", ".join(
            f"[{lo}, {hi or 'inf'}) {d[(edge >= lo) & (edge < (hi or 1 << 30))].mean():.5f}"
            for lo, hi in BANDS)
        print(f"{name} vs cv2: mean |diff| {d.mean():.5f} px over all "
              f"{d.shape[0] * d.shape[1]} points; by distance to the "
              f"border: {bands}")
    gap = np.abs(flows["port"] - flows["reference"]).max()
    print(f"port vs reference: max |diff| {gap:.3e} px")
    return 0


if __name__ == "__main__":
    sys.exit(main())
