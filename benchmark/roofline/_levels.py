"""Farneback's level plan (cv2.calcOpticalFlowFarneback's: levels while
both sides stay >= 32 px, sizes cvRound(side * scale^k)), coarsest
first: [(k, lh, lw, ksize)] with ksize the level blur's taps."""

import numpy as np


def plan(h: int, w: int, levels: int, pyr_scale: float):
    k, scale = 0, 1.0
    while k < levels:
        scale *= pyr_scale
        if w * scale < 32 or h * scale < 32:
            break
        k += 1
    out = []
    for kk in range(k, -1, -1):
        s = pyr_scale ** kk
        sigma = (1.0 / s - 1.0) * 0.5
        ksize = max(int(np.rint(sigma * 5)) | 1, 3)
        out.append((kk, int(np.rint(h * s)), int(np.rint(w * s)), ksize))
    return out


def plane_bytes(flow_cfg: dict) -> int:
    return 2 if flow_cfg["bf16_poly"] else 4
