"""Seeded moving-blob footage made on the device: a torch copy of the
port's `io/synthetic.py::moving_blob_clip` (band-limited textured
background, a bright, internally textured blob moving rigidly at a set
velocity), rendered frame by frame on the card and moved to host memory
as a decoder would leave it.

Every clip of a pool has the same size, velocity and blob; only the
textures differ, drawn from the run's seed and the clip's index, so
every seed gives the same amount of work.
"""

from __future__ import annotations

import numpy as np
import torch

_BINOMIAL = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def sub_seed(seed: int, index: int) -> int:
    """A generator seed for item `index` of a run seeded with `seed`
    (any int up to 2**63)."""
    return (int(seed) * 1_000_003 + 7919 * int(index)) % (2 ** 63 - 1)


def _reflect_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """scipy's "reflect" border (d c b a | a b c d | d c b a)."""
    n = x.shape[dim]
    i = torch.arange(-r, n + r, device=x.device)
    i = torch.where(i < 0, -i - 1, i)
    i = torch.where(i >= n, 2 * n - 1 - i, i)
    return x.index_select(dim, i)


def _smooth(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    xp = _reflect_pad(x, 2, dim)
    return sum(w * xp.narrow(dim, k, n) for k, w in enumerate(_BINOMIAL))


def textured(gen: torch.Generator, h: int, w: int, device) -> torch.Tensor:
    """(h, w) float32 texture in [0.25, 0.6]: three passes of a separable
    5-tap binomial over white noise."""
    x = torch.randn((h, w), generator=gen, device=device, dtype=torch.float32)
    for _ in range(3):
        x = _smooth(_smooth(x, 0), 1)
    x = x - x.min()
    x = x / torch.clamp(x.max(), min=1e-6)
    return 0.25 + 0.35 * x


class Scene:
    """One clip's background and blob texture; `frame(t)` renders frame t
    with the blob centre at c0 + velocity t, c0 = (0.35 w, 0.6 h)."""

    def __init__(self, seed: int, h: int, w: int, velocity, sigma: float,
                 device):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        self.h, self.w, self.sigma = h, w, float(sigma)
        self.bg = textured(gen, h, w, device)
        self.tex = textured(gen, h, w, device)
        self.c0 = torch.tensor([w * 0.35, h * 0.6], dtype=torch.float32)
        self.v = torch.tensor(velocity, dtype=torch.float32)
        self.yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
        self.xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]

    def centre(self, t: float) -> np.ndarray:
        return (self.c0 + self.v * t).numpy()

    def frame(self, t: float) -> torch.Tensor:
        """(h, w, 3) uint8 (gray in all three channels) on the device."""
        h, w, s = self.h, self.w, self.sigma
        cx, cy = (float(a) for a in self.c0 + self.v * t)
        sx, sy = (float(a) for a in self.v * t)
        d = torch.sqrt((self.xx - cx) ** 2 + (self.yy - cy) ** 2)
        z = torch.clamp((d - 1.5 * s) / (0.25 * s), -60.0, 60.0)
        mask = 1.0 / (1.0 + torch.exp(z))
        xs = torch.clamp(self.xx - sx, 0, w - 1).expand(h, w)
        ys = torch.clamp(self.yy - sy, 0, h - 1).expand(h, w)
        x0, y0 = torch.floor(xs), torch.floor(ys)
        fx, fy = xs - x0, ys - y0
        x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
        x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
        tx = self.tex
        tex = (tx[y0, x0] * (1 - fx) * (1 - fy) + tx[y0, x1] * fx * (1 - fy)
               + tx[y1, x0] * (1 - fx) * fy + tx[y1, x1] * fx * fy)
        img = self.bg * (1 - mask) + (0.55 + 0.45 * tex) * mask
        u8 = torch.clamp(img * 255.0, 0, 255).to(torch.uint8)
        return u8[..., None].expand(h, w, 3)


def clip_pool(seed: int, n_clips: int, clip_len: int, h: int, w: int,
              velocity, sigma: float, device) -> np.ndarray:
    """(n_clips, clip_len, h, w, 3) uint8 host array of distinct clips."""
    out = np.empty((n_clips, clip_len, h, w, 3), np.uint8)
    for c in range(n_clips):
        scene = Scene(sub_seed(seed, c), h, w, velocity, sigma, device)
        for t in range(clip_len):
            out[c, t] = scene.frame(t).cpu().numpy()
    return out


def ping_pong(n: int):
    """Frame indices 0, 1, ..., n - 1, n - 2, ..., 1, 0, 1, ... without
    end: every consecutive pair is a real motion pair."""
    i, step = 0, 1
    while True:
        yield i
        if not 0 <= i + step < n:
            step = -step
        i += step
