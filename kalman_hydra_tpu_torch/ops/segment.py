"""Body segmentation: Otsu threshold and morphological clean-up (port of
kalman_hydra_tpu/ops/segment.py).

cv2.threshold(..., THRESH_OTSU) parity (a 256-bin histogram over
[0, 256), the first maximum of the between-class variance), a close and
an open by min/max pooling, then the region grown from the strongest
foreground seed by `grow_iters` geodesic dilations. It restricts track
seeding to the animal's body (TrackConfig.seed_in_body). Plain torch: the
reference has no Pallas kernel here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tf

from .filters import box_filter


def otsu_threshold(gray: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold of an (H, W) image with values in [0, 255], as a
    0-d f32 tensor; pixels > t are foreground. The histogram's bins are
    jnp.histogram's over range (0, 256): bin floor(v), 256 itself in the
    last bin, values outside the range dropped. The class counts and
    intensity sums are cumulated in int64, exactly, then rounded to f32
    once: below 2^24 that is the reference's f32 cumsum, and above it
    (a 1080p frame's intensity sum) the same threshold on every device,
    where an f32 cumsum rounds by its scan order."""
    inside = (gray >= 0) & (gray <= 256)
    idx = torch.clamp(torch.floor(gray), 0, 255).to(torch.int64)
    idx = torch.where(inside, idx, torch.full_like(idx, 256))
    hist = torch.bincount(idx.reshape(-1), minlength=257)[:256]
    bins = torch.arange(256, dtype=torch.int64, device=gray.device)
    w0_i = torch.cumsum(hist, 0)
    sum0_i = torch.cumsum(hist * bins, 0)
    w0 = w0_i.to(torch.float32)
    sum0 = sum0_i.to(torch.float32)
    w1 = w0_i[-1].to(torch.float32) - w0
    mu0 = sum0 / torch.clamp(w0, min=1.0)
    mu1 = (sum0[-1] - sum0) / torch.clamp(w1, min=1.0)
    between = w0 * w1 * (mu0 - mu1) ** 2
    between = torch.where((w0 > 0) & (w1 > 0), between,
                          torch.full_like(between, -1.0))
    return torch.argmax(between).to(torch.float32)   # the first maximum


def _pool(mask: torch.Tensor, size: int, op: str) -> torch.Tensor:
    """size x size max ("max", a dilation) or min ("min", an erosion)
    pooling; the border pads with the operation's identity (-inf / +inf),
    as lax.reduce_window does."""
    if size % 2 == 0:
        raise ValueError(f"morphology window must be odd, got {size}")
    x = mask[None, None] if op == "max" else -mask[None, None]
    out = tf.max_pool2d(x, size, stride=1, padding=size // 2)[0, 0]
    return out if op == "max" else -out


def morph_open(mask, size: int = 5):
    return _pool(_pool(mask, size, "min"), size, "max")


def morph_close(mask, size: int = 5):
    return _pool(_pool(mask, size, "max"), size, "min")


def segment_body(gray: torch.Tensor, morph_size: int = 5,
                 grow_iters: int = 64, invert: bool = False) -> torch.Tensor:
    """(H, W) f32 [0, 255] -> f32 {0, 1} mask: Otsu threshold, close,
    open, then the region grown from the seed at the first maximum of the
    15 x 15 box-blurred mask (within the mask) by `grow_iters` 3 x 3
    dilations clipped to the foreground."""
    t = otsu_threshold(gray)
    fg = ((gray < t) if invert else (gray > t)).to(torch.float32)
    fg = morph_open(morph_close(fg, morph_size), morph_size)
    score = box_filter(box_filter(fg, 15, dim=0), 15, dim=1) * fg
    seed = torch.zeros(fg.numel(), dtype=torch.float32, device=fg.device)
    seed[torch.argmax(score)] = 1.0
    region = seed.reshape(fg.shape)
    for _ in range(grow_iters):
        region = torch.minimum(_pool(region, 3, "max"), fg)
    return region


def mask_scores(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero a corner-response map outside the segmentation mask."""
    return torch.where(mask > 0, score, torch.zeros_like(score))
