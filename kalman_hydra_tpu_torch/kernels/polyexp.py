"""K3 and K7a wrappers: Farneback polynomial expansion of one frame or of
a frame stack (csrc/polyexp.cu).

K3 replaces kalman_hydra_tpu/kernels/polyexp_pallas.py::
poly_expansion_planar: (H, W) f32 -> (5, H, W) planes [b_x, b_y, a_xx,
a_yy, axy] in f32 or bf16, replicate border, all arithmetic f32 with one
rounding at the store. K7a replaces ::poly_expansion_planar_batch:
(N, H, W) -> (N, 5, H, W), the same kernel with a frame index, so it
equals per-frame K3 bit for bit. `polyexp_route` picks the kernel's
route for an odd poly_n, and `polyexp_plan` is the tiled routes' tile
and shared-memory plan: 32 x 64 tiles with the taps compiled in, one
build for each odd poly_n up to 7 (COMPILED_N); any other odd poly_n up
to POLY_N_MAX takes the kernel's generic build, its taps in shared
memory (copied from device memory) and its tile's halo sized from n.
Past POLY_N_MAX, where the shared-memory plans stop fitting, the
device-memory route (kh_polyexp_mem): a vertical pass into a (N, W,
pitch, 4) f32 scratch (the three moment planes transposed and
interleaved; `mem_scratch_floats`) that each call allocates on the
image's device, then a horizontal pass, MEM_R outputs a thread, the taps
a (2n + 1, 4) table in device memory (`poly_taps4`); one call takes up
to MEM_MAX_LEVELS image stacks (K4/K7b's coarse levels,
`_launch_mem_levels`). Its launches count in `mem_route`, not in the
wrappers' own counters.

CPU tensors take the plain version (one function for both: it maps any
leading dims); CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ..ops.filters import pad1d

_DTYPES = (torch.float32, torch.bfloat16)


@lru_cache(maxsize=32)
def _poly_inv_gram(n: int, sigma: float):
    """Closed-form inverse-Gram coefficients of the basis
    {1, x, y, x^2, y^2, xy} under the separable Gaussian applicability
    (OpenCV FarnebackPrepareGaussian; ops/farneback.py in the reference).
    Returns (g, ig11, ig03, ig33, ig55) as float32."""
    i = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(i * i) / (2.0 * sigma * sigma))
    g /= g.sum()
    G = np.zeros((6, 6), dtype=np.float64)
    for yk, wy in zip(i, g):
        for xk, wx in zip(i, g):
            w = wx * wy
            G[0, 0] += w
            G[1, 1] += w * xk * xk
            G[2, 2] += w * yk * yk
            G[3, 3] += w * xk ** 4
            G[4, 4] += w * yk ** 4
            G[5, 5] += w * xk * xk * yk * yk
            G[0, 3] += w * xk * xk
            G[0, 4] += w * yk * yk
            G[3, 4] += w * xk * xk * yk * yk
    G[3, 0] = G[0, 3]
    G[4, 0] = G[0, 4]
    G[4, 3] = G[3, 4]
    invG = np.linalg.inv(G)
    return (g.astype(np.float32), np.float32(invG[1, 1]),
            np.float32(invG[0, 3]), np.float32(invG[3, 3]),
            np.float32(invG[5, 5]))


@lru_cache(maxsize=32)
def poly_taps(n: int, sigma: float) -> np.ndarray:
    """Kernel constants [g, xg, xxg (2n+1 each), ig11, ig03, ig33, ig55]."""
    g, ig11, ig03, ig33, ig55 = _poly_inv_gram(n, float(sigma))
    i = np.arange(-n, n + 1, dtype=np.float32)
    arr = np.concatenate([g, (i * g).astype(np.float32),
                          (i * i * g).astype(np.float32),
                          np.array([ig11, ig03, ig33, ig55], np.float32)])
    arr.setflags(write=False)
    return arr


def polyexp_valid_plain(src: torch.Tensor, n: int,
                        sigma: float) -> torch.Tensor:
    """Valid-mode expansion of images padded by n on each side:
    (..., h + 2n, w + 2n) -> (..., 5, h, w) f32, in the TPU kernel's tap
    order."""
    taps = poly_taps(n, float(sigma))
    t = 2 * n + 1
    g, xg, xxg = (taps[j * t:(j + 1) * t].tolist() for j in range(3))
    ig11, ig03, ig33, ig55 = taps[3 * t:].tolist()
    h, w = src.shape[-2] - 2 * n, src.shape[-1] - 2 * n
    src = src.to(torch.float32)
    v0 = v1 = v2 = None
    for k in range(t):
        row = src[..., k:k + h, :]
        v0 = g[k] * row if v0 is None else v0 + g[k] * row
        v1 = xg[k] * row if v1 is None else v1 + xg[k] * row
        v2 = xxg[k] * row if v2 is None else v2 + xxg[k] * row
    m00 = m10 = m20 = m01 = m11 = m02 = None
    for k in range(t):
        c0, c1, c2 = v0[..., k:k + w], v1[..., k:k + w], v2[..., k:k + w]
        terms = (g[k] * c0, xg[k] * c0, xxg[k] * c0, g[k] * c1,
                 xg[k] * c1, g[k] * c2)
        if m00 is None:
            m00, m10, m20, m01, m11, m02 = terms
        else:
            m00, m10, m20, m01, m11, m02 = (
                a + b for a, b in zip((m00, m10, m20, m01, m11, m02), terms))
    return torch.stack([m10 * ig11, m01 * ig11, m00 * ig03 + m20 * ig33,
                        m00 * ig03 + m02 * ig33, m11 * ig55], dim=-3)


def poly_expansion_planar_plain(img: torch.Tensor, poly_n: int,
                                poly_sigma: float,
                                out_dtype=torch.float32) -> torch.Tensor:
    """(..., H, W) -> (..., 5, H, W): K3's and K7a's plain version."""
    n = poly_n
    src = pad1d(pad1d(img.to(torch.float32), n, n, -2, "replicate"),
                n, n, -1, "replicate")
    return polyexp_valid_plain(src, n, poly_sigma).to(out_dtype)


SMEM_LIMIT = 232_448     # bytes of shared memory one H100 block may use
# csrc/polyexp.cu's builds with the taps compiled in (its kNMax = 7);
# any other odd n up to POLY_N_MAX takes its generic build. (K4/K7b's
# taps ride in the launch parameters up to polyexp.cuh::kPeNMax = 8 and
# come from device memory past it.)
COMPILED_N = (1, 3, 5, 7)


class PolyexpPlan(NamedTuple):
    th: int          # output rows of a tile
    tw: int          # output columns
    smem: int        # dynamic shared memory of one block, bytes


def _generic_smem(n: int) -> int:
    """The generic build's block (csrc/polyexp.cu::generic_smem): the
    (32 + 2n) x (64 + 2n) input tile, the three vertical-moment planes
    (32 rows at the odd stride (64 + 2n) | 1) and the 3 (2n + 1) taps."""
    return 4 * ((32 + 2 * n) * (64 + 2 * n) + 3 * 32 * ((64 + 2 * n) | 1)
                + 3 * (2 * n + 1))


def _poly_n_max() -> int:
    """The largest odd poly_n that runs on the card: K3/K7a's generic
    tile fits one block's shared memory, and so does K4/K7b's smallest
    level tile (16 rows, level_image.py::pe_in_w(n) floats a row) with
    its polyexp body, within half of it, so that the other half holds the
    level's tap tables (their size depends on the image)."""
    n = 9
    while True:
        m = n + 2
        in_w = 64 + 2 * m
        k4 = 4 * ((16 + 2 * m) * in_w + 3 * 16 * in_w + 3 * (2 * m + 1))
        if _generic_smem(m) > SMEM_LIMIT or k4 > SMEM_LIMIT // 2:
            return n
        n = m


POLY_N_MAX = _poly_n_max()   # 51: a larger n takes the device-memory route


def polyexp_route(n: int) -> str:
    """K3/K7a's route for an odd poly_n = n: "tiled" (the taps compiled
    in, n in COMPILED_N), "generic" (the taps in shared memory, up to
    POLY_N_MAX) or "mem" (past it: kh_polyexp_mem, its moment planes in
    device memory)."""
    if n < 1 or n % 2 == 0:
        raise ValueError(f"poly_n {n}: the kernel takes odd n >= 1")
    if n in COMPILED_N:
        return "tiled"
    return "generic" if n <= POLY_N_MAX else "mem"


MEM_R = 8              # csrc/polyexp.cu::kMemR: outputs a thread
MEM_MAX_LEVELS = 16    # csrc/polyexp.cu::kMemMaxLevels: levels a call


def mem_scratch_floats(frames: int, h: int, w: int) -> int:
    """The device-memory route's scratch for one (frames, h, w) stack:
    the three vertical-moment planes of every frame, f32, transposed and
    interleaved to (frames, w, pitch, 4), pitch = h rounded up to MEM_R."""
    return 4 * frames * w * (-(-h // MEM_R) * MEM_R)


def polyexp_plan(n: int, out_dtype=torch.float32) -> PolyexpPlan:
    """csrc/polyexp.cu's tiles and shared memory for an odd poly_n = n.
    With the taps compiled in (n in COMPILED_N): a 32 x 64 tile, the input
    tile ((32 + 2n) rows of 80 floats) or, after the vertical pass, the
    five output planes staged at a row stride of 72 (bf16) or 68 (f32)
    elements, whichever is larger, and the three vertical-moment planes
    (32 rows at the odd stride (64 + 2n) | 1). The generic build (any
    other odd n up to POLY_N_MAX): `_generic_smem`."""
    if n < 1 or n % 2 == 0 or n > POLY_N_MAX:
        raise ValueError(f"poly_n {n}: the kernel takes odd n up to "
                         f"{POLY_N_MAX}")
    th, tw = 32, 64
    if n not in COMPILED_N:
        return PolyexpPlan(th, tw, _generic_smem(n))
    ob = torch.empty((), dtype=out_dtype).element_size()
    stage = 5 * th * (tw + (8 if ob == 2 else 4)) * ob // 4
    smem = 4 * (max((th + 2 * n) * (tw + 16), stage)
                + 3 * th * ((tw + 2 * n) | 1))
    return PolyexpPlan(th, tw, smem)


_device_taps: dict = {}


def _on_device(device, table, n: int, sigma: float) -> torch.Tensor:
    """table(n, sigma) in device memory, cached per (table, device, n,
    sigma)."""
    key = (table.__name__, str(device), n, float(sigma))
    t = _device_taps.get(key)
    if t is None:
        t = torch.as_tensor(np.array(table(n, float(sigma))), device=device)
        _device_taps[key] = t
    return t


def poly_taps_on(device, n: int, sigma: float) -> torch.Tensor:
    """`poly_taps` in device memory: the generic builds of K3/K7a and
    K4/K7b read their taps from there."""
    return _on_device(device, poly_taps, n, sigma)


@lru_cache(maxsize=32)
def poly_taps4(n: int, sigma: float) -> np.ndarray:
    """The device-memory route's taps: (2n + 1, 4) f32 rows {g, xg, xxg,
    0}, one 16-byte load a tap (the values of `poly_taps`)."""
    t = 2 * n + 1
    taps = poly_taps(n, float(sigma))
    arr = np.zeros((t, 4), np.float32)
    arr[:, :3] = taps[:3 * t].reshape(3, t).T
    arr.setflags(write=False)
    return arr


def _launch(imgs: torch.Tensor, poly_n: int, poly_sigma: float,
            out_dtype) -> torch.Tensor:
    """kh_polyexp over a (N, H, W) f32 stack -> (N, 5, H, W), or
    kh_polyexp_mem past POLY_N_MAX."""
    if out_dtype not in _DTYPES:
        raise TypeError(f"polyexp: out_dtype {out_dtype}")
    if polyexp_route(poly_n) == "mem":
        return _launch_mem_levels([imgs], poly_n, poly_sigma,
                                  out_dtype)[0][0]
    N, h, w = imgs.shape
    plan = polyexp_plan(poly_n, out_dtype)
    out = torch.empty((N, 5, h, w), dtype=out_dtype, device=imgs.device)
    taps = poly_taps(poly_n, float(poly_sigma))
    taps_dev = (None if poly_n in COMPILED_N else
                poly_taps_on(imgs.device, poly_n, poly_sigma).data_ptr())
    P, I = _build.P, _build.I
    fn = _build.function("kh_polyexp", P, I, I, I, P, P, I, I, I, P, P)
    rc = fn(imgs.data_ptr(), N, h, w, taps.ctypes.data, taps_dev, poly_n,
            int(out_dtype == torch.bfloat16), plan.smem, out.data_ptr(),
            _build.stream(imgs))
    _build.check(rc, "kh_polyexp")
    return out


def _launch_mem_levels(stacks, poly_n: int, poly_sigma: float, out_dtype):
    """kh_polyexp_mem over (N, h, w) f32 stacks of one device -> (list of
    (N, 5, h, w), launches made): one call for every MEM_MAX_LEVELS
    stacks, each call's scratch allocated here."""
    dev = stacks[0].device
    taps = poly_taps(poly_n, float(poly_sigma))
    taps4 = _on_device(dev, poly_taps4, poly_n, poly_sigma)
    P, I, L = _build.P, _build.I, _build.L
    fn = _build.function("kh_polyexp_mem", I, I, P, P, P, P, I, I, P, L, P)
    outs = [torch.empty((s.shape[0], 5, *s.shape[1:]), dtype=out_dtype,
                        device=dev) for s in stacks]
    runs = range(0, len(stacks), MEM_MAX_LEVELS)
    for r0 in runs:
        run = stacks[r0:r0 + MEM_MAX_LEVELS]
        N = run[0].shape[0]
        ptrs = np.array([[s.data_ptr(), o.data_ptr()] for s, o
                         in zip(run, outs[r0:r0 + MEM_MAX_LEVELS])],
                        dtype=np.uint64)
        dims = np.array([s.shape[1:] for s in run], dtype=np.int32)
        scratch = torch.empty(sum(mem_scratch_floats(N, *s.shape[1:])
                                  for s in run), dtype=torch.float32,
                              device=dev)
        rc = fn(N, len(run), ptrs.ctypes.data, dims.ctypes.data,
                taps.ctypes.data, taps4.data_ptr(), poly_n,
                int(out_dtype == torch.bfloat16), scratch.data_ptr(),
                scratch.numel(), _build.stream(run[0]))
        _build.check(rc, "kh_polyexp_mem")
    return outs, len(runs)


# launches of K3/K7a's (and K4/K7b's) device-memory route, past POLY_N_MAX
mem_route = SimpleNamespace(launches=0)


def _counted(wrapper, imgs, poly_n, *args):
    """_launch, counted in the wrapper's own counter, or in `mem_route`
    on the device-memory route."""
    out = _launch(imgs, poly_n, *args)
    (mem_route if polyexp_route(poly_n) == "mem" else wrapper).launches += 1
    return out


def poly_expansion_planar(img: torch.Tensor, poly_n: int, poly_sigma: float,
                          out_dtype=torch.float32) -> torch.Tensor:
    """(H, W) f32 -> (5, H, W) coefficient planes in out_dtype."""
    if img.device.type == "cpu":
        return poly_expansion_planar_plain(img, poly_n, poly_sigma,
                                           out_dtype)
    _build.require(img, "img", (torch.float32,), 2)
    return _counted(poly_expansion_planar, img[None], poly_n, poly_sigma,
                    out_dtype)[0]


poly_expansion_planar.launches = 0


def poly_expansion_planar_batch(imgs: torch.Tensor, poly_n: int,
                                poly_sigma: float,
                                out_dtype=torch.float32) -> torch.Tensor:
    """(N, H, W) f32 frames -> (N, 5, H, W) planes in one launch."""
    if imgs.device.type == "cpu":
        return poly_expansion_planar_plain(imgs, poly_n, poly_sigma,
                                           out_dtype)
    _build.require(imgs, "imgs", (torch.float32,), 3)
    return _counted(poly_expansion_planar_batch, imgs, poly_n, poly_sigma,
                    out_dtype)


poly_expansion_planar_batch.launches = 0
