"""Spatial frame sharding: dense flow with row-band partitioning and halo
exchange (port of kalman_hydra_tpu/parallel/spatial.py).

A frame's rows are split over the mesh's shards; every windowed op needs
only a fixed band of neighbour rows, so each stage extends each shard's
block by `halo_exchange` (the reference's `lax.ppermute`: a copy from
the neighbouring shard, a peer copy between two cards) instead of
gathering the whole frame. One process drives every shard, each under
its own device (`mesh.on_device`).

`lk_dense_sharded`: dense pyramidal LK, all plain torch as the
reference's is XLA (pyrDown, Scharr gradients, window sums and the warp
are local given halos; the warp's vertical displacement is clamped to the
halo, 8 px a level by default).

`farneback_sharded`: cv2's level sizes stop dividing by the mesh below
level 0, so each distinct device computes the coarse levels once for its
shards on the whole frame (K4 or K11 and K3, then K5/K13/K2 by config),
and the finest level runs on row bands: each shard's polyexp slab through
K3, then `iterations` K2 launches in band mode (kernels/flow_iter.py::
flow_iter with row0), each followed by a flow halo exchange. On the CPU the
kernels' plain versions run, as everywhere in the port.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import pipeline as _pipeline
from ..config import FlowConfig, RunConfig
from ..kernels.flow_iter import flow_iter
from ..kernels.polyexp import poly_expansion_planar
from ..kernels.scharr import SCHARR_EDGE, SCHARR_SMOOTH
from ..ops.farneback import farneback_from_pyramids, polyexp_pyramid
from ..ops.filters import correlate1d, pad1d
from ..ops.pyramid import gaussian_blur_level, resize_linear
from .mesh import Mesh, make_mesh, on_device

_PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0
_BORDERS = {"edge": "replicate", "reflect": "reflect101"}


def halo_exchange(blocks: List[torch.Tensor], halo: int,
                  pad_mode: str = "edge", dim: int = 0) -> List[torch.Tensor]:
    """Extend each shard's row block by `halo` rows from its neighbours.

    blocks: one tensor a shard, in mesh order, rows along `dim`. Each
    result sits on its block's device. The first and last shards build
    their missing halo with `pad_mode` ('edge' = replicate, 'reflect' =
    REFLECT_101), so the global border is the unsharded op's."""
    border = _BORDERS[pad_mode]
    n = len(blocks)
    out = []
    for i, x in enumerate(blocks):
        d = dim % x.ndim
        pad = pad1d(x, halo, halo, d, border) if i in (0, n - 1) else None
        top = (pad.narrow(d, 0, halo) if i == 0
               else blocks[i - 1].narrow(d, blocks[i - 1].shape[d] - halo,
                                         halo).to(x.device))
        bot = (pad.narrow(d, pad.shape[d] - halo, halo) if i == n - 1
               else blocks[i + 1].narrow(d, 0, halo).to(x.device))
        out.append(torch.cat([top, x, bot], dim=d))
    return out


def _shard_rows(a: np.ndarray, mesh: Mesh) -> List[torch.Tensor]:
    """A host (H, W) frame's row blocks, each uploaded to its shard."""
    hb = a.shape[0] // mesh.size
    return [_pipeline.upload(a[i * hb:(i + 1) * hb], d)
            for i, d in enumerate(mesh.devices)]


def _pyr_down_local(blocks):
    """Sharded cv2.pyrDown: a 2-row halo exchange, then a local blur and
    decimation (each block's height even, so decimation stays globally
    aligned)."""
    out = []
    for block, ext in zip(blocks, halo_exchange(blocks, 2, "reflect")):
        with on_device(block.device):
            v = None
            for k, wk in enumerate(_PYR_K):
                t = float(wk) * ext[k:k + block.shape[0]]
                v = t if v is None else v + t
            h = correlate1d(v[::2], _PYR_K, dim=-1, border="reflect101")
            out.append(h[:, ::2])
    return out


def _scharr_local(blocks):
    """Scharr/32 gradients of each block: a 1-row halo, the reference's
    sums in its order."""
    out = []
    for block, ext in zip(blocks, halo_exchange(blocks, 1, "edge")):
        hb = block.shape[0]
        with on_device(block.device):
            gx_full = correlate1d(ext, SCHARR_EDGE, dim=-1,
                                  border="replicate")
            gx = None
            for k, wk in enumerate(SCHARR_SMOOTH):
                t = float(wk) * gx_full[k:k + hb]
                gx = t if gx is None else gx + t
            gy_s = correlate1d(ext, SCHARR_SMOOTH, dim=-1,
                               border="replicate")
            # vertical edge kernel [-1, 0, 1]: (row + 1) - (row - 1)
            out.append((gx, gy_s[2:2 + hb] - gy_s[0:hb]))
    return out


def _wsum_local(blocks, w: int):
    """winsize box sums of each block, tap after tap, the vertical pass
    over a w // 2 halo."""
    r = w // 2
    out = []
    for v, ext in zip(blocks, halo_exchange(blocks, r, "edge")):
        with on_device(v.device):
            acc = None
            for k in range(w):
                t = ext[k:k + v.shape[0]]
                acc = t if acc is None else acc + t
            hp = pad1d(acc, r, r, 1, "replicate")
            s = None
            for k in range(w):
                t = hp[:, k:k + v.shape[1]]
                s = t if s is None else s + t
            out.append(s)
    return out


def _warp_local(img_blocks, flows, halo: int):
    """Backward bilinear warp of each block by its (hb, wb, 2) flow, the
    vertical displacement clamped to +-halo rows."""
    out = []
    for img, flow, ext in zip(img_blocks, flows,
                              halo_exchange(img_blocks, halo, "edge")):
        hb, wb = img.shape
        with on_device(img.device):
            ys = torch.arange(hb, dtype=torch.float32,
                              device=img.device)[:, None] + halo
            xs = torch.arange(wb, dtype=torch.float32,
                              device=img.device)[None, :]
            fy = torch.clamp(flow[..., 1], -halo, halo) + ys
            fx = torch.clamp(xs + flow[..., 0], 0.0, wb - 1.0)
            fy = torch.clamp(fy, 0.0, hb + 2 * halo - 1.0)
            x0 = torch.clamp(torch.floor(fx), 0, wb - 2).to(torch.int64)
            y0 = torch.clamp(torch.floor(fy), 0,
                             hb + 2 * halo - 2).to(torch.int64)
            ax = fx - x0
            ay = fy - y0
            i00, i01 = ext[y0, x0], ext[y0, x0 + 1]
            i10, i11 = ext[y0 + 1, x0], ext[y0 + 1, x0 + 1]
            out.append(i00 * (1 - ax) * (1 - ay) + i01 * ax * (1 - ay)
                       + i10 * (1 - ax) * ay + i11 * ax * ay)
    return out


def _each(fn, *lists):
    """fn over the shards' items, each under its shard's device (that of
    its first item, a tensor)."""
    out = []
    for items in zip(*lists):
        with on_device(items[0].device):
            out.append(fn(*items))
    return out


def _upsample(ext, x):
    """Seam-free x2 flow upsample of a block extended by a 1-row halo, so
    that its edge rows interpolate across the split as the global op
    does."""
    hp = ext.shape[0] - 2
    up = resize_linear(ext.movedim(-1, 0), 2 * (hp + 2),
                       x.shape[1]).movedim(0, -1)
    return up[2:2 + 2 * hp] * 2.0


def _lk_dense_blocks(a_blocks, b_blocks, cfg: FlowConfig, warp_halo: int):
    """Dense LK on the shards' row bands (the reference's per-device
    body under shard_map): halo exchanges between shards, the rest local
    to each."""
    w = cfg.lk_winsize
    pyr_a, pyr_b = [a_blocks], [b_blocks]
    for _ in range(cfg.levels - 1):
        pyr_a.append(_pyr_down_local(pyr_a[-1]))
        pyr_b.append(_pyr_down_local(pyr_b[-1]))

    def gate(g11, g12, g22):
        det = g11 * g22 - g12 * g12
        min_eig = ((g11 + g22) - torch.sqrt((g11 - g22) ** 2
                                            + 4.0 * g12 ** 2)) \
            * 0.5 / (w * w)
        ok = (min_eig > cfg.lk_min_eig) & (det > 1e-12)
        return ok, torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)

    def rhs(warped, a, fl, g, gxx, gxy, gyy):
        diff = warped - a
        ux, uy = fl[..., 0], fl[..., 1]
        return (gxx * ux + gxy * uy - diff * g[0],
                gxy * ux + gyy * uy - diff * g[1])

    def solve(g11, g12, g22, h1, h2, inv_det, ok, fl):
        new = torch.stack([(g22 * h1 - g12 * h2) * inv_det,
                           (g11 * h2 - g12 * h1) * inv_det], dim=-1)
        return torch.where(ok[..., None], new, fl)

    flow = None
    for lvl in range(cfg.levels - 1, -1, -1):
        ia, ib = pyr_a[lvl], pyr_b[lvl]
        if flow is None:
            flow = [torch.zeros(x.shape + (2,), dtype=torch.float32,
                                device=x.device) for x in ia]
        else:
            flow = _each(_upsample, halo_exchange(flow, 1, "edge"), ia)
        grads = _scharr_local(ia)
        gxx, gxy, gyy = map(list, zip(*_each(
            lambda a, g: (g[0] * g[0], g[0] * g[1], g[1] * g[1]), ia,
            grads)))
        g11, g12, g22 = (_wsum_local(t, w) for t in (gxx, gxy, gyy))
        ok, inv_det = zip(*_each(gate, g11, g12, g22))
        for _ in range(cfg.lk_max_iter):
            warped = _warp_local(ib, flow, warp_halo)
            t1, t2 = map(list, zip(*_each(rhs, warped, ia, flow, grads, gxx,
                                          gxy, gyy)))
            flow = _each(solve, g11, g12, g22, _wsum_local(t1, w),
                         _wsum_local(t2, w), inv_det, ok, flow)
    return flow


def lk_dense_sharded(prev: np.ndarray, nxt: np.ndarray, cfg: FlowConfig,
                     mesh: Optional[Mesh] = None, axis: str = "space",
                     warp_halo: int = 8, *, device="cuda") -> np.ndarray:
    """Dense pyramidal LK with the (H, W) frame's rows split over the
    mesh (`make_mesh(axis=axis, device=device)` by default). H must be
    divisible by n_devices * 2^(levels-1). Returns (H, W, 2)."""
    if mesh is None:
        mesh = make_mesh(None, axis, device=device)
    n = mesh.size
    h = prev.shape[0]
    div = n * 2 ** (cfg.levels - 1)
    if h % div != 0:
        raise ValueError(f"H={h} must be divisible by {div} "
                         f"(devices * 2^(levels-1))")
    # single-hop halo exchange: every level's local block must hold the
    # widest halo (window radius / warp clamp)
    coarsest_local = h // div
    max_halo = max(cfg.lk_winsize // 2, warp_halo, 2)
    if coarsest_local < max_halo:
        raise ValueError(
            f"coarsest local rows {coarsest_local} < max halo {max_halo}; "
            f"reduce devices/levels or winsize (single-hop halo exchange)")
    a = _shard_rows(np.asarray(prev, np.float32), mesh)
    b = _shard_rows(np.asarray(nxt, np.float32), mesh)
    flow = _lk_dense_blocks(a, b, cfg, warp_halo)
    return np.concatenate([f.cpu().numpy() for f in flow])


def farneback_sharded(prev: np.ndarray, nxt: np.ndarray, cfg: FlowConfig,
                      mesh: Optional[Mesh] = None, axis: str = "space",
                      impl: str = "xla", interpret: bool = False, *,
                      device="cuda") -> np.ndarray:
    """Farneback with the FINEST level's rows split over the mesh
    (`make_mesh(axis=axis, device=device)` by default); (H, W) gray
    frames -> (H, W, 2).

    Each distinct device runs the coarse levels once, on the whole
    frame, for its shards (replicas are identical by construction; the
    level-0 planes of the whole frame are never made). Shard i owns rows
    row0 = i * H / n ... + H / n: its polyexp slab of H / n + 2 EPAD
    rows of the blurred, edge-padded frame through K3, cropped by poly_n
    rows to H / n + 2 RPAD, then `iterations` K2 launches in band mode
    (row0 - RPAD, H), each followed by a RPAD-row flow halo exchange;
    RPAD = winsize // 2 + fast_warp + 1 (window, warp reach, bilinear),
    EPAD = RPAD + poly_n.

    Requires fast_warp > 0 (the warp's clamp bounds the halo), H % n ==
    0 and H / n >= RPAD. `impl` and `interpret` are the reference's and
    are ignored: the route goes by device (kernels on the card, their
    plain versions on the CPU)."""
    del impl, interpret
    _pipeline.check_slice(RunConfig(flow=cfg), flow_only=True)
    if cfg.fast_warp <= 0:
        raise ValueError("farneback_sharded requires fast_warp > 0 "
                         "(bounded-halo warp)")
    if mesh is None:
        mesh = make_mesh(None, axis, device=device)
    n = mesh.size
    hg, wg = prev.shape[-2], prev.shape[-1]
    if hg % n != 0:
        raise ValueError(f"H={hg} must divide by {n} devices")
    hb = hg // n
    D = cfg.fast_warp
    RPAD = cfg.winsize // 2 + D + 1         # window + warp reach + bilinear
    EPAD = RPAD + cfg.poly_n                # + the polyexp window
    if hb < RPAD:
        raise ValueError(f"band rows {hb} < halo {RPAD}; fewer devices")
    dt = torch.bfloat16 if cfg.bf16_poly else torch.float32

    # per distinct device: the coarse flow at full size, and the blurred
    # level-0 frames padded by EPAD rows
    rep = {}
    for dev in mesh.distinct():
        with on_device(dev):
            a = _pipeline.upload(np.asarray(prev, np.float32), dev)
            b = _pipeline.upload(np.asarray(nxt, np.float32), dev)
            Rs_a = polyexp_pyramid(a, cfg, fine=False)
            Rs_b = polyexp_pyramid(b, cfg, fine=False)
            if Rs_a:
                coarse = farneback_from_pyramids(Rs_a, Rs_b, cfg)
                flow_full = resize_linear(coarse.movedim(-1, 0), hg, wg) \
                    * (1.0 / cfg.pyr_scale)
            else:
                flow_full = torch.zeros((2, hg, wg), dtype=torch.float32,
                                        device=dev)
            rep[dev] = (
                pad1d(gaussian_blur_level(a, cfg), EPAD, EPAD, 0,
                      "replicate"),
                pad1d(gaussian_blur_level(b, cfg), EPAD, EPAD, 0,
                      "replicate"),
                pad1d(flow_full, RPAD, RPAD, 1, "replicate"))

    # each shard's plane slabs (band rows +- RPAD) and initial flow slab
    slabs, flows = [], []
    for i, dev in enumerate(mesh.devices):
        pa, pb, fp = rep[dev]
        r0 = i * hb
        with on_device(dev):
            slabs.append(tuple(
                poly_expansion_planar(p[r0:r0 + hb + 2 * EPAD], cfg.poly_n,
                                      cfg.poly_sigma, out_dtype=dt)[
                    :, cfg.poly_n:-cfg.poly_n].contiguous()
                for p in (pa, pb)))
            flows.append(fp[:, r0:r0 + hb + 2 * RPAD].contiguous())

    for _ in range(cfg.iterations):
        bands = []
        for i, (dev, (R0s, R1s), fs) in enumerate(zip(mesh.devices, slabs,
                                                      flows)):
            with on_device(dev):
                new = flow_iter(R0s, R1s, fs, cfg.winsize, D,
                                cfg.gaussian_win, i * hb - RPAD, hg)
                bands.append(new[:, RPAD:RPAD + hb])
        # refresh each slab's halo from its neighbours
        flows = halo_exchange(bands, RPAD, "edge", dim=1)
    return np.concatenate([f[:, RPAD:RPAD + hb].movedim(0, -1).cpu().numpy()
                           for f in flows])
