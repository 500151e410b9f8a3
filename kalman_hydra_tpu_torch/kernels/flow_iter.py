"""K2, K6 and K13 wrappers: one fine-level Farneback iteration for one
frame pair (K2) or for B pairs of one frame stack (K6), csrc/flow_iter.cu;
all iterations of one level in one launch (K13), csrc/flow_iters_pipe.cu.

K2 replaces kalman_hydra_tpu/kernels/flow_iter_pallas.py::flow_iter:
R0, R1 (5, h, w) unwarped polyexp planes (bf16 or f32), flow (2, h, w)
f32 prior -> (2, h, w) f32 new absolute flow. Select-sum warp clamped to
+-max_disp (FlowConfig.fast_warp), averaged normal equations with the
OpenCV border taper, winsize window with a replicate border on M, 2x2
solve. Follows the TPU kernel's precision (flow and M in f32), not the
XLA twin's bf16 rounding of both.

K2's band mode (`flow_iter` with row0/img_h; the reference's flow_iter
band mode, run by parallel/spatial.py's
farneback_sharded): the planes and the flow are a row slab whose row 0
is row `row0` of an image `img_h` rows tall. The taper then reads the
image's rows, and M's replicate border sits at the image's edge rows
(`band_rows`), so a band's interior is the full image's rows.

K6 replaces flow_iter_pallas.py::flow_iter_pairs: Rall (N, 5, h, w),
flow_b (B, 2, h, w) -> (B, 2, h, w); pair b reads frames p and p + 1 of
Rall (`pair_frames`). Both wrappers launch the same CUDA kernel, so K6
equals per-pair K2 bit for bit. The planes go in unpadded: the kernels
clamp their indices where the TPU kernels read edge-padded slabs.

K2, K6 and K13 run one tile body in shared memory (csrc/flow_tile.cuh),
as K8 and K8-pairs do (kernels/flow_update.py): `tile_plan` is the tile
and shared-memory plan the wrappers pass to the kernels (the 32 x 64
tile up to winsize 61, a smaller tile past it, and where no tile fits,
from winsize 101, M in device memory: three launches an iteration; K13
then runs n_iters of them), `pipe_items` / `pipe_waits` K13's work order
and wait set.

CPU tensors take `flow_iter_plain` (with row0/img_h in band mode) /
`flow_iter_pairs_plain` /
`flow_iters_pipelined_plain`; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ..ops.filters import gaussian_kernel, pad1d
from ..ops.warp import warp_selectsum

PLANE_DTYPES = (torch.float32, torch.bfloat16)

# OpenCV's FarnebackUpdateMatrices border taper (ops/farneback.py in the
# reference), indexed by the distance to the nearest edge
_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472],
                         dtype=np.float32)


@lru_cache(maxsize=16)
def window_weights(winsize: int, gaussian: bool):
    """(taps f32, post_scale): the cv2 Gaussian window
    (sigma = (winsize//2) * 0.3); a 3-divisible uniform box as unit taps
    with (1/n)^2 applied after both passes (the TPU kernel's factored box);
    otherwise explicit 1/n taps."""
    n = 2 * (winsize // 2) + 1
    if gaussian:
        return gaussian_kernel(n, (winsize // 2) * 0.3), 1.0
    if n % 3 == 0:
        inv = 1.0 / n
        return np.ones(n, np.float32), float(np.float32(inv * inv))
    return np.full(n, np.float32(1.0 / n), np.float32), 1.0


def band_rows(h: int, row0: int, img_h: int):
    """(lo, hi): the rows of an h-row slab, its row 0 at image row row0,
    that lie in an image of img_h rows (K2's band mode); ValueError for a
    slab with none, or without img_h."""
    if img_h <= 0:
        raise ValueError("band mode (row0 given) requires img_h, the "
                         "image's height")
    lo, hi = max(0, -row0), min(h - 1, img_h - 1 - row0)
    if lo > hi:
        raise ValueError(f"band mode: slab rows {row0}..{row0 + h - 1} "
                         f"miss an image of {img_h} rows")
    return lo, hi


def border_damp(h: int, w: int, device, row0: int = 0,
                img_h: int = 0) -> torch.Tensor:
    """(h, w) f32 multiplicative taper of the normal equations; with
    img_h, at image rows row0 ... row0 + h - 1 (clamped to the image)."""
    def axis(i, n):     # positions i along an axis of n
        d = np.minimum(i, n - 1 - i)
        s = np.where(d < len(_BORDER_SCALE),
                     _BORDER_SCALE[np.minimum(d, len(_BORDER_SCALE) - 1)],
                     np.float32(1.0)).astype(np.float32)
        return torch.as_tensor(s, device=device)
    rows = (axis(np.clip(np.arange(h) + row0, 0, img_h - 1), img_h)
            if img_h else axis(np.arange(h), h))
    return rows[:, None] * axis(np.arange(w), w)[None, :]


def flow_iter_plain(R0, R1, flow, winsize: int, max_disp: int,
                    gaussian: bool = False, row0=None,
                    img_h: int = 0) -> torch.Tensor:
    """K2's plain version; with row0, its band mode (see solve_warped)."""
    R1w = warp_selectsum(R1.to(torch.float32), flow[0], flow[1], max_disp)
    return solve_warped(R0.to(torch.float32), R1w, flow,
                        *window_weights(winsize, bool(gaussian)),
                        row0=row0, img_h=img_h)


def normal_matrices(R0, R1w, flow, damp) -> torch.Tensor:
    """Step 2 of an iteration: the per-pixel normal equations M = (G11,
    G12, G22, h1, h2) of f32 (5, h, w) planes R0 and R1 warped, in the
    absolute-flow form, each factor tapered by `damp` (h, w)."""
    dx, dy = flow[0], flow[1]
    a_xx = (R0[2] + R1w[2]) * 0.5
    a_yy = (R0[3] + R1w[3]) * 0.5
    axy = (R0[4] + R1w[4]) * 0.25
    db_x = (R0[0] - R1w[0]) * 0.5 + a_xx * dx + axy * dy
    db_y = (R0[1] - R1w[1]) * 0.5 + axy * dx + a_yy * dy
    a_xx, a_yy, axy, db_x, db_y = (t * damp
                                   for t in (a_xx, a_yy, axy, db_x, db_y))
    return torch.stack([a_xx * a_xx + axy * axy, (a_xx + a_yy) * axy,
                        a_yy * a_yy + axy * axy, a_xx * db_x + axy * db_y,
                        axy * db_x + a_yy * db_y])


def solve_warped(R0, R1w, flow, wts, post: float, round_m: bool = False,
                 row0=None, img_h: int = 0) -> torch.Tensor:
    """Steps 2-4 of an iteration, given R1 already warped: the damped
    normal equations (rounded to bf16 with round_m, K8-pairs' bf16
    store), the window `wts` (then `post`) over M with a replicate
    border, the 2x2 solve. The plain arithmetic of K2 and K8. With row0
    (K2's band mode) the taper reads image rows row0 ..., and M's rows
    outside the image (`band_rows`) are replaced by its edge row before
    the slab's replicate border."""
    _, h, w = R0.shape
    band = row0 is not None
    if band:
        lo, hi = band_rows(h, int(row0), img_h)
    damp = (border_damp(h, w, R0.device, int(row0), img_h) if band
            else border_damp(h, w, R0.device))
    M = normal_matrices(R0, R1w, flow, damp)
    if band and (lo > 0 or hi < h - 1):
        M = M.index_select(1, torch.arange(h, device=M.device).clamp(lo, hi))
    if round_m:
        M = M.to(torch.bfloat16).to(torch.float32)
    bw = len(wts) // 2
    Mp = pad1d(M, bw, bw, 1, "replicate")
    Mv = sum(float(wk) * Mp[:, k:k + h, :] for k, wk in enumerate(wts))
    Mp = pad1d(Mv, bw, bw, 2, "replicate")
    g = sum(float(wk) * Mp[:, :, k:k + w] for k, wk in enumerate(wts))
    g11, g12, g22, h1, h2 = (g * post) if post != 1.0 else g
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g22 * h1 - g12 * h2) * idet,
                        (g11 * h2 - g12 * h1) * idet])


def pair_count(n_frames: int, clip_len: int = 0) -> int:
    """Frame pairs of an N-frame stack: N - 1, or (N // T) * (T - 1) when
    clip_len = T chains clips of T frames end to end."""
    if clip_len:
        return (n_frames // clip_len) * (clip_len - 1)
    return n_frames - 1


def pair_frames(pairs: int, clip_len: int = 0) -> list:
    """First frame p of each pair b: p = b + b // (T - 1) with
    clip_len = T, else p = b, so no pair straddles two clips."""
    if clip_len:
        return [b + b // (clip_len - 1) for b in range(pairs)]
    return list(range(pairs))


def check_pairs(n_frames: int, pairs: int, clip_len: int) -> None:
    """Refuse a pair count that does not match the stack, as the
    reference's flow_iter_pairs does."""
    if clip_len == 1 or clip_len < 0:
        raise ValueError(f"clip_len={clip_len}: must be 0 or >= 2")
    want = pair_count(n_frames, clip_len)
    if pairs != want:
        raise ValueError(f"clip_len={clip_len}: {n_frames} frames give "
                         f"{want} pairs, got {pairs}")


def flow_iter_pairs_plain(Rall, flow_b, winsize: int, max_disp: int,
                          gaussian: bool = False,
                          clip_len: int = 0) -> torch.Tensor:
    check_pairs(Rall.shape[0], flow_b.shape[0], clip_len)
    return torch.stack([
        flow_iter_plain(Rall[p], Rall[p + 1], flow_b[b], winsize, max_disp,
                        gaussian)
        for b, p in enumerate(pair_frames(flow_b.shape[0], clip_len))])


SMEM_LIMIT = 232_448     # bytes of shared memory one H100 block may use
MAX_TAPS = 61            # csrc/flow_tile.cuh::kMaxTaps: taps by value
STATIC_SMEM = 4 * MAX_TAPS + 16   # the kernels' static shared memory
TILE = (32, 64)          # (rows, columns): csrc/flow_tile.cuh kTileH, kTileW
# the tiles past MAX_TAPS taps, largest first (flow_tile.cuh::kShapes 1-4)
TILES = (TILE, (16, 64), (16, 32), (8, 16), (8, 8))
MEM = -1                 # the plan's shape where no tile fits


class TilePlan(NamedTuple):
    th: int          # tile rows (0 with M in device memory)
    tw: int          # tile columns (0 likewise)
    taps: int        # window taps, 2 * (winsize // 2) + 1
    rows: int        # tiles down the level (K13's bands; 0 likewise)
    cols: int        # tiles across it (0 likewise)
    smem: int        # dynamic shared memory of one block, bytes (0 likewise)
    shape: int = 0   # index into TILES, or MEM: M in device memory


def tile_smem(th: int, tw: int, taps: int) -> int:
    """One tile's dynamic shared memory: M on the tile and its bw = taps
    // 2 halo, 5 f32 planes of (th + 2 bw) rows at an odd row stride of
    (tw + 2 bw) | 1 (csrc/flow_tile.cuh)."""
    bw = taps // 2
    return 4 * 5 * (th + 2 * bw) * ((tw + 2 * bw) | 1)


def tile_plan(h: int, w: int, winsize: int) -> TilePlan:
    """The tiles of an h x w level and one block's shared memory: up to
    MAX_TAPS taps the 32 x 64 tile; past it the first of TILES whose
    tile_smem (with the kernels' static shared memory) fits one block
    (16 x 64 at winsize 63, 16 x 32 at 81, 8 x 8 up to 99); where none
    fits, shape MEM: M in device memory."""
    if h < 1 or w < 1:
        raise ValueError(f"level {h}x{w} is empty")
    taps = 2 * (winsize // 2) + 1
    for shape, (th, tw) in enumerate(TILES if taps > MAX_TAPS else TILES[:1]):
        smem = tile_smem(th, tw, taps)
        if smem + STATIC_SMEM <= SMEM_LIMIT:
            return TilePlan(th, tw, taps, -(-h // th), -(-w // tw), smem,
                            shape)
    return TilePlan(0, 0, taps, 0, 0, 0, MEM)


def pipe_dt(plan: TilePlan, max_disp: int) -> int:
    """Column tiles on each side whose prior flow a K13 tile reads: M on
    the halo (bw columns) warps by up to max_disp + 1 columns."""
    return -(-(plan.taps // 2 + int(max_disp) + 1) // plan.tw)


def pipe_db(plan: TilePlan) -> int:
    """Bands on each side whose prior flow a K13 tile reads: M on the
    halo (bw rows); 1 on the 32 x 64 tile."""
    return -(-(plan.taps // 2) // plan.th)


def pipe_skew(plan: TilePlan, n_iters: int, sms: int) -> int:
    """K13's skew: enough that, once all n_iters iterations are in
    flight, the tickets between an item and the items it waits for,
    (skew - 1) * cols * n_iters, outnumber twice the blocks the card
    holds at once (2 an SM), so that a waiting item rarely finds its
    neighbours still running; at most the band count, and at least the
    bands a tile's flow reaches (pipe_db) or the band count, so that
    every wait is on a smaller ticket. 7 at 1080p and 13 at 540x960 on
    132 SMs (winsize 15; PERF.md has the measured skews)."""
    resident = 2 * sms
    return max(1, min(plan.rows, max(pipe_db(plan), -(-2 * resident // (
        plan.cols * n_iters)) + 1)))


def pipe_items(n_iters: int, nb: int, nt: int, skew: int = 1) -> list:
    """K13's work items (j, b, t) in ticket order: by s = b + skew * j,
    then j, then t (csrc/flow_tile.cuh::pipe_item)."""
    out = []
    for s in range(nb + skew * (n_iters - 1)):
        for j in range(n_iters):
            if 0 <= s - skew * j < nb:
                out.extend((j, s - skew * j, t) for t in range(nt))
    return out


def pipe_waits(j: int, b: int, t: int, nb: int, nt: int, dt: int,
               db: int = 1) -> list:
    """The items (j - 1, b', t') item (j, b, t) waits for: bands b - db ...
    b + db and tiles t - dt ... t + dt, clipped to the level."""
    if j == 0:
        return []
    return [(j - 1, bb, tt)
            for bb in range(max(0, b - db), min(nb - 1, b + db) + 1)
            for tt in range(max(0, t - dt), min(nt - 1, t + dt) + 1)]


_device_windows: dict = {}


def device_window(wts: np.ndarray, device):
    """A window's taps in device memory (cached per device and taps), the
    kernels' copy past MAX_TAPS taps; None up to it (the taps ride in the
    launch's parameters)."""
    if wts.shape[0] <= MAX_TAPS:
        return None
    key = (str(device), wts.tobytes())
    t = _device_windows.get(key)
    if t is None:
        t = _device_windows[key] = torch.as_tensor(wts, device=device)
    return t


def _host_window(winsize: int, gaussian: bool, device=None):
    """(taps as a C float pointer, the taps' device copy as one past
    MAX_TAPS taps, else None, count, post_scale): the kernels copy the
    taps into their launch parameters."""
    wts, post = window_weights(winsize, bool(gaussian))
    dw = device_window(wts, device)
    return (wts.ctypes.data, None if dw is None else dw.data_ptr(),
            wts.shape[0], post)


def mem_scratch(plan: TilePlan, pairs: int, h: int, w: int, device):
    """M and its vertical pass, (2, pairs, 5, h, w) f32, for a plan with
    M in device memory; None for a tile plan."""
    if plan.shape != MEM:
        return None
    return torch.empty((2, pairs, 5, h, w), dtype=torch.float32,
                       device=device)


def _launch(R0, R1, flow_b, ppc: int, winsize: int, max_disp: int,
            gaussian: bool, row0: int, img_h: int) -> torch.Tensor:
    """kh_flow_iter over the pairs of flow_b (B, 2, h, w); pair b reads
    R0 and R1 offset by its first frame (see csrc/flow_iter.cu); the
    planes are rows row0 ... of an image img_h rows tall (0 and h for a
    full frame; K2's band mode)."""
    B, _, h, w = flow_b.shape
    plan = tile_plan(h, w, winsize)
    wts, wts_dev, taps, post = _host_window(winsize, gaussian, R0.device)
    out = torch.empty((B, 2, h, w), dtype=torch.float32, device=R0.device)
    scratch = mem_scratch(plan, B, h, w, R0.device)
    P, I = _build.P, _build.I
    fn = _build.function("kh_flow_iter", P, P, I, I, I, P, I, I, I, I, I, P,
                         P, I, _build.F, I, I, P, P, P)
    rc = fn(R0.data_ptr(), R1.data_ptr(), int(R0.dtype == torch.bfloat16),
            B, ppc, flow_b.data_ptr(), h, w, int(max_disp), int(row0),
            int(img_h), wts, wts_dev, taps, post,
            plan.shape, plan.smem,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            _build.stream(R0))
    _build.check(rc, "kh_flow_iter")
    return out


def _require_pair(R0, R1, flow, name: str) -> None:
    _build.require(R0, "R0", PLANE_DTYPES, 3)
    _build.require(R1, "R1", (R0.dtype,), 3)
    _build.require(flow, "flow", (torch.float32,), 3)
    _, h, w = R0.shape
    if R0.shape[0] != 5 or R1.shape != R0.shape or flow.shape != (2, h, w):
        raise ValueError(f"{name}: R0 {tuple(R0.shape)}, R1 "
                         f"{tuple(R1.shape)}, flow {tuple(flow.shape)}")


def flow_iter(R0, R1, flow, winsize: int, max_disp: int,
              gaussian: bool = False, row0=None,
              img_h: int = 0) -> torch.Tensor:
    """One fused Farneback iteration: (5,h,w) x2 + (2,h,w) -> (2,h,w).

    With row0, K2's band mode: the planes and the flow are a row slab
    whose row 0 is row `row0` (negative above the image) of an image
    img_h rows tall; the slab rows whose window and warp stay in the slab
    are the full image's rows. The same kernel on every tile route; its
    launches count apart, in `flow_iter.band`."""
    band = row0 is not None
    if band:
        band_rows(R0.shape[-2], int(row0), img_h)
    if R0.device.type == "cpu":
        return flow_iter_plain(R0, R1, flow, winsize, max_disp, gaussian,
                               row0, img_h)
    _require_pair(R0, R1, flow, "flow_iter")
    out = _launch(R0, R1, flow[None], 0, winsize, max_disp, gaussian,
                  int(row0) if band else 0,
                  int(img_h) if band else R0.shape[-2])[0]
    (flow_iter.band if band else flow_iter).launches += 1
    return out


flow_iter.launches = 0
flow_iter.band = SimpleNamespace(launches=0)


def flow_iter_pairs(Rall, flow_b, winsize: int, max_disp: int,
                    gaussian: bool = False,
                    clip_len: int = 0) -> torch.Tensor:
    """One fused Farneback iteration for every pair of an (N, 5, h, w)
    plane stack: flow_b (B, 2, h, w) -> (B, 2, h, w)."""
    if Rall.device.type == "cpu":
        return flow_iter_pairs_plain(Rall, flow_b, winsize, max_disp,
                                     gaussian, clip_len)
    _build.require(Rall, "Rall", PLANE_DTYPES, 4)
    _build.require(flow_b, "flow_b", (torch.float32,), 4)
    N, _, h, w = Rall.shape
    if Rall.shape[1] != 5 or flow_b.shape[1:] != (2, h, w):
        raise ValueError(f"flow_iter_pairs: Rall {tuple(Rall.shape)}, "
                         f"flow_b {tuple(flow_b.shape)}")
    check_pairs(N, flow_b.shape[0], clip_len)
    out = _launch(Rall, Rall[1], flow_b, max(clip_len - 1, 0), winsize,
                  max_disp, gaussian, 0, h)
    flow_iter_pairs.launches += 1
    return out


flow_iter_pairs.launches = 0


@lru_cache(maxsize=8)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flow_iters_pipelined_plain(R0, R1, flow, winsize: int, max_disp: int,
                               n_iters: int,
                               gaussian: bool = False) -> torch.Tensor:
    for _ in range(n_iters):
        flow = flow_iter_plain(R0, R1, flow, winsize, max_disp, gaussian)
    return flow


def flow_iters_pipelined(R0, R1, flow, winsize: int, max_disp: int,
                         n_iters: int,
                         gaussian: bool = False) -> torch.Tensor:
    """K13: all `n_iters` (>= 2) iterations of one level in one launch,
    (5,h,w) x2 + (2,h,w) -> (2,h,w); the same values as n_iters K2
    launches (csrc/flow_iters_pipe.cu)."""
    if n_iters < 2:
        raise ValueError("flow_iters_pipelined needs n_iters >= 2 "
                         "(use flow_iter for a single iteration)")
    if R0.device.type == "cpu":
        return flow_iters_pipelined_plain(R0, R1, flow, winsize, max_disp,
                                          n_iters, gaussian)
    _build.require(R0, "R0", PLANE_DTYPES, 3)
    _build.require(R1, "R1", (R0.dtype,), 3)
    _build.require(flow, "flow", (torch.float32,), 3)
    _, h, w = R0.shape
    if R0.shape[0] != 5 or R1.shape != R0.shape or flow.shape != (2, h, w):
        raise ValueError(f"flow_iters_pipelined: R0 {tuple(R0.shape)}, R1 "
                         f"{tuple(R1.shape)}, flow {tuple(flow.shape)}")
    out = _pipe_route(R0, R1, flow, winsize, max_disp, n_iters, gaussian)
    flow_iters_pipelined.launches += 1
    return out


def _pipe_route(R0, R1, flow, winsize: int, max_disp: int, n_iters: int,
                gaussian: bool) -> torch.Tensor:
    """K13's launch on a tile of tile_plan, or, where no tile holds the
    window, n_iters iterations with M in device memory (K2's route)."""
    _, h, w = R0.shape
    if tile_plan(h, w, winsize).shape != MEM:
        return _launch_pipe(R0, R1, flow, winsize, max_disp, n_iters,
                            gaussian)
    for _ in range(n_iters):
        flow = _launch(R0, R1, flow[None], 0, winsize, max_disp,
                       gaussian, 0, h)[0]
    return flow


flow_iters_pipelined.launches = 0


def _launch_pipe(R0, R1, flow, winsize: int, max_disp: int, n_iters: int,
                 gaussian: bool) -> torch.Tensor:
    """kh_flow_iters_pipe on one level, on a tile of tile_plan, in
    pipe_skew's order."""
    _, h, w = R0.shape
    plan = tile_plan(h, w, winsize)
    dev = R0.device
    wts, wts_dev, taps, post = _host_window(winsize, gaussian, dev)
    skew = pipe_skew(plan, n_iters, _sm_count(dev))
    inter = torch.empty((n_iters - 1, 2, h, w), dtype=torch.float32,
                        device=dev)
    out = torch.empty((2, h, w), dtype=torch.float32, device=dev)
    counters = torch.empty(1 + plan.rows * plan.cols, dtype=torch.int32,
                           device=dev)
    P, I = _build.P, _build.I
    fn = _build.function("kh_flow_iters_pipe", P, P, I, P, I, I, I, P, P, I,
                         _build.F, I, I, I, I, P, P, P, P)
    rc = fn(R0.data_ptr(), R1.data_ptr(), int(R0.dtype == torch.bfloat16),
            flow.data_ptr(), h, w, int(max_disp), wts, wts_dev, taps, post,
            int(n_iters), int(skew), plan.shape, plan.smem, inter.data_ptr(),
            out.data_ptr(), counters.data_ptr(), _build.stream(R0))
    _build.check(rc, "kh_flow_iters_pipe")
    return out
