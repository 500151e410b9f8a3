// K4 and K7b: coarse Farneback level images + their polynomial expansion,
// for one frame (K4) or a stack of N frames (K7b), in ONE launch; K11
// (at the end): the level images alone.
//
// Replaces kalman_hydra_tpu/kernels/level_image_pallas.py::
// coarse_polyexp_fused (_levels_polyexp_kernel, pallas_call :216) and
// ::coarse_polyexp_fused_batch (_levels_polyexp_batch_kernel, :267).
// Each coarse level k >= 1 is GaussianBlur(original, reflect101, up to
// 79 taps at 1080p) composed with the INTER_LINEAR resize,
// replicate-padded by n, then expanded into the 5 polyexp planes. The TPU
// kernel applies the composition as two banded MXU products
// V_k . img . H_k^T, one launch for all levels; here the same composed
// weights are host-built tap tables (per padded level row or column: the
// first source index, the count of its contiguous non-zero taps and
// their float32 weights, _band_mats/_band_mats_padded entry for entry,
// see kernels/level_image.py), applied as direct stencils.
//
// Bound on Hopper: memory on paper (a 1080p frame: read the 8.3 MB image,
// write 6.9 MB of bf16 planes, 2.5 us at 3.35 TB/s; ~0.2 GFLOP). In
// practice the work is the taps: a level row's vertical sum covers every
// source column its tile reaches with ~2.5 x 2^k taps, so each coarse
// level costs ~2.5 H W multiply-adds whatever its size, each with a load
// of the image from L1/L2, and the coarse polyexp adds ~110 per level
// pixel. The route this replaced launched a vertical pass, a horizontal
// pass and K3's kernel per level (15 launches at 1080p) with the
// vertical sums (tmp, at full image width) and the padded level (lvl) in
// device memory: 0.79 GB of scratch traffic at 1080p N = 36, more than
// the call's own 0.55 GB.
// Design: one launch; a block of 512 threads (three an SM) per (frame,
// level, output tile), read from a table of levels (coarsest first), with
// tile sizes per level chosen by the wrapper's plan (kernels/
// level_image.py::fused_plan: the largest tiles whose longest block does
// not outlast the call's share of the card, within a shared-memory budget
// of three blocks an SM). A block stages its rows' and columns' tap
// weights in shared memory (the horizontal ones transposed, so
// neighbouring threads read neighbouring banks), then builds its tile's
// padded level tile, (tile_h + 2n) x (tile_w + 2n), in shared memory, a
// group of level rows at a time: the vertical taps over just the source
// columns the tile's horizontal taps reach, a warp a level row and 128
// columns (each tap's weight one broadcast, four coalesced image loads,
// mostly from L2), into row buffers (index skewed by x / 32, so the
// 2^k-strided horizontal reads hit distinct banks), then the horizontal
// taps into the level tile; replicated border rows are computed once. It
// then runs the shared tile body (polyexp.cuh::polyexp_tile, taps unrolled
// at poly_n 5 and 7) on each 16-row band of the level tile. Neither tmp
// nor lvl exists in device memory. One frame has too few deep-level
// tiles to fill the card, and each is ~2,000 dependent tap loads a warp,
// so there the plan splits a tile across the blocks of a thread-block
// cluster (up to 8): each builds a contiguous share of the tile's level
// rows and stores them into the level tile of the cluster's first block
// (distributed shared memory), which runs the polyexp after a cluster
// barrier; many frames fill the card with whole tiles, and a launch with
// no split tile runs the kernel's instantiation without cluster code.
// Arithmetic per output element is the route's it replaced: the vertical
// sum in tap order, then the horizontal sum in tap order, each tap one
// fused multiply-add (__fmaf_rn, as nvcc contracted the old `acc += w *
// x`; the old tables' zero-weight padding taps added +-0 and are
// skipped), then K3's arithmetic; the output is the old route's bytes,
// however a tile is split. Every frame shares the tables: K4 is K7b with
// one frame, so a batched launch equals its per-frame launches bit for
// bit. The frame is blockIdx.x and the block blockIdx.y, so the blocks
// start tile-major: every frame's deep-level tiles, the longest, first.
// What it leaves (PERF.md section 6, on an H100 80GB HBM3 at 700 W):
// above its targets at 1080p N = 36 (~1.25 ms) and for one frame
// (~0.052 ms, below the 15 launches' ~0.096): each coarse level still
// costs ~2.5 H W taps, each an L2 load, and tiles recompute their halo.
#include <cooperative_groups.h>


#include "polyexp.cuh"

namespace cg = cooperative_groups;

namespace {

using kh::kPeTH;
using kh::pe_in_w;
using kh::pe_tap_stride;
using kh::PolyTaps;

constexpr int kFusedThreads = 512;
constexpr int kCols = 4;         // source columns of a lane's vertical sums
constexpr int kMaxLevels = 12;

// One coarse level of the fused launch (kernels/level_image.py::
// fused_plan and _fused_tables_on).
struct Level {
  const float* wv;   // (ho, tv) vertical weights, row-major
  const int2* fv;    // (ho) first source row, tap count
  const float* wht;  // (th, wo) horizontal weights, transposed
  const int2* fh;    // (wo) first source column, tap count
  const int2* xs;    // (tiles_x) first source column, column span
  void* out;         // (frames, 5, lh, lw) f32 or bf16
  int lh, lw, ho, wo, tv, th;
  int tile_h, tile_w, tiles_x, block0, group;
  int split;         // blocks of a cluster that build one tile's rows
};

struct Plan {
  Level lv[kMaxLevels];
  PolyTaps t;        // n = 0: the level images alone (K11)
  const float* taps; // n > kPeNMax: [g, xg, xxg, ...] in device memory
  const float* img;  // (frames, h, w)
  int h, w, levels;
};

__device__ __forceinline__ int skew(int x) { return x + (x >> 5); }

// The horizontal taps of the level rows v0 .. v1 - 1 (their vertical
// sums in the row-buffer ring) into every padded level row of the tile
// that replicates them: rows 0 .. n copy row 0, the last n + 1 the last.
// `lvl` is the level tile of this block or, in a split tile, of the
// cluster block that runs the tile's polyexp.
__device__ __forceinline__ void level_rows_h(
    const Level& L, int n, int r0, int rows, int cols, int va0, int v0,
    int v1, int xlo, int stride, int in_w, const int2* hf, const float* hw,
    const float* rb, float* lvl) {
  for (int i = threadIdx.x; i < (v1 - v0) * cols; i += kFusedThreads) {
    const int dv = i / cols, pl = i - dv * cols;
    const int v = v0 + dv;
    const int2 fc = hf[pl];
    const float* row = rb + ((v - va0) % L.group) * stride;
    const int x0 = fc.x - xlo;
    float acc = 0.f;
    for (int t = 0; t < fc.y; ++t)
      acc = __fmaf_rn(hw[t * cols + pl], row[skew(x0 + t)], acc);
    const int o_lo = max(v == 0 ? 0 : v + n, r0);
    const int o_hi = min(v == L.lh - 1 ? L.ho - 1 : v + n, r0 + rows - 1);
    for (int o = o_lo; o <= o_hi; ++o) lvl[(o - r0) * in_w + pl] = acc;
  }
}

// kSplit: launched in clusters, where a level may split its tiles; the
// instantiation without it (a launch with no split tile) has no cluster
// code at all. kPoly = false (K11) stores the level tile itself, n = 0.
// Three blocks an SM (40 registers a thread).
template <typename OutT, int kN, bool kSplit, bool kPoly>
__global__ void __launch_bounds__(kFusedThreads, 3)
level_polyexp_kernel(const Plan p) {
  extern __shared__ __align__(16) float smem[];
  // blocks run tile-major (blockIdx.x is the frame): every frame's
  // deep-level tiles, the longest, start first
  const int frame = blockIdx.x, block = blockIdx.y;
  int li = 0;
  while (li + 1 < p.levels && block >= p.lv[li + 1].block0) ++li;
  const Level& L = p.lv[li];
  const int n = !kPoly ? 0 : kN ? kN : p.t.n, tid = threadIdx.x;
  const int in_w = pe_in_w(n);                  // the level tile's stride
  // A level's blocks start at a multiple of the cluster size, so a
  // cluster holds blocks of one level only; `split` of them (cluster
  // ranks part = 0 .. split - 1 of one tile) build a tile's level rows
  // together, each a contiguous share, into the level tile of part 0,
  // which then runs the polyexp. Blocks past the level's last tile (the
  // padding to a whole cluster) only meet the cluster barriers.
  const int S = kSplit ? L.split : 1;
  const int tix = (block - L.block0) / S, part = block - L.block0 - tix * S;
  const int tiles_y = (L.lh + L.tile_h - 1) / L.tile_h;
  const bool real = tix < tiles_y * L.tiles_x;
  if (kSplit && S > 1) cg::this_cluster().sync();  // all have started
  if (!real) {
    if (kSplit && S > 1) cg::this_cluster().sync();
    return;
  }
  const int ty = tix / L.tiles_x, tx = tix - ty * L.tiles_x;
  const int r0 = ty * L.tile_h, c0 = tx * L.tile_w;
  const int rows = min(L.tile_h + 2 * n, L.ho - r0);   // level rows built
  const int cols = min(L.tile_w + 2 * n, L.wo - c0);   // level cols built
  const int2 xs = L.xs[tx];
  const int xlo = xs.x, xspan = xs.y;
  const int stride = skew(xspan - 1) + 1;               // a row buffer
  const float* img = p.img + frame * (long)p.h * p.w + xlo;
  const int tv = L.tv, th = L.th;
  // the distinct level rows (the unpadded level's) the tile's padded
  // rows replicate: padded row o is level row clamp(o - n, 0, lh - 1),
  // whose taps are table row v + n; this block builds its part's share,
  // nv rows from va0
  const int vt0 = max(r0 - n, 0), vt1 = min(r0 + rows - 1 - n, L.lh - 1);
  const int va0 = vt0 + part * (vt1 - vt0 + 1) / S;
  const int nv = vt0 + (part + 1) * (vt1 - vt0 + 1) / S - va0;
  float* part0 = nullptr;       // a split tile's level tile, in part 0
  if (kSplit && S > 1)
    part0 = cg::this_cluster().map_shared_rank(
        smem, cg::this_cluster().block_rank() - part);

  // shared memory: the level tile, then (phase A) the tables and the row
  // buffers or (phase B) K3's vertical planes and taps
  float* lvl = smem;
  float* reg = smem + (L.tile_h + 2 * n) * in_w;
  int2* vf = reinterpret_cast<int2*>(reg);
  int2* hf = vf + rows;
  float* vw = reinterpret_cast<float*>(hf + cols);
  float* hw = vw + rows * tv;                            // (th, cols)
  float* rb = hw + th * cols;

  for (int i = tid; i < nv; i += kFusedThreads) vf[i] = L.fv[va0 + n + i];
  for (int i = tid; i < cols; i += kFusedThreads) hf[i] = L.fh[c0 + i];
  for (int i = tid; i < nv * tv; i += kFusedThreads)
    vw[i] = L.wv[(long)(va0 + n) * tv + i];
  for (int i = tid; i < th * cols; i += kFusedThreads) {
    const int t = i / cols;
    hw[i] = L.wht[(long)t * L.wo + c0 + (i - t * cols)];
  }
  __syncthreads();

  // Vertical taps, a group of level rows at a time: a warp takes one
  // level row and 32 kCols of the tile's source columns, a lane kCols of
  // them 32 apart (coalesced image reads); each tap's weight is one
  // broadcast read, then kCols multiply-adds, each column's sum in tap
  // order. The sums go to the row buffers; then the horizontal taps.
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = kFusedThreads / 32, kChunk = 32 * kCols;
  const int chunks = (xspan + kChunk - 1) / kChunk;
  for (int g0 = 0; g0 < nv; g0 += L.group) {
    const int gn = min(L.group, nv - g0);
    for (int it = warp; it < gn * chunks; it += kWarps) {
      const int g = it / chunks, x0 = (it - g * chunks) * kChunk + lane;
      const int2 fc = vf[g0 + g];
      const float* wr = vw + (g0 + g) * tv;
      const float* src = img + (long)fc.x * p.w + x0;
      float acc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
      if (x0 + 32 * (kCols - 1) < xspan) {
#pragma unroll 4
        for (int t = 0; t < fc.y; ++t) {
          const float wt = wr[t];
          const float* row = src + (long)t * p.w;
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[j] = __fmaf_rn(wt, __ldg(row + 32 * j), acc[j]);
        }
      } else {
        for (int t = 0; t < fc.y; ++t) {
          const float wt = wr[t];
          const float* row = src + (long)t * p.w;
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            if (x0 + 32 * j < xspan)
              acc[j] = __fmaf_rn(wt, __ldg(row + 32 * j), acc[j]);
        }
      }
      float* out = rb + g * stride;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (x0 + 32 * j < xspan) out[skew(x0 + 32 * j)] = acc[j];
    }
    __syncthreads();
    if (kSplit && S > 1)  // two calls: the local tile's stores stay shared
      level_rows_h(L, n, r0, rows, cols, va0, va0 + g0, va0 + g0 + gn, xlo,
                   stride, in_w, hf, hw, rb, part0);
    else
      level_rows_h(L, n, r0, rows, cols, va0, va0 + g0, va0 + g0 + gn, xlo,
                   stride, in_w, hf, hw, rb, lvl);
    __syncthreads();
  }
  if (kSplit && S > 1) {  // the tile's rows are in part 0's level tile
    cg::this_cluster().sync();
    if (part != 0) return;
  }

  const int r_end = min(L.lh, r0 + L.tile_h), c_end = min(L.lw, c0 + L.tile_w);
  if constexpr (!kPoly) {   // K11: the level tile itself, a row a warp
    float* out = static_cast<float*>(L.out) + frame * (long)L.lh * L.lw;
    const int tw = c_end - c0;
    for (int i = tid; i < (r_end - r0) * tw; i += kFusedThreads) {
      const int y = i / tw, x = i - y * tw;
      out[(long)(r0 + y) * L.lw + c0 + x] = lvl[y * in_w + x];
    }
    return;
  }

  // K3's tile body on each 16-row band of the level tile
  float* vs = reg;
  float* tg = reg + 3 * kPeTH * in_w;
  const int taps = 2 * n + 1, ts = pe_tap_stride(n);
  for (int k = tid; k < taps; k += kFusedThreads) {
    tg[k] = p.taps ? p.taps[k] : p.t.g[k];
    tg[ts + k] = p.taps ? p.taps[taps + k] : p.t.xg[k];
    tg[2 * ts + k] = p.taps ? p.taps[2 * taps + k] : p.t.xxg[k];
  }
  __syncthreads();
  OutT* out = static_cast<OutT*>(L.out) + frame * 5L * L.lh * L.lw;
  for (int band = 0; band < L.tile_h && r0 + band < L.lh; band += kPeTH) {
    kh::polyexp_tile<OutT, kFusedThreads, kN>(lvl + band * in_w, vs, tg,
                                              p.t, r0 + band, c0, L.lh,
                                              L.lw, r_end, c_end, out);
    __syncthreads();
  }
}

// One grant for each of the kernel's instantiations (common.cuh).
template <typename OutT, int kN, bool kSplit, bool kPoly>
cudaError_t grant_smem(int smem) {
  static kh::SmemGrant grant;
  return grant.allow(level_polyexp_kernel<OutT, kN, kSplit, kPoly>, smem);
}

template <typename OutT, int kN, bool kPoly = true>
cudaError_t launch_fused(const Plan& p, dim3 grid, int cluster, int smem,
                         cudaStream_t s) {
  if (cluster == 1) {
    const cudaError_t e = grant_smem<OutT, kN, false, kPoly>(smem);
    if (e != cudaSuccess) return e;
    level_polyexp_kernel<OutT, kN, false, kPoly>
        <<<grid, kFusedThreads, smem, s>>>(p);
    return cudaGetLastError();
  }
  const cudaError_t e = grant_smem<OutT, kN, true, kPoly>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kFusedThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, level_polyexp_kernel<OutT, kN, true, kPoly>,
                            p);
}

template <typename OutT>
cudaError_t launch_fused_n(const Plan& p, dim3 grid, int cluster, int smem,
                           cudaStream_t s) {
  switch (p.t.n) {          // cv2's poly_n 5 and 7 unrolled; others not
                            // (taps from shared memory)
    case 5: return launch_fused<OutT, 5>(p, grid, cluster, smem, s);
    case 7: return launch_fused<OutT, 7>(p, grid, cluster, smem, s);
    default: return launch_fused<OutT, 0>(p, grid, cluster, smem, s);
  }
}

// Reads a launch's level table (ptrs 6 a level, dims 12 a level) into p;
// false where it is malformed.
bool fill_levels(Plan& p, int levels, const unsigned long long* ptrs,
                 const int* dims, int cluster) {
  p.levels = levels;
  for (int i = 0; i < levels; ++i) {
    const unsigned long long* q = ptrs + 6 * i;
    const int* d = dims + 12 * i;
    Level& L = p.lv[i];
    L.wv = reinterpret_cast<const float*>(q[0]);
    L.fv = reinterpret_cast<const int2*>(q[1]);
    L.wht = reinterpret_cast<const float*>(q[2]);
    L.fh = reinterpret_cast<const int2*>(q[3]);
    L.xs = reinterpret_cast<const int2*>(q[4]);
    L.out = reinterpret_cast<void*>(q[5]);
    L.lh = d[0]; L.lw = d[1]; L.ho = d[2]; L.wo = d[3]; L.tv = d[4];
    L.th = d[5]; L.tile_h = d[6]; L.tile_w = d[7]; L.tiles_x = d[8];
    L.block0 = d[9]; L.group = d[10]; L.split = d[11];
    if (L.split < 1 || cluster % L.split || L.block0 % cluster)
      return false;
  }
  return true;
}

bool bad_launch(int frames, int levels, int blocks, int cluster, int smem) {
  return frames <= 0 || blocks <= 0 || blocks > 65535 || levels < 1 ||
         levels > kMaxLevels || smem > 232448 ||
         (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
         blocks % cluster;
}

}  // namespace

// All coarse levels of `frames` images in one launch, at most kMaxLevels
// (the wrapper makes one launch for each run of that many). img (frames,
// h, w) f32; per level i (plan order, coarsest first) ptrs[6 i ..] = wv,
// fv, wht, fh, xs, out and dims[12 i ..] = lh, lw, ho, wo, tv, th,
// tile_h, tile_w, tiles_x, block0, group, split (kernels/level_image.py::
// _launch); `blocks` a frame, all levels, in clusters of `cluster`
// (1, 2, 4 or 8; each level's block0 a multiple of it), `smem` bytes of
// dynamic shared memory a block. taps_host = [g, xg, xxg (2n+1 each),
// ig11, ig03, ig33, ig55] f32 in host memory; for n > kPeNMax the same
// array in device memory too (taps_dev, else null).
KH_API int kh_level_polyexp(const void* img, int frames, int h, int w,
                            int levels, const unsigned long long* ptrs,
                            const int* dims, const void* taps_host,
                            const void* taps_dev, int n, int out_bf16,
                            int blocks, int cluster, int smem,
                            void* stream) {
  if (bad_launch(frames, levels, blocks, cluster, smem) || n < 1 ||
      n > 255 || (n > kh::kPeNMax && !taps_dev))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  p.t = kh::poly_taps(static_cast<const float*>(taps_host), n);
  p.taps = n > kh::kPeNMax ? static_cast<const float*>(taps_dev) : nullptr;
  p.img = static_cast<const float*>(img);
  p.h = h;
  p.w = w;
  if (!fill_levels(p, levels, ptrs, dims, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(frames, blocks);
  return static_cast<int>(
      out_bf16 ? launch_fused_n<__nv_bfloat16>(p, grid, cluster, smem, s)
               : launch_fused_n<float>(p, grid, cluster, smem, s));
}

// K11: the coarse level images of one frame, with no polyexp, in ONE
// launch (at most kMaxLevels levels). Replaces level_image_pallas.py::
// farneback_images_pallas (_levels_kernel), whose two MXU band products
// V_k . img . H_k^T per level are the same composed weights as above at
// padding 0 (level_tables(..., n=0) is the unpadded _band_mats). Bound on
// Hopper: memory; a 1080p frame's five coarse levels must read the 8.3 MB
// image and write 2.8 MB (3.3 us at 3.35 TB/s). The route this replaced
// made two launches a level (vertical taps into a (lh, w) scratch in
// device memory, then horizontal), re-reading the image per level. Here
// each block builds its level tile in shared memory as K4 does (the
// level-row build above, split over a cluster where the plan says so)
// and stores it: no scratch, the same multiply-adds in the same order,
// so the route's bytes. What it leaves (PERF.md section 6): each level's
// vertical taps still load ~2.5 H W image values, mostly from L2, ten
// times the bytes the function must move, each tile's chain of them one
// dependent load a tap. img (h, w) f32;
// ptrs/dims as kh_level_polyexp's (from the plan at n = 0), each out
// (lh, lw) f32.
KH_API int kh_level_images(const void* img, int h, int w, int levels,
                           const unsigned long long* ptrs, const int* dims,
                           int blocks, int cluster, int smem, void* stream) {
  if (bad_launch(1, levels, blocks, cluster, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  p.img = static_cast<const float*>(img);
  p.h = h;
  p.w = w;
  if (!fill_levels(p, levels, ptrs, dims, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_fused<float, 0, false>(
      p, dim3(1, blocks), cluster, smem, static_cast<cudaStream_t>(stream)));
}
