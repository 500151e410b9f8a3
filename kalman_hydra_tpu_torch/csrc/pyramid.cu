// K9: cv2.pyrDown chained over up to kMaxLevels levels of one f32
// image's pyramid, (H, W) -> ((H + 1) / 2, (W + 1) / 2) -> ..., in ONE
// launch.
//
// Replaces kalman_hydra_tpu/kernels/pyramid_pallas.py::pyr_down
// (_pyr_kernel, _decim_band), which runs once per level: the separable
// [1, 4, 6, 4, 1] / 16 blur with a REFLECT_101 border, kept at the even
// rows and columns. The TPU kernel pre-pads the image and applies the
// decimating blur as two banded MXU products (Mosaic refuses stride-2
// slices); here nothing is pre-padded.
//
// Arithmetic order is the plain version's (ops.filters.sep_filter2d):
// the vertical 5-tap sums at the five source columns, then the
// horizontal 5-tap sum of those, each tap a multiply then an add in tap
// order, without FMAs: bit-identical to the plain version.
//
// Design: halo recompute, no block waits on another. Level k depends on
// level k - 1 everywhere, so one launch either chains the levels across
// blocks or lets each block recompute what it needs; on an H100 a chain
// of per-band counters cost a few microseconds a level (measured, not
// kept), so each block owns a tile_h x tile_w tile of the coarsest level
// n and computes all n levels of it alone. Level k's pixels in rows
// r0 .. r1 read level k - 1's rows 2 r0 - 2 .. 2 r1 + 2, so the tile
// needs a region of 2^n (tile + 3) - 3 rows and columns of the image (at
// n = 4 and 9 x 8: 189 x 173). The block stages that region in shared
// memory: one TMA bulk copy a row for the image's columns (16-byte
// aligned: an aligned image whose width is a multiple of 4), 4-byte
// cp.async for the reflected edge columns; the REFLECT_101 row index is
// computed once per staged row, the column index only on the edge. It
// then computes levels 1 .. n in shared memory, each from the one below:
// a vertical pass into V (each thread 4 output rows of one column from 11
// staged rows), then a horizontal pass. A level's region holds its
// in-image pixels and, where the image edge falls inside it, the two
// reflected rows and columns beyond it that the next level reads, each
// computed at its reflected position. Only the block's own part of each
// level (its tile scaled by 2^(n - k)) is written out. The odd edge and
// levels of a few pixels (37 x 53 reaches 3 x 4 at four levels; 2 x 2;
// 1 x 5) take the same path. The wrapper picks the tile and the block
// size by the level count (kernels/pyramid.py TILES).
//
// Bound on Hopper: memory. One 1080p frame's four levels must read the
// 8.3 MB image once and write 2.8 MB (3.3 us at 3.35 TB/s) for ~30 FLOPs
// per output pixel. This design is far from it: at 1080p, n = 4, 120
// blocks (one wave, one block an SM: ~198 KB of shared memory) stage ~2x
// the image and compute level 1 ~1.8x over, in barrier-separated phases
// that no other block overlaps: on an H100 it takes 0.0232 ms on the
// device, above the 0.0188 ms of the four per-level launches of the
// direct stencil it replaced (PERF.md). Its gain is one launch, and one
// wrapper call, a pyramid.

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 4;     // more: the wrapper chains launches

struct Table {
  const float* src;               // level 0, (h[0], w[0])
  float* dst[kMaxLevels];         // levels 1 .. n
  int h[kMaxLevels + 1], w[kMaxLevels + 1];
  int n, tile_h, tile_w, tiles_x, vec, a_floats, b_floats;
};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  i = abs(i) % period;
  return i >= n ? period - i : i;
}

__device__ __forceinline__ int fold(int i, int n) {
  return i >= 0 && i < n ? i : reflect101(i, n);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one row segment, global -> shared, by the copy engine (TMA's 1-D
// bulk copy), completing on an mbarrier
__device__ __forceinline__ void bulk_copy(float* s, const float* g,
                                          int bytes, unsigned long long* m) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s)),
      "l"(g), "r"(bytes), "r"(smem_addr(m))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(g));
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
pyr_levels_kernel(const Table T) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long mbar;
  float* A = smem;                    // the staged image, then level k
  float* V = smem + T.a_floats;       // level k's vertical sums
  int* rowoff = reinterpret_cast<int*>(V + T.b_floats);
  const int n = T.n, tid = threadIdx.x;
  // the tile at level n; level k's region origin and size (k <= n) are
  // 2^(n-k) oy - 2 (2^(n-k) - 1) and 2^(n-k) (size + 3) - 3
  const int ty = blockIdx.x / T.tiles_x, tx = blockIdx.x % T.tiles_x;
  const int oyn = ty * T.tile_h, oxn = tx * T.tile_w;
  const float wk[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};

  // stage the image region: rows oy .. oy + rh - 1, columns from base
  // (ox rounded down to a multiple of 4) in groups of 4
  int poy = (oyn << n) - 2 * ((1 << n) - 1);
  int pox = (oxn << n) - 2 * ((1 << n) - 1);
  int prh = ((T.tile_h + 3) << n) - 3, prw = ((T.tile_w + 3) << n) - 3;
  const int base = pox & ~3;
  int pco = pox - base;                          // column of pox in a row
  int ps = (pco + prw + 3) & ~3;                 // row stride
  int ph = T.h[0], pw = T.w[0];
  for (int r = tid; r < prh; r += kThreads) rowoff[r] = fold(poy + r, ph);
  __syncthreads();
  // warps take items (a row, or 4 rows, by a 32-column chunk), lanes the
  // columns of a chunk
  const int warp = tid >> 5, lane = tid & 31, nwarps = kThreads / 32;
  // the image's columns ci0 .. ci1 - 1 of every staged row arrive by one
  // bulk copy a row (16-byte aligned: vec); the reflected edge columns,
  // and every column of an image that is not vec, by 4-byte cp.async
  const int ci0 = T.vec ? max(base, 0) : base + ps;
  const int ci1 = T.vec ? min(base + ps, pw) : base + ps;
  const int bytes = 4 * (ci1 - ci0);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&mbar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (bytes)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(&mbar)), "r"(bytes * prh) : "memory");
  }
  __syncthreads();
  if (bytes)
    for (int r = tid; r < prh; r += kThreads)
      bulk_copy(A + r * ps + (ci0 - base), T.src + (long)rowoff[r] * pw + ci0,
                bytes, &mbar);
  const int left = ci0 - base, edge = ps - (ci1 - ci0);
  for (int r = warp; r < prh; r += nwarps) {
    const float* row = T.src + (long)rowoff[r] * pw;
    for (int e = lane; e < edge; e += 32) {
      const int sc = e < left ? e : e + (ci1 - ci0);
      cp_async4(A + r * ps + sc, row + fold(base + sc, pw));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (bytes) {
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_addr(&mbar)) : "memory");
  }
  __syncthreads();

#pragma unroll
  for (int k = 1; k <= kMaxLevels; ++k) {   // unrolled: T.h[k], T.dst[k]
    if (k > n) break;                        // stay in registers
    const int s = n - k;
    const int oy = (oyn << s) - 2 * ((1 << s) - 1);
    const int ox = (oxn << s) - 2 * ((1 << s) - 1);
    const int rh = ((T.tile_h + 3) << s) - 3, rw = ((T.tile_w + 3) << s) - 3;
    const int hk = T.h[k], wk_ = T.w[k];
    // vertical sums at this level's in-image rows q_lo .. q_hi, 4 rows a
    // thread from 11 staged rows, and the level below's valid columns
    // c_lo .. c_hi (its region within [-2, pw + 1])
    const int q_lo = max(oy, 0), q_hi = min(oy + rh, hk) - 1;
    const int c_lo = max(pox, -2), c_hi = min(pox + prw, pw + 2) - 1;
    const int nc = c_hi - c_lo + 1;
    const int groups = (q_hi - q_lo + 4) / 4, chunks = (nc + 31) / 32;
    for (int it = warp; it < groups * chunks; it += nwarps) {
      const int g = it / chunks, c = (it - g * chunks) * 32 + lane;
      if (c >= nc) continue;
      const int q0 = q_lo + 4 * g, m = min(4, q_hi - q0 + 1);
      const float* col = A + (c_lo - pox + pco + c) + (2 * q0 - 2 - poy) * ps;
      float* vcol = V + (q0 - q_lo) * nc + c;
      float x[11];
#pragma unroll
      for (int j = 0; j < 11; ++j) x[j] = j < 2 * m + 3 ? col[j * ps] : 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < m) {
          float v = __fmul_rn(wk[0], x[2 * t]);
#pragma unroll
          for (int j = 1; j < 5; ++j)
            v = __fadd_rn(v, __fmul_rn(wk[j], x[2 * t + j]));
          vcol[t * nc] = v;
        }
      }
    }
    __syncthreads();
    // horizontal sums: level k's pixels in its region, in-image ones and
    // (below level n) the reflected ring of two the next level reads
    const int ring = k < n ? 2 : 0;
    const int r_lo = max(oy, -ring), r_hi = min(oy + rh, hk + ring) - 1;
    const int x_lo = max(ox, -ring), x_hi = min(ox + rw, wk_ + ring) - 1;
    const int own_y0 = oyn << s, own_y1 = min((oyn + T.tile_h) << s, hk);
    const int own_x0 = oxn << s, own_x1 = min((oxn + T.tile_w) << s, wk_);
    float* out = T.dst[k - 1];
    const int hchunks = (x_hi - x_lo + 32) / 32;
    for (int it = warp; it < (r_hi - r_lo + 1) * hchunks; it += nwarps) {
      const int ri = it / hchunks;
      const int r = r_lo + ri, c = x_lo + (it - ri * hchunks) * 32 + lane;
      if (c > x_hi) continue;
      const float* v = V + (fold(r, hk) - q_lo) * nc + 2 * fold(c, wk_) - 2
                       - c_lo;
      float o = __fmul_rn(wk[0], v[0]);
#pragma unroll
      for (int j = 1; j < 5; ++j) o = __fadd_rn(o, __fmul_rn(wk[j], v[j]));
      if (k < n) A[(r - oy) * rw + (c - ox)] = o;
      if (r >= own_y0 && r < own_y1 && c >= own_x0 && c < own_x1)
        out[(long)r * wk_ + c] = o;
    }
    __syncthreads();
    poy = oy;
    pox = ox;
    prh = rh;
    prw = rw;
    pco = 0;
    ps = rw;
    ph = hk;
    pw = wk_;
  }
}

template <int kThreads>
int launch(const Table& t, int tiles, int smem, cudaStream_t s) {
  static kh::SmemGrant grant;     // per device, under a lock (common.cuh)
  const cudaError_t e = grant.allow(pyr_levels_kernel<kThreads>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  pyr_levels_kernel<kThreads><<<tiles, kThreads, smem, s>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src (h, w) f32 -> levels 1 .. n (n <= kMaxLevels) into ptrs[0 .. n-1]
// (device pointers, in a host array); table (host): tile_h, tile_w,
// tiles_x, tiles, vec, a_floats, b_floats, threads (256, 512 or 1024),
// then h, w of levels 1 .. n (the wrapper's pyr_plan).
KH_API int kh_pyr_down_levels(const void* src, int h, int w, int n,
                              const unsigned long long* ptrs,
                              const int* table, void* stream) {
  if (n < 1 || n > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  t.src = static_cast<const float*>(src);
  t.n = n;
  t.h[0] = h;
  t.w[0] = w;
  t.tile_h = table[0];
  t.tile_w = table[1];
  t.tiles_x = table[2];
  const int tiles = table[3];
  t.vec = table[4];
  t.a_floats = table[5];
  t.b_floats = table[6];
  const int threads = table[7];
  for (int k = 1; k <= n; ++k) {
    t.dst[k - 1] = reinterpret_cast<float*>(ptrs[k - 1]);
    t.h[k] = table[6 + 2 * k];
    t.w[k] = table[7 + 2 * k];
  }
  const int smem = static_cast<int>(sizeof(float)) *
                   (t.a_floats + t.b_floats) +
                   static_cast<int>(sizeof(int)) *
                   (((t.tile_h + 3) << n) - 3);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (threads) {
    case 256: return launch<256>(t, tiles, smem, s);
    case 512: return launch<512>(t, tiles, smem, s);
    case 1024: return launch<1024>(t, tiles, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
