// The fused tile body of one Farneback iteration in shared memory, and
// the one-launch-per-iteration kernel over frame pairs built on it, shared
// by K2/K6 (csrc/flow_iter.cu), K13 (csrc/flow_iters_pipe.cu) and
// K8/K8-pairs (csrc/flow_update.cu).
//
// A block of kTileThreads threads owns an output tile of TH x TW pixels at
// (r0, c0) and runs the three steps of csrc/flow_iter.cuh on it without
// sending M or its vertical pass to device memory:
//   1. M (5 f32 planes) on the tile plus a bw = taps / 2 halo on every
//      side, into shared memory: MH = TH + 2 bw rows of MW = TW + 2 bw
//      columns, row stride S = MW | 1 (odd, so that 32 rows read in one
//      warp hit 32 banks). M comes from the tile body's MSrc: the
//      select-sum warp clamped to +-D (SelectSumM: K2, K6, K13) or the
//      exact bilinear gather, M rounded to bf16 or not (ExactM: K8,
//      K8-pairs). A halo row or column outside the image holds M of the
//      clamped row or column (rounded too): the window's replicate
//      border on M. Each thread
//      computes two pixels at a time, so that their chains of dependent
//      loads (the flow, then the warp's rows, then R1) overlap. R0, R1
//      and the flow are read through L1, which the block's 73 KB of
//      shared memory (two blocks an SM) leaves at ~90 KB for the gathers
//      of R1. This phase takes most of a tile's time; staging R1 or the
//      flow in shared memory, or sharing the warp's vertical lerp between
//      pixels there, was slower for K2 (less L1, fewer blocks an SM;
//      PERF.md).
//   2. The vertical window over the TH output rows x MW columns, in
//      place: one thread per (column, plane) walks the column top down,
//      and output row o overwrites M row o once no later output needs it
//      (output o reads rows o ... o + 2 bw; rows below o are never read
//      again by this thread, and no other thread touches this column and
//      plane). With the taps known at compile time (TAPS > 0) the sums
//      of TAPS consecutive outputs stay in a register ring and each M
//      value is read once; otherwise each output reads its taps.
//   3. The horizontal window and the 2x2 solve on the TH x TW pixels: one
//      thread per (row, RH consecutive columns), lanes on consecutive rows
//      (conflict-free with the odd stride), the RH sums in registers, each
//      Mv value read once per thread. The flow goes out through shared
//      memory, one coalesced row at a time, masked at the image edge.
// Every sum runs its taps in the order k = 0 ... taps - 1 through
// flow_iter.cuh's tap(), and every M value comes from warp_m or exact_m,
// so a tile computes the (5, h, w)-plane kernels' values bit for bit.
//
// The window's taps are passed by value (Window, in the kernel's
// parameter space): with TAPS > 0 each tap is a constant operand of its
// multiply-add; the generic path reads a copy in shared memory, or, past
// kMaxTaps taps, the window's copy in device memory.
//
// Windows wider than the 32 x 64 tile's shared memory allows (winsize >
// 61) take a smaller tile (kernels/flow_iter.py::tile_plan picks the
// first of kShapes whose M fits one block); where none fits (winsize >=
// 101) the iteration keeps M and its vertical pass in device memory
// (three launches, one thread a pixel; mem_* below), each sum in the same
// tap order as the tile body, so every route gives the same values.
#pragma once

#include "flow_iter.cuh"

namespace kh {
namespace fi {

constexpr int kTileThreads = 256;
constexpr int kTileH = 32;       // the tile K2, K6, K8 and K13 launch:
constexpr int kTileW = 64;       // kernels/flow_iter.py::TILE
constexpr int kMaxTaps = 61;     // taps by value: the 32 x 64 tile's most

// The tiles of the pairs kernel (K2, K6, K8, K8-pairs) and K13, largest
// first (kernels/flow_iter.py::TILES): shape 0 is kTileH x kTileW.
constexpr int kShapes = 5;
__host__ __device__ constexpr int tile_h_of(int s) {
  return s == 0 ? 32 : s <= 2 ? 16 : 8;
}
__host__ __device__ constexpr int tile_w_of(int s) {
  return s <= 1 ? 64 : s == 2 ? 32 : s == 3 ? 16 : 8;
}

struct Window {
  float w[kMaxTaps];
  int taps;
  float post;
  const float* wd;   // all taps in device memory (taps > kMaxTaps), or null
};

// The window's taps, in HOST memory (and, past kMaxTaps, in device memory
// too: wts_dev), into a launch's Window.
inline Window make_window(const void* wts, int taps, float post,
                          const void* wts_dev = nullptr) {
  Window win;
  for (int k = 0; k < kMaxTaps; ++k)
    win.w[k] = k < taps ? static_cast<const float*>(wts)[k] : 0.f;
  win.taps = taps;
  win.post = post;
  win.wd = static_cast<const float*>(wts_dev);
  return win;
}

// Whether a Window can be launched: past kMaxTaps its taps must be in
// device memory.
inline bool window_ok(int taps, const void* wts_dev) {
  return taps > 0 && (taps <= kMaxTaps || wts_dev != nullptr);
}

// Phase 1's source of M at one pixel (r, c), into m[5]: the select-sum
// warp clamped to +-D (K2, K6, K13) ...
//
// K2's band mode: the planes and the flow are rows of an image img_h rows
// tall, their row 0 the image's row row0 (negative where the slab starts
// above the image). The taper then reads the image's rows, and M at a slab
// row outside the image is M at the image's edge row within the slab,
// rows [max(0, -row0), min(h - 1, img_h - 1 - row0)] (the reference's
// row_fix at image rows). The tile body asks for M at rows clamped to
// [0, h - 1] and the device-memory route at the slab's rows; clamping
// those again to the image's rows gives M's replicate border at the
// image's edges, on every route. A full frame (row0 = 0, img_h = h: K2,
// K6, K13) leaves both as they were: the slab is the image.
struct SelectSumM {
  static constexpr bool kPreferL1 = false;    // see launch_pairs
  float D;
  int row0;
  int img_h;
  template <typename PT>
  __device__ __forceinline__ void operator()(const PT* __restrict__ R0,
                                             const PT* __restrict__ R1,
                                             const float* flow, int h,
                                             int w, int r, int c,
                                             float m[5]) const {
    r = clampi(r, max(0, -row0), min(h - 1, img_h - 1 - row0));
    warp_m(R0, R1, PlaneFlow{flow, w, (long)h * w}, h, w, D, r, c, m, row0,
           img_h);
  }
};

// ... or the exact bilinear gather, M rounded to bf16 where round_m (K8,
// K8-pairs).
struct ExactM {
  static constexpr bool kPreferL1 = true;
  int round_m;
  template <typename PT>
  __device__ __forceinline__ void operator()(const PT* __restrict__ R0,
                                             const PT* __restrict__ R1,
                                             const float* flow, int h,
                                             int w, int r, int c,
                                             float m[5]) const {
    exact_m(R0, R1, flow, h, w, round_m, r, c, m);
  }
};

// Dynamic shared memory of one tile: M, 5 f32 planes of MH x S. The
// wrapper's plan computes the same number and passes it in; a mismatch is
// refused.
__host__ __device__ constexpr int tile_smem_bytes(int th, int tw, int bw) {
  return static_cast<int>(sizeof(float)) * 5 * (th + 2 * bw) *
         ((tw + 2 * bw) | 1);
}

// Output columns per thread in phase 3: enough that one pass covers the
// tile with kTileThreads threads, at most 8.
__host__ __device__ constexpr int tile_rh(int th, int tw) {
  return th * tw / kTileThreads >= 8 ? 8
         : th * tw / kTileThreads >= 1 ? th * tw / kTileThreads : 1;
}

template <int TH, int TW, int TAPS, typename MSrc, typename PT>
__device__ __forceinline__ void tile_body(
    const PT* __restrict__ R0, const PT* __restrict__ R1, const float* flow,
    int h, int w, const MSrc& msrc, const Window& win, int r0, int c0,
    float* out, float* sm, float* s_w) {
  constexpr int RH = tile_rh(TH, TW);
  static_assert(TW % RH == 0, "tile width must split into RH columns");
  const int taps = TAPS > 0 ? TAPS : win.taps;
  const int bw = taps / 2;
  const int MH = TH + 2 * bw, MW = TW + 2 * bw, S = MW | 1;
  const int plane_s = MH * S;      // one M plane in shared memory
  const int tid = threadIdx.x;
  const long plane = (long)h * w;
  // the generic path's taps: the shared copy, or past kMaxTaps the
  // window's device copy (read after phase 1's barriers)
  const float* wt = taps > kMaxTaps ? win.wd : s_w;
  if (TAPS == 0 && taps <= kMaxTaps) {
    for (int k = tid; k < taps; k += kTileThreads) s_w[k] = win.w[k];
  }

  // 1. M on the tile and its halo, two pixels a thread at a time
#pragma unroll 2
  for (int i = tid; i < MH * MW; i += kTileThreads) {
    const int y = i / MW, x = i - y * MW;
    float m[5];
    msrc(R0, R1, flow, h, w, clampi(r0 - bw + y, 0, h - 1),
         clampi(c0 - bw + x, 0, w - 1), m);
#pragma unroll
    for (int p = 0; p < 5; ++p) sm[p * plane_s + y * S + x] = m[p];
  }
  __syncthreads();

  // 2. vertical window, in place: Mv row o into M row o
  for (int i = tid; i < 5 * MW; i += kTileThreads) {
    const int p = i / MW, x = i - p * MW;
    float* col = sm + p * plane_s + x;
    if constexpr (TAPS > 0) {
      float acc[TAPS];
#pragma unroll
      for (int m = 0; m < TH + TAPS - 1; ++m) {
        const float v = col[m * S];
#pragma unroll
        for (int k = 0; k < TAPS; ++k) {
          const int o = m - k;            // the output tap k of row m feeds
          if (o < 0 || o >= TH) continue;
          if (k == 0) acc[o % TAPS] = 0.f;
          tap(acc[o % TAPS], win.w[k], v);
        }
        const int o = m - (TAPS - 1);     // complete now
        if (o >= 0) col[o * S] = acc[o % TAPS];
      }
    } else {
      for (int o = 0; o < TH; ++o) {
        float acc = 0.f;
        for (int k = 0; k < taps; ++k) tap(acc, wt[k], col[(o + k) * S]);
        col[o * S] = acc;
      }
    }
  }
  __syncthreads();

  // 3. horizontal window and solve: RH outputs of one row per item
  constexpr int kItems = TH * (TW / RH);
  constexpr int kRounds = (kItems + kTileThreads - 1) / kTileThreads;
  float uv[kRounds][2][RH];
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {
    const int i = tid + rd * kTileThreads;
    if (kItems % kTileThreads != 0 && i >= kItems) break;
    const int y = i % TH, x0 = (i / TH) * RH;
    const float* row = sm + y * S + x0;     // Mv row y, from column x0
    float g[RH][5];
    if constexpr (TAPS > 0) {
#pragma unroll
      for (int m = 0; m < RH + TAPS - 1; ++m) {
        float v[5];
#pragma unroll
        for (int p = 0; p < 5; ++p) v[p] = row[p * plane_s + m];
#pragma unroll
        for (int o = 0; o < RH; ++o) {
          const int k = m - o;
          if (k < 0 || k >= TAPS) continue;
#pragma unroll
          for (int p = 0; p < 5; ++p) {
            if (k == 0) g[o][p] = 0.f;
            tap(g[o][p], win.w[k], v[p]);
          }
        }
      }
    } else {
#pragma unroll
      for (int o = 0; o < RH; ++o)
#pragma unroll
        for (int p = 0; p < 5; ++p) g[o][p] = 0.f;
      for (int m = 0; m < RH + taps - 1; ++m) {
        float v[5];
#pragma unroll
        for (int p = 0; p < 5; ++p) v[p] = row[p * plane_s + m];
#pragma unroll
        for (int o = 0; o < RH; ++o) {
          const int k = m - o;
          if (k < 0 || k >= taps) continue;
          const float wk = wt[k];
#pragma unroll
          for (int p = 0; p < 5; ++p) tap(g[o][p], wk, v[p]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < RH; ++o)
      solve(g[o], win.post, &uv[rd][0][o], &uv[rd][1][o]);
  }
  __syncthreads();

  // the flow through shared memory (2 planes of TH x (TW + 1)), coalesced
  constexpr int SO = TW + 1;
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {
    const int i = tid + rd * kTileThreads;
    if (kItems % kTileThreads != 0 && i >= kItems) break;
    const int y = i % TH, x0 = (i / TH) * RH;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int o = 0; o < RH; ++o)
        sm[(q * TH + y) * SO + x0 + o] = uv[rd][q][o];
  }
  __syncthreads();
  for (int i = tid; i < 2 * TH * TW; i += kTileThreads) {
    const int q = i / (TH * TW), yx = i - q * (TH * TW);
    const int y = yx / TW, x = yx - y * TW;
    const int r = r0 + y, c = c0 + x;
    if (r < h && c < w)
      out[q * plane + (long)r * w + c] = sm[(q * TH + y) * SO + x];
  }
}

// Work item q of K13's skewed order over one level -> (j, b, t): items
// by s = b + skew * j, then by j, then by t, for n_iters iterations of nb
// bands of nt tiles (K13, and K5 within each level it walks).
// kernels/flow_iter.py::pipe_items is its Python twin.
__device__ inline void pipe_item(int q, int n_iters, int nb, int nt,
                                 int skew, int* j_out, int* b_out,
                                 int* t_out) {
  for (int s = 0;; ++s) {
    // the j with 0 <= s - skew * j < nb
    const int j0 = s < nb ? 0 : (s - nb + skew) / skew;
    const int j1 = min(n_iters - 1, s / skew);
    const int n = j1 >= j0 ? (j1 - j0 + 1) * nt : 0;
    if (q < n) {
      *j_out = j0 + q / nt;
      *b_out = s - skew * *j_out;
      *t_out = q % nt;
      return;
    }
    q -= n;
  }
}

// One iteration for `pairs` frame pairs of a plane stack in ONE launch,
// grid = (column tiles, row tiles, pairs), one block per TH x TW output
// tile (32 x 64 up to 61 taps): pair b reads R0 and R1 offset by its first frame p = b + b / ppc
// when ppc (pairs per clip) chains clips end to end, else p = b, in place
// (R1 = R0 + 5hw for a stack; any two planes for one pair), and its own
// flow and output. K2/K6 run it with SelectSumM, K8/K8-pairs with ExactM.
template <int TH, int TW, int TAPS, typename MSrc, typename PT>
__global__ void __launch_bounds__(kTileThreads, 2)
pairs_tile_kernel(const PT* __restrict__ R0, const PT* __restrict__ R1,
                  int ppc, const float* __restrict__ flow, int h, int w,
                  const MSrc msrc, const Window win,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float s_w[kMaxTaps];
  const int b = blockIdx.z;
  const long plane = (long)h * w;
  const long f = (ppc > 0 ? b + b / ppc : b) * 5 * plane;
  tile_body<TH, TW, TAPS>(
      R0 + f, R1 + f, flow + b * 2 * plane, h, w, msrc, win,
      blockIdx.y * TH, blockIdx.x * TW, out + b * 2 * plane, sm, s_w);
}

template <int TH, int TW, int TAPS, typename MSrc, typename PT>
int launch_pairs(const void* R0, const void* R1, int pairs, int ppc,
                 const float* flow, int h, int w, const MSrc& msrc,
                 const Window& win, int smem, float* out, cudaStream_t s) {
  auto kern = pairs_tile_kernel<TH, TW, TAPS, MSrc, PT>;
  if (smem != tile_smem_bytes(TH, TW, win.taps / 2) || cdiv(h, TH) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // with kPreferL1 the carveout holds two blocks of `smem` (with their
  // static shared memory and the 1 KB reserved a block), so that the rest
  // of the SM's 256 KB stays L1 for the gathers: at the default carveout,
  // K8's kernel (72 registers, so three blocks an SM would fit) ran slower
  // on scattered gathers (PERF.md)
  static SmemGrant grant;
  const cudaError_t err = grant.allow(
      kern, smem, MSrc::kPreferL1 ? 2L * (smem + 1024 + 4 * kMaxTaps) : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(w, TW), cdiv(h, TH), pairs);
  kern<<<grid, kTileThreads, smem, s>>>(
      static_cast<const PT*>(R0), static_cast<const PT*>(R1), ppc, flow, h,
      w, msrc, win, out);
  return static_cast<int>(cudaGetLastError());
}

// launch_pairs with the planes' type and the window's build: the 32 x 64
// tile (shape 0) at 15 taps (every configuration's winsize) at compile
// time or any other count generic, a smaller tile (shape 1 ... 4, past
// 61 taps) generic.
template <typename MSrc, typename PT>
int run_pairs_t(const void* R0, const void* R1, int pairs, int ppc,
                const float* f, int h, int w, const MSrc& msrc,
                const Window& win, int shape, int smem, float* o,
                cudaStream_t s) {
  switch (shape) {
    case 0:
      return win.taps == 15
                 ? launch_pairs<32, 64, 15, MSrc, PT>(R0, R1, pairs, ppc, f,
                                                      h, w, msrc, win, smem,
                                                      o, s)
                 : launch_pairs<32, 64, 0, MSrc, PT>(R0, R1, pairs, ppc, f,
                                                     h, w, msrc, win, smem,
                                                     o, s);
    case 1:
      return launch_pairs<16, 64, 0, MSrc, PT>(R0, R1, pairs, ppc, f, h, w,
                                               msrc, win, smem, o, s);
    case 2:
      return launch_pairs<16, 32, 0, MSrc, PT>(R0, R1, pairs, ppc, f, h, w,
                                               msrc, win, smem, o, s);
    case 3:
      return launch_pairs<8, 16, 0, MSrc, PT>(R0, R1, pairs, ppc, f, h, w,
                                              msrc, win, smem, o, s);
    case 4:
      return launch_pairs<8, 8, 0, MSrc, PT>(R0, R1, pairs, ppc, f, h, w,
                                             msrc, win, smem, o, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// M in device memory, for a window no tile's shared memory holds: one
// thread a pixel of a pair in each of three launches, M = (pairs, 5, h, w)
// and Mv (the same) f32 in `scratch`. Each sum runs its taps in the tile
// body's order (the vertical window over rows r - bw ... r + bw, clamped:
// the replicate border on M; then the horizontal one likewise), so the
// values are the tile body's.
template <typename MSrc, typename PT>
__global__ void __launch_bounds__(kTileThreads)
mem_m_kernel(const PT* __restrict__ R0, const PT* __restrict__ R1, int ppc,
             const float* __restrict__ flow, int h, int w, const MSrc msrc,
             float* __restrict__ M) {
  const long plane = (long)h * w;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const int b = blockIdx.y, r = static_cast<int>(i / w);
  const int c = static_cast<int>(i - (long)r * w);
  const long f = (ppc > 0 ? b + b / ppc : b) * 5 * plane;
  float m[5];
  msrc(R0 + f, R1 + f, flow + b * 2 * plane, h, w, r, c, m);
#pragma unroll
  for (int p = 0; p < 5; ++p) M[(b * 5L + p) * plane + i] = m[p];
}

static __global__ void __launch_bounds__(kTileThreads)
mem_vpass_kernel(const float* __restrict__ M, int h, int w,
                 const float* __restrict__ wt, int taps,
                 float* __restrict__ Mv) {
  const long plane = (long)h * w;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const int r = static_cast<int>(i / w);
  const int c = static_cast<int>(i - (long)r * w), bw = taps / 2;
  const float* src = M + blockIdx.y * plane;
  float acc = 0.f;
  for (int k = 0; k < taps; ++k)
    tap(acc, __ldg(wt + k),
        src[(long)clampi(r - bw + k, 0, h - 1) * w + c]);
  Mv[blockIdx.y * plane + i] = acc;
}

static __global__ void __launch_bounds__(kTileThreads)
mem_hpass_kernel(const float* __restrict__ Mv, int h, int w,
                 const float* __restrict__ wt, int taps, float post,
                 float* __restrict__ out) {
  const long plane = (long)h * w;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const int r = static_cast<int>(i / w);
  const int c = static_cast<int>(i - (long)r * w), bw = taps / 2;
  const float* src = Mv + blockIdx.y * 5 * plane + (long)r * w;
  float g[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < taps; ++k) {
    const float wk = __ldg(wt + k);
    const int x = clampi(c - bw + k, 0, w - 1);
#pragma unroll
    for (int p = 0; p < 5; ++p) tap(g[p], wk, src[p * plane + x]);
  }
  float u, v;
  solve(g, post, &u, &v);
  out[blockIdx.y * 2 * plane + i] = u;
  out[(blockIdx.y * 2 + 1) * plane + i] = v;
}

template <typename MSrc, typename PT>
int run_mem(const void* R0, const void* R1, int pairs, int ppc,
            const float* f, int h, int w, const MSrc& msrc,
            const Window& win, float* scratch, float* o, cudaStream_t s) {
  const long plane = (long)h * w;
  if (!win.wd || !scratch) return static_cast<int>(cudaErrorInvalidValue);
  float* M = scratch;
  float* Mv = scratch + (long)pairs * 5 * plane;
  const unsigned blocks = cdiv(plane, kTileThreads);
  mem_m_kernel<MSrc, PT><<<dim3(blocks, pairs), kTileThreads, 0, s>>>(
      static_cast<const PT*>(R0), static_cast<const PT*>(R1), ppc, f, h, w,
      msrc, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mem_vpass_kernel<<<dim3(blocks, 5 * pairs), kTileThreads, 0, s>>>(
      M, h, w, win.wd, win.taps, Mv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mem_hpass_kernel<<<dim3(blocks, pairs), kTileThreads, 0, s>>>(
      Mv, h, w, win.wd, win.taps, win.post, o);
  return static_cast<int>(cudaGetLastError());
}

// One iteration over the pairs with the planes' type (bf16 = 1, else
// f32): on tile `shape` (kShapes, with `smem` its plan's bytes) or, at
// shape -1, with M in device memory (`scratch`, (2, pairs, 5, h, w) f32).
template <typename MSrc>
int run_pairs(const void* R0, const void* R1, int bf16, int pairs, int ppc,
              const void* flow, int h, int w, const MSrc& msrc,
              const Window& win, int shape, int smem, void* scratch,
              void* out, cudaStream_t s) {
  auto f = static_cast<const float*>(flow);
  auto o = static_cast<float*>(out);
  auto sc = static_cast<float*>(scratch);
  if (shape < 0)
    return bf16 ? run_mem<MSrc, __nv_bfloat16>(R0, R1, pairs, ppc, f, h, w,
                                               msrc, win, sc, o, s)
                : run_mem<MSrc, float>(R0, R1, pairs, ppc, f, h, w, msrc,
                                       win, sc, o, s);
  if (shape >= kShapes || (shape > 0 && win.taps <= kMaxTaps))
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? run_pairs_t<MSrc, __nv_bfloat16>(R0, R1, pairs, ppc, f, h,
                                                 w, msrc, win, shape, smem,
                                                 o, s)
              : run_pairs_t<MSrc, float>(R0, R1, pairs, ppc, f, h, w, msrc,
                                         win, shape, smem, o, s);
}

}  // namespace fi
}  // namespace kh
