// K3 and K7a: Farneback polynomial expansion, (H, W) f32 -> (5, H, W) f32
// or bf16, for one frame (K3) or a stack of N frames (K7a).
//
// Replaces kalman_hydra_tpu/kernels/polyexp_pallas.py::poly_expansion_planar
// (_polyexp_kernel / _pe_compute) and ::poly_expansion_planar_batch
// (_polyexp_batch_kernel): 9 separable Gaussian-moment
// correlations with a replicate border (vertical g, xg, xxg taps, then six
// horizontal moments), combined through the inverse-Gram scalars
// ig11/ig03/ig33/ig55 into [b_x, b_y, a_xx, a_yy, axy].
//
// Bound on Hopper: memory, by the count; in practice the instructions. At
// 1080p a frame reads 8 MB and writes 20 MB (bf16): 8.7 us at 3.35 TB/s.
// The function's ~110 multiply-adds a pixel (3 vertical and 6 horizontal
// moments of 2n + 1 taps each, at n = 5) take ~0.25 ms for 36 frames at
// the f32 rate, near the 0.31 ms of their bytes. The first design (one
// 16 x 64 tile a block) read each tap from shared memory beside its
// datum: ~120 shared loads a pixel, which bounded it (1.31 ms for 36
// frames; PERF.md).
//
// Design (one instantiation for each odd poly_n <= 7;
// kernels/polyexp.py::polyexp_plan; any other odd n takes the generic
// build at the end of this file): one 32 x 64 output tile a block of
// 256 threads, four blocks an SM (three at f32 outputs), the taps
// compile-time operands (PolyTaps in the launch's parameter space, each
// an operand of its multiply-add), the frame blockIdx.z.
//   1. The (32 + 2n) x 80 input tile (columns c0 - 8 ... c0 + 71) into
//      shared memory as 16-byte loads, rows clamped to the image (the
//      replicate border); a chunk that crosses the image's left or right
//      edge, a width that is not a multiple of 4 or a frame that does
//      not start on a 16-byte boundary loads by clamped element.
//   2. Vertical taps: one thread a (column, 8-row segment) walks down
//      its column with the sums of its 2n + 1 outputs in flight in a
//      register ring (3 moments each), so each input value is read from
//      shared memory once and feeds 3 (2n + 1) multiply-adds; the three
//      moment planes go to shared memory (odd row stride).
//   3. Horizontal taps: one thread a (row, 8 consecutive columns), lanes
//      on consecutive rows (conflict-free at the odd stride), the 8
//      outputs' six moments in registers, each vertical sum read once;
//      the five planes are formed and rounded to the output type, then
//      staged in shared memory (over the dead input tile) as 16-byte
//      vectors.
//   4. The planes go out as 16-byte vectors, consecutive lanes on
//      consecutive columns (a 64-column row is one 128-byte line in bf16),
//      element by element at a ragged edge or an unaligned width.
// About 20 words of shared memory a pixel move, against ~110
// multiply-adds; the kernel runs at ~2.5x the multiply-adds' time at the
// f32 rate (PERF.md). Writing the planes from registers straight to
// device memory, 16 bytes a lane on 32 rows, measured slower than
// staging them. Every output sums its vertical taps k = 0 ... 2n and
// then its horizontal taps k = 0 ... 2n, one multiply-add each, exactly
// as the first design (and K4/K7b's polyexp.cuh::polyexp_tile) does, and
// forms the planes with the same expressions, so the bytes are
// unchanged. K3 is K7a with one frame, the same kernel, so a batched
// launch equals its per-frame launches bit for bit.
#include <cstdint>

#include "polyexp.cuh"

namespace {

using kh::clampi;
using kh::PolyTaps;

constexpr int kThreads = 256;

// The tile (kernels/polyexp.py::polyexp_plan is its Python twin).
constexpr int kTH = 32;            // output rows of a tile
constexpr int kTW = 64;            // output columns
constexpr int kSeg = 8;            // rows of one vertical item
constexpr int kRH = 8;             // columns of one horizontal item
constexpr int kPad = 8;            // input columns staged left of c0
constexpr int kNMax = 7;           // the largest n: kPad >= n
constexpr int kIP = kTW + 2 * kPad;    // input row stride (floats)

__host__ __device__ constexpr int vs_stride(int n) {
  return (kTW + 2 * n) | 1;
}
// Output staging row stride in elements: 16-byte rows that fall on 8
// different bank groups for 8 consecutive rows.
__host__ __device__ constexpr int out_stride(int out_bytes) {
  return out_bytes == 2 ? kTW + 8 : kTW + 4;
}
__host__ __device__ constexpr int in_floats(int n) {
  return (kTH + 2 * n) * kIP;
}
__host__ __device__ constexpr int stage_floats(int out_bytes) {
  return 5 * kTH * out_stride(out_bytes) * out_bytes / 4;
}
// Dynamic shared memory of one block: the input tile, later the output
// staging over it, then the three vertical-moment planes.
__host__ __device__ constexpr int tile_smem(int n, int out_bytes) {
  return 4 * ((in_floats(n) > stage_floats(out_bytes)
                   ? in_floats(n) : stage_floats(out_bytes)) +
              3 * kTH * vs_stride(n));
}

// Eight consecutive outputs into 16-byte aligned shared memory, rounded
// to the output type (bf16 to nearest even, as torch's .to(bfloat16)).
__device__ __forceinline__ void put8(const float (&v)[kRH], float* p) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a at the low
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ void put8(const float (&v)[kRH],
                                     __nv_bfloat16* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}

// Four blocks an SM with bf16 outputs (64 registers; n = 7 spills a few
// bytes; faster than three), three with f32 (whose 72 KB of shared
// memory allow no more).
template <typename OutT, int kN>
__global__ void __launch_bounds__(kThreads, sizeof(OutT) == 2 ? 4 : 3)
polyexp_tiled_kernel(const float* __restrict__ src, int h, int w,
                     const PolyTaps t, OutT* __restrict__ out) {
  static_assert(kN % 2 == 1 && kN <= kNMax, "odd n within the pad");
  constexpr int kTaps = 2 * kN + 1;
  constexpr int kVW = kTW + 2 * kN;          // vertical-moment columns
  constexpr int kVS = vs_stride(kN);
  constexpr int kOS = out_stride(sizeof(OutT));
  constexpr int kInRows = kTH + 2 * kN;
  extern __shared__ __align__(16) float sm[];
  float* tile = sm;                          // kInRows x kIP
  OutT* stage = reinterpret_cast<OutT*>(sm); // 5 x kTH x kOS, after 2.
  float* vs = sm + (in_floats(kN) > stage_floats(sizeof(OutT))
                        ? in_floats(kN) : stage_floats(sizeof(OutT)));
  const long plane = (long)h * w;
  src += blockIdx.z * plane;
  out += blockIdx.z * 5 * plane;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;

  // 1. input rows r0 - n ... r0 + kTH + n - 1, columns c0 - 8 ... c0 + 71
  // (16-byte loads where every row starts on a 16-byte boundary: a
  // contiguous view may start anywhere)
  const bool vec_in =
      (w & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int i = tid; i < kInRows * (kIP / 4); i += kThreads) {
    const int rr = i / (kIP / 4), q = i - rr * (kIP / 4);
    const float* row = src + (long)clampi(r0 + rr - kN, 0, h - 1) * w;
    const int c = c0 - kPad + 4 * q;
    float4 v;
    if (vec_in && c >= 0 && c + 3 < w) {
      v = __ldg(reinterpret_cast<const float4*>(row + c));
    } else {
      v.x = __ldg(row + clampi(c, 0, w - 1));
      v.y = __ldg(row + clampi(c + 1, 0, w - 1));
      v.z = __ldg(row + clampi(c + 2, 0, w - 1));
      v.w = __ldg(row + clampi(c + 3, 0, w - 1));
    }
    *reinterpret_cast<float4*>(tile + rr * kIP + 4 * q) = v;
  }
  __syncthreads();

  // 2. vertical taps: item (column x, segment) -> output rows
  // seg * kSeg ... + kSeg - 1 of the three moment planes at column x
  // (input column c0 - n + x)
  for (int i = tid; i < kVW * (kTH / kSeg); i += kThreads) {
    const int sg = i / kVW, x = i - sg * kVW;
    const float* col = tile + sg * kSeg * kIP + x + (kPad - kN);
    float* v0 = vs + sg * kSeg * kVS + x;
    float a0[kTaps], a1[kTaps], a2[kTaps];   // output o at o % kTaps
#pragma unroll
    for (int m = 0; m < kSeg + 2 * kN; ++m) {
      const float s = col[m * kIP];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int o = m - k;                   // the output tap k feeds
        if (o < 0 || o >= kSeg) continue;
        const int slot = o % kTaps;
        if (k == 0) {
          a0[slot] = 0.f;
          a1[slot] = 0.f;
          a2[slot] = 0.f;
        }
        a0[slot] = __fmaf_rn(t.g[k], s, a0[slot]);
        a1[slot] = __fmaf_rn(t.xg[k], s, a1[slot]);
        a2[slot] = __fmaf_rn(t.xxg[k], s, a2[slot]);
      }
      const int o = m - 2 * kN;                // complete now
      if (o >= 0) {
        v0[o * kVS] = a0[o % kTaps];
        v0[kTH * kVS + o * kVS] = a1[o % kTaps];
        v0[2 * kTH * kVS + o * kVS] = a2[o % kTaps];
      }
    }
  }
  __syncthreads();

  // 3. horizontal taps: item (row y, columns x0 ... x0 + 7), one round
  static_assert(kTH * (kTW / kRH) == kThreads, "one horizontal round");
  {
    const int y = tid % kTH, x0 = (tid / kTH) * kRH;
    const float* ra = vs + y * kVS + x0;
    float m00[kRH], m10[kRH], m20[kRH], m01[kRH], m11[kRH], m02[kRH];
#pragma unroll
    for (int m = 0; m < kRH + 2 * kN; ++m) {
      const float a = ra[m], b = ra[kTH * kVS + m],
                  d = ra[2 * kTH * kVS + m];
#pragma unroll
      for (int o = 0; o < kRH; ++o) {
        const int k = m - o;
        if (k < 0 || k >= kTaps) continue;
        if (k == 0) {
          m00[o] = m10[o] = m20[o] = m01[o] = m11[o] = m02[o] = 0.f;
        }
        m00[o] = __fmaf_rn(t.g[k], a, m00[o]);
        m10[o] = __fmaf_rn(t.xg[k], a, m10[o]);
        m20[o] = __fmaf_rn(t.xxg[k], a, m20[o]);
        m01[o] = __fmaf_rn(t.g[k], b, m01[o]);
        m11[o] = __fmaf_rn(t.xg[k], b, m11[o]);
        m02[o] = __fmaf_rn(t.g[k], d, m02[o]);
      }
    }
    // the five planes, formed as polyexp_tile forms them, staged as
    // 16-byte vectors (the input tile is dead since the barrier)
    OutT* st = stage + y * kOS + x0;
    float p[kRH];
#pragma unroll
    for (int o = 0; o < kRH; ++o) p[o] = m10[o] * t.ig11;
    put8(p, st);
#pragma unroll
    for (int o = 0; o < kRH; ++o) p[o] = m01[o] * t.ig11;
    put8(p, st + kTH * kOS);
#pragma unroll
    for (int o = 0; o < kRH; ++o) p[o] = m00[o] * t.ig03 + m20[o] * t.ig33;
    put8(p, st + 2 * kTH * kOS);
#pragma unroll
    for (int o = 0; o < kRH; ++o) p[o] = m00[o] * t.ig03 + m02[o] * t.ig33;
    put8(p, st + 3 * kTH * kOS);
#pragma unroll
    for (int o = 0; o < kRH; ++o) p[o] = m11[o] * t.ig55;
    put8(p, st + 4 * kTH * kOS);
  }
  __syncthreads();

  // 4. out: 16-byte chunks, consecutive lanes along a row
  constexpr int kPer = 16 / sizeof(OutT);      // elements a chunk
  constexpr int kChunks = kTW / kPer;          // a row
  const bool vec_out = w % kPer == 0;   // out is the wrapper's, aligned
  for (int i = tid; i < 5 * kTH * kChunks; i += kThreads) {
    const int pr = i / kChunks, q = i - pr * kChunks;
    const int p = pr / kTH, y = pr - p * kTH;
    const int r = r0 + y, c = c0 + q * kPer;
    if (r >= h || c >= w) continue;
    const OutT* s = stage + pr * kOS + q * kPer;
    OutT* d = out + p * plane + (long)r * w + c;
    if (vec_out && c + kPer <= w) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < kPer && c + e < w; ++e) d[e] = s[e];
    }
  }
}

template <typename OutT, int kN>
int launch_tiled(const float* src, int frames, int h, int w,
                 const PolyTaps& t, int smem, OutT* out, cudaStream_t s) {
  static kh::SmemGrant grant;
  auto kern = polyexp_tiled_kernel<OutT, kN>;
  if (smem != tile_smem(kN, sizeof(OutT)) || kh::cdiv(h, kTH) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = grant.allow(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(kh::cdiv(w, kTW), kh::cdiv(h, kTH), frames);
  kern<<<grid, kThreads, smem, s>>>(src, h, w, t, out);
  return static_cast<int>(cudaGetLastError());
}

// The generic build, for an odd n with no compiled instantiation (cv2
// documents 5 and 7; the reference takes any odd n): the same 32 x 64
// tile, its halo sized from n, the taps read from device memory into
// shared memory. One thread an output: its vertical sums over the
// (32 + 2n) x (64 + 2n) input tile into the three moment planes (odd row
// stride), then its horizontal sums and the five planes, stored straight
// to device memory. Each sum runs its taps in order, one multiply-add
// each, with the planes formed as polyexp_tile forms them. Its bound and
// its use are those of the compiled builds; it is right first, not fast:
// each tap is a shared-memory load beside its datum.
__host__ __device__ constexpr int generic_smem(int n) {
  return 4 * ((kTH + 2 * n) * (kTW + 2 * n) + 3 * kTH * ((kTW + 2 * n) | 1) +
              3 * (2 * n + 1));
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
polyexp_generic_kernel(const float* __restrict__ src, int h, int w,
                       const PolyTaps t, const float* __restrict__ taps_dev,
                       OutT* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int n = t.n, taps = 2 * n + 1, iw = kTW + 2 * n, vw = iw | 1;
  float* tile = sm;                        // (kTH + 2n) x iw
  float* vs = tile + (kTH + 2 * n) * iw;   // 3 x kTH x vw
  float* tg = vs + 3 * kTH * vw;           // g, xg, xxg
  const long plane = (long)h * w;
  src += blockIdx.z * plane;
  out += blockIdx.z * 5 * plane;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  for (int k = tid; k < 3 * taps; k += kThreads) tg[k] = taps_dev[k];
  for (int i = tid; i < (kTH + 2 * n) * iw; i += kThreads) {
    const int rr = i / iw, cc = i - rr * iw;
    tile[i] = __ldg(src + (long)clampi(r0 + rr - n, 0, h - 1) * w +
                    clampi(c0 + cc - n, 0, w - 1));
  }
  __syncthreads();
  for (int i = tid; i < kTH * iw; i += kThreads) {
    const int rr = i / iw, cc = i - rr * iw;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    for (int k = 0; k < taps; ++k) {
      const float s = tile[(rr + k) * iw + cc];
      v0 = __fmaf_rn(tg[k], s, v0);
      v1 = __fmaf_rn(tg[taps + k], s, v1);
      v2 = __fmaf_rn(tg[2 * taps + k], s, v2);
    }
    vs[rr * vw + cc] = v0;
    vs[(kTH + rr) * vw + cc] = v1;
    vs[(2 * kTH + rr) * vw + cc] = v2;
  }
  __syncthreads();
  for (int i = tid; i < kTH * kTW; i += kThreads) {
    const int rr = i / kTW, cc = i - rr * kTW;
    const int r = r0 + rr, c = c0 + cc;
    if (r >= h || c >= w) continue;
    float m00 = 0.f, m10 = 0.f, m20 = 0.f, m01 = 0.f, m11 = 0.f, m02 = 0.f;
    for (int k = 0; k < taps; ++k) {
      const float a = vs[rr * vw + cc + k];
      const float b = vs[(kTH + rr) * vw + cc + k];
      const float d = vs[(2 * kTH + rr) * vw + cc + k];
      const float g = tg[k], xg = tg[taps + k];
      m00 = __fmaf_rn(g, a, m00);
      m10 = __fmaf_rn(xg, a, m10);
      m20 = __fmaf_rn(tg[2 * taps + k], a, m20);
      m01 = __fmaf_rn(g, b, m01);
      m11 = __fmaf_rn(xg, b, m11);
      m02 = __fmaf_rn(g, d, m02);
    }
    const long o = (long)r * w + c;
    kh::store(out + o, m10 * t.ig11);
    kh::store(out + plane + o, m01 * t.ig11);
    kh::store(out + 2 * plane + o, m00 * t.ig03 + m20 * t.ig33);
    kh::store(out + 3 * plane + o, m00 * t.ig03 + m02 * t.ig33);
    kh::store(out + 4 * plane + o, m11 * t.ig55);
  }
}

template <typename OutT>
int launch_generic(const float* src, int frames, int h, int w,
                   const PolyTaps& t, const float* taps_dev, int smem,
                   OutT* out, cudaStream_t s) {
  static kh::SmemGrant grant;
  auto kern = polyexp_generic_kernel<OutT>;
  if (!taps_dev || smem != generic_smem(t.n) || smem > 232448 ||
      kh::cdiv(h, kTH) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = grant.allow(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(kh::cdiv(w, kTW), kh::cdiv(h, kTH), frames);
  kern<<<grid, kThreads, smem, s>>>(src, h, w, t, taps_dev, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int run(const float* src, int frames, int h, int w, const PolyTaps& t,
        const float* taps_dev, int smem, OutT* out, cudaStream_t s) {
  switch (t.n) {
    case 1: return launch_tiled<OutT, 1>(src, frames, h, w, t, smem, out, s);
    case 3: return launch_tiled<OutT, 3>(src, frames, h, w, t, smem, out, s);
    case 5: return launch_tiled<OutT, 5>(src, frames, h, w, t, smem, out, s);
    case 7: return launch_tiled<OutT, 7>(src, frames, h, w, t, smem, out, s);
    default:
      return launch_generic<OutT>(src, frames, h, w, t, taps_dev, smem, out,
                                  s);
  }
}

// The device-memory route, for an odd n past the shared-memory plans
// (kernels/polyexp.py::polyexp_route: n > POLY_N_MAX, where K4/K7b's
// level tile no longer fits half a block; the reference takes any odd
// n), for one image stack (K3/K7a) or for every coarse level of one
// (K4/K7b, after K11's level images), each level's blocks found in a
// table through blockIdx.x as K4's fused launch finds them. Two passes:
//   1. vertical: the three moment planes of every pixel, g, xg and xxg
//      over rows r - n ... r + n, into a (frames, w, pitch) scratch of
//      float4 {g, xg, xxg, 0} sums (pitch = h rounded up to kMemR):
//      transposed and interleaved, so that the horizontal pass walks its
//      taps down contiguous memory, one 16-byte load a tap;
//   2. horizontal: the six moments over columns c - n ... c + n of those
//      planes, then the five planes, rounded once to the output type at
//      the store.
// Bound on Hopper: the operations (18 (2n + 1) + 7 FLOPs a pixel; 7.6 GFLOP a
// 1080p frame at n = 101, 0.113 ms at 67 TFLOP/s f32); the scratch's round
// trip is 32 bytes a pixel (~20 us a 1080p frame). The first design (commit
// 91c9116: one thread a pixel) loaded a datum and its taps beside every 3
// (vertical) or 6 (horizontal) multiply-adds, bound by load issue near a
// quarter of the multiply-add rate. Here each thread takes kMemR consecutive
// outputs of one column (vertical) or one row (horizontal) and keeps the last
// kMemR source values in a register window that moves one row (column) a tap,
// its slots renamed at compile time over a run of kMemR taps: a tap costs one
// new load and one 16-byte broadcast of {g, xg, xxg} from shared memory for 3
// kMemR (6 kMemR) multiply-adds, and offsets are 32-bit (a clamped index, a
// multiply, an address; a 64-bit index costs a 64-bit multiply a load). The
// source is read through L1, not staged: a warp's 32 lanes take 32 consecutive
// columns (vertical) or rows (horizontal, in the transposed scratch), and the
// block's warps, kMemR outputs apart, read the same lines within ~64 taps of
// each other (a few KB of L1), whatever n; staging would take 2n + 64 rows of
// shared memory. The taps go to shared memory kMemTapChunk at a time, so no n
// is too large for a block. On an H100 it runs at about half the
// multiply-add rate at a 1080p frame (tools/torch_polyexp_mem_ab.py,
// PERF.md). A clamped index is the plain version's replicate pad at every
// index, also where 2n + 1 exceeds a level. Each output sums its taps k = 0
// ... 2n in order, one multiply-add each, and forms the planes as the first
// design did, so the bytes are that design's.
constexpr int kMemR = 8;              // outputs a thread
constexpr int kMemWarps = 8;          // warps a block
constexpr int kMemSpan = kMemR * kMemWarps;   // rows (1.) or columns (2.)
constexpr int kMemThreads = 32 * kMemWarps;
constexpr int kMemMaxLevels = 16;     // levels a launch
constexpr int kMemTapChunk = 512;     // taps in shared memory at a time
static_assert(kMemR == kRH, "put8 stores kMemR outputs");
static_assert(kMemTapChunk % kMemR == 0, "whole runs of taps a chunk");

struct MemLevel {
  const float* src;   // (frames, h, w) f32
  float4* vs;         // (frames, w, pitch) {g, xg, xxg, 0} sums
  void* out;          // (frames, 5, h, w) f32 or bf16
  int h, w, pitch;
  int v_block0, h_block0;   // the level's first block in each pass
};

struct MemPlan {
  MemLevel lv[kMemMaxLevels];
  const float4* taps;       // (2n + 1) x {g, xg, xxg, 0}
  float ig11, ig03, ig33, ig55;
  int n, levels;
};

__device__ __forceinline__ int mem_level(const MemPlan& p, int block,
                                         bool vertical) {
  int li = 0;
  while (li + 1 < p.levels &&
         block >= (vertical ? p.lv[li + 1].v_block0
                            : p.lv[li + 1].h_block0))
    ++li;
  return li;
}

// Taps k0 ... k0 + kMemTapChunk - 1 (fewer at the end) into st; returns
// the end of the chunk. Every thread of the block calls it.
__device__ __forceinline__ int stage_taps(const float4* __restrict__ taps,
                                          int k0, int T, float4* st) {
  const int kn = min(T, k0 + kMemTapChunk);
  __syncthreads();                    // the last chunk's readers are done
  for (int k = k0 + threadIdx.x; k < kn; k += kMemThreads)
    st[k - k0] = __ldg(taps + k);
  __syncthreads();
  return kn;
}

// Pass 1: a block covers 32 columns x kMemSpan rows; lane = column, warp
// = kMemR consecutive rows. A thread past the level's edge runs the taps
// on its clamped column and rows (it meets stage_taps' barriers) and
// stores nothing.
__global__ void __launch_bounds__(kMemThreads, 2)
polyexp_mem_v_kernel(const MemPlan p) {
  __shared__ float4 st[kMemTapChunk];
  const MemLevel& L = p.lv[mem_level(p, blockIdx.x, true)];
  const int h = L.h, w = L.w, frame = blockIdx.y;
  const int b = blockIdx.x - L.v_block0, bx_n = (w + 31) / 32;
  const int by = b / bx_n, bx = b - by * bx_n;
  const int c = bx * 32 + (threadIdx.x & 31);
  const int rb = by * kMemSpan + (threadIdx.x >> 5) * kMemR;
  const float* col = L.src + (long)frame * h * w + min(c, w - 1);
  const int T = 2 * p.n + 1, top = rb - p.n, hm = h - 1;  // tap 0's row
  auto ld = [&](int r) { return __ldg(col + clampi(r, 0, hm) * w); };
  float a0[kMemR], a1[kMemR], a2[kMemR], win[kMemR];
#pragma unroll
  for (int j = 0; j < kMemR; ++j) a0[j] = a1[j] = a2[j] = 0.f;
  // win[s] holds row top + k + s at the start of a run of taps k ...
  // k + kMemR - 1 (s < kMemR - 1); before tap k + i, the slot of row
  // top + k + i - 1, dead since, takes row top + k + i + kMemR - 1
#pragma unroll
  for (int s = 0; s < kMemR - 1; ++s) win[s] = ld(top + s);
  for (int k0 = 0; k0 < T; k0 += kMemTapChunk) {
    const int kn = stage_taps(p.taps, k0, T, st);
    int k = k0;
    for (; k + kMemR <= kn; k += kMemR) {
#pragma unroll
      for (int i = 0; i < kMemR; ++i) {
        win[(i + kMemR - 1) % kMemR] = ld(top + k + i + kMemR - 1);
        const float4 t = st[k - k0 + i];
#pragma unroll
        for (int j = 0; j < kMemR; ++j) {
          const float s = win[(i + j) % kMemR];   // row top + k + i + j
          a0[j] = __fmaf_rn(t.x, s, a0[j]);
          a1[j] = __fmaf_rn(t.y, s, a1[j]);
          a2[j] = __fmaf_rn(t.z, s, a2[j]);
        }
      }
    }
    for (; k < kn; ++k) {                 // the last T % kMemR taps
      const float4 t = st[k - k0];
#pragma unroll
      for (int j = 0; j < kMemR; ++j) {
        const float s = ld(top + k + j);
        a0[j] = __fmaf_rn(t.x, s, a0[j]);
        a1[j] = __fmaf_rn(t.y, s, a1[j]);
        a2[j] = __fmaf_rn(t.z, s, a2[j]);
      }
    }
  }
  if (c >= w || rb >= h) return;
  // rows rb ... rb + kMemR - 1 < pitch of column c
  float4* o = L.vs + ((long)frame * w + c) * L.pitch + rb;
#pragma unroll
  for (int j = 0; j < kMemR; ++j) o[j] = make_float4(a0[j], a1[j], a2[j], 0.f);
}

// kMemR outputs of a row, `valid` of them inside it: one 16-byte (bf16)
// or two (f32) stores where `vec`, else element by element.
template <typename OutT>
__device__ __forceinline__ void mem_store(OutT* d, const float (&v)[kMemR],
                                          bool vec, int valid) {
  if (vec) {
    put8(v, d);
    return;
  }
#pragma unroll
  for (int j = 0; j < kMemR; ++j)
    if (j < valid) kh::store(d + j, v[j]);
}

// Pass 2: a block covers 32 rows x kMemSpan columns; lane = row, warp =
// kMemR consecutive columns; a thread past the edge as in pass 1.
template <typename OutT>
__global__ void __launch_bounds__(kMemThreads, 2)
polyexp_mem_h_kernel(const MemPlan p) {
  __shared__ float4 st[kMemTapChunk];
  const MemLevel& L = p.lv[mem_level(p, blockIdx.x, false)];
  const int h = L.h, w = L.w, frame = blockIdx.y;
  const int b = blockIdx.x - L.h_block0;
  const int bx_n = (w + kMemSpan - 1) / kMemSpan;
  const int by = b / bx_n, bx = b - by * bx_n;
  const int r = by * 32 + (threadIdx.x & 31);
  const int cb = bx * kMemSpan + (threadIdx.x >> 5) * kMemR;
  const float4* base = L.vs + (long)frame * w * L.pitch + min(r, h - 1);
  const int T = 2 * p.n + 1, left = cb - p.n, wm = w - 1, pitch = L.pitch;
  float wa[kMemR], wb[kMemR], wd[kMemR];
  auto ld = [&](int x, int s) {
    const float4 v = __ldg(base + clampi(x, 0, wm) * pitch);
    wa[s] = v.x;
    wb[s] = v.y;
    wd[s] = v.z;
  };
  float m00[kMemR], m10[kMemR], m20[kMemR], m01[kMemR], m11[kMemR],
      m02[kMemR];
#pragma unroll
  for (int j = 0; j < kMemR; ++j)
    m00[j] = m10[j] = m20[j] = m01[j] = m11[j] = m02[j] = 0.f;
  // the window of pass 1, over columns, for the three planes at once
#pragma unroll
  for (int s = 0; s < kMemR - 1; ++s) ld(left + s, s);
  for (int k0 = 0; k0 < T; k0 += kMemTapChunk) {
    const int kn = stage_taps(p.taps, k0, T, st);
    int k = k0;
    for (; k + kMemR <= kn; k += kMemR) {
#pragma unroll
      for (int i = 0; i < kMemR; ++i) {
        ld(left + k + i + kMemR - 1, (i + kMemR - 1) % kMemR);
        const float4 t = st[k - k0 + i];
#pragma unroll
        for (int j = 0; j < kMemR; ++j) {
          const int s = (i + j) % kMemR;        // column left + k + i + j
          m00[j] = __fmaf_rn(t.x, wa[s], m00[j]);
          m10[j] = __fmaf_rn(t.y, wa[s], m10[j]);
          m20[j] = __fmaf_rn(t.z, wa[s], m20[j]);
          m01[j] = __fmaf_rn(t.x, wb[s], m01[j]);
          m11[j] = __fmaf_rn(t.y, wb[s], m11[j]);
          m02[j] = __fmaf_rn(t.x, wd[s], m02[j]);
        }
      }
    }
    for (; k < kn; ++k) {                 // the last T % kMemR taps
      const float4 t = st[k - k0];
#pragma unroll
      for (int j = 0; j < kMemR; ++j) {
        const float4 v = __ldg(base + clampi(left + k + j, 0, wm) * pitch);
        m00[j] = __fmaf_rn(t.x, v.x, m00[j]);
        m10[j] = __fmaf_rn(t.y, v.x, m10[j]);
        m20[j] = __fmaf_rn(t.z, v.x, m20[j]);
        m01[j] = __fmaf_rn(t.x, v.y, m01[j]);
        m11[j] = __fmaf_rn(t.y, v.y, m11[j]);
        m02[j] = __fmaf_rn(t.x, v.z, m02[j]);
      }
    }
  }
  if (r >= h || cb >= w) return;
  // the five planes, formed as the first design formed them; 16-byte
  // stores where the row allows (w a multiple of the vector, all kMemR
  // inside)
  const long plane = (long)h * w;
  OutT* o = static_cast<OutT*>(L.out) + frame * 5 * plane + r * w + cb;
  const int valid = min(kMemR, w - cb);
  const bool vec = w % (16 / sizeof(OutT)) == 0 && valid == kMemR;
  float v[kMemR];
#pragma unroll
  for (int j = 0; j < kMemR; ++j) v[j] = m10[j] * p.ig11;
  mem_store(o, v, vec, valid);
#pragma unroll
  for (int j = 0; j < kMemR; ++j) v[j] = m01[j] * p.ig11;
  mem_store(o + plane, v, vec, valid);
#pragma unroll
  for (int j = 0; j < kMemR; ++j) v[j] = m00[j] * p.ig03 + m20[j] * p.ig33;
  mem_store(o + 2 * plane, v, vec, valid);
#pragma unroll
  for (int j = 0; j < kMemR; ++j) v[j] = m00[j] * p.ig03 + m02[j] * p.ig33;
  mem_store(o + 3 * plane, v, vec, valid);
#pragma unroll
  for (int j = 0; j < kMemR; ++j) v[j] = m11[j] * p.ig55;
  mem_store(o + 4 * plane, v, vec, valid);
}

}  // namespace

// The device-memory route (see polyexp_mem_v_kernel): `levels` image
// stacks, each (frames, h, w) f32 -> (frames, 5, h, w), replicate border,
// at any odd n, in one launch a pass. Per level i, ptrs[2 i ..] = img,
// out and dims[2 i ..] = h, w (K3/K7a: one level; K4/K7b: the coarse
// levels of kernels/level_image.py::_launch_mem, at most kMemMaxLevels);
// taps_host = [g, xg, xxg (2n+1 each), ig11, ig03, ig33, ig55] f32 in
// host memory, taps4_dev the (2n + 1) x {g, xg, xxg, 0} f32 table in
// device memory (kernels/polyexp.py::poly_taps4); scratch f32 on the
// images' device, each level's (frames, w, pitch, 4) block after the
// last, scratch_floats its size (refused when smaller than
// kernels/polyexp.py::mem_scratch_floats); a level's frame must index in
// 32 bits (h w and 4 w pitch below 2^31). Two kernel launches, in stream
// order.
KH_API int kh_polyexp_mem(int frames, int levels,
                          const unsigned long long* ptrs, const int* dims,
                          const void* taps_host, const void* taps4_dev,
                          int n, int out_bf16, void* scratch,
                          long long scratch_floats, void* stream) {
  if (n < 1 || n % 2 == 0 || frames <= 0 || frames > 65535 ||
      levels < 1 || levels > kMemMaxLevels || !taps4_dev || !scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* th = static_cast<const float*>(taps_host);
  const int T = 2 * n + 1;
  MemPlan p{};
  p.taps = static_cast<const float4*>(taps4_dev);
  p.ig11 = th[3 * T];
  p.ig03 = th[3 * T + 1];
  p.ig33 = th[3 * T + 2];
  p.ig55 = th[3 * T + 3];
  p.n = n;
  p.levels = levels;
  float* vs = static_cast<float*>(scratch);
  long long used = 0, vblocks = 0, hblocks = 0;
  for (int i = 0; i < levels; ++i) {
    MemLevel& L = p.lv[i];
    L.src = reinterpret_cast<const float*>(ptrs[2 * i]);
    L.out = reinterpret_cast<void*>(ptrs[2 * i + 1]);
    L.h = dims[2 * i];
    L.w = dims[2 * i + 1];
    L.pitch = (L.h + kMemR - 1) / kMemR * kMemR;
    if (L.h <= 0 || L.w <= 0 || 4LL * L.w * L.pitch >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    L.vs = reinterpret_cast<float4*>(vs + used);
    used += 4LL * frames * L.w * L.pitch;
    L.v_block0 = static_cast<int>(vblocks);
    L.h_block0 = static_cast<int>(hblocks);
    vblocks += (long long)kh::cdiv(L.w, 32) * kh::cdiv(L.h, kMemSpan);
    hblocks += (long long)kh::cdiv(L.h, 32) * kh::cdiv(L.w, kMemSpan);
  }
  if (used > scratch_floats || vblocks > 0x7fffffff || hblocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 vgrid(static_cast<unsigned>(vblocks), frames);
  polyexp_mem_v_kernel<<<vgrid, kMemThreads, 0, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(hblocks), frames);
  if (out_bf16)
    polyexp_mem_h_kernel<__nv_bfloat16><<<grid, kMemThreads, 0, s>>>(p);
  else
    polyexp_mem_h_kernel<float><<<grid, kMemThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// img (frames, h, w) f32 -> out (frames, 5, h, w), replicate border, at
// an odd n; taps_host = [g, xg, xxg (2n+1 each), ig11, ig03, ig33, ig55]
// f32 in host memory, and for an n with no compiled build the same array
// in device memory (taps_dev, else null); smem the dynamic shared memory
// of one block, as kernels/polyexp.py::polyexp_plan computes it.
KH_API int kh_polyexp(const void* img, int frames, int h, int w,
                      const void* taps_host, const void* taps_dev, int n,
                      int out_bf16, int smem, void* out, void* stream) {
  if (n < 1 || n % 2 == 0 || h <= 0 || w <= 0 || frames <= 0 ||
      frames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const PolyTaps t = kh::poly_taps(static_cast<const float*>(taps_host), n);
  const float* src = static_cast<const float*>(img);
  const float* td = static_cast<const float*>(taps_dev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return run(src, frames, h, w, t, td, smem,
               static_cast<__nv_bfloat16*>(out), s);
  return run(src, frames, h, w, t, td, smem, static_cast<float*>(out), s);
}
