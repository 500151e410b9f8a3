// The lifecycle tail of a frame step: the NIS gate, kill_lost and the
// re-seeding of dead slots from the corner pool, in ONE launch.
//
// Replaces no TPU kernel: it replaces the reference's XLA glue,
// kalman_hydra_tpu/models/lifecycle.py (gate, kill_lost, reseed), which
// the port ran as ~56 eager torch ops a frame step (a (P, K) distance
// matrix, a stable argsort, a cumsum, a dozen where's) and an upload of
// the initial covariance. Its twin, kernels/lifecycle.py::
// lifecycle_tail_plain, is that chain of models/lifecycle.py itself; the
// kernel writes the same bytes into x, P, alive, misses, track_id and
// q_scale, the same decisions in the same order:
//   * gate: missed = alive & (nis > gate_chi2) in f32; x, P from the
//     prediction where missed; misses + 1 where missed, 0 where alive;
//   * kill: on the gated x, 0 <= px <= w - 1, 0 <= py <= h - 1 and
//     misses < max_misses;
//   * reseed: d2 = dx * dx + dy * dy (round-to-nearest, never a
//     contracted FMA) against f32(min_distance^2) and the killed alive
//     mask; a candidate's score counts if > 0 and near no living track,
//     else -inf; a dead slot of exclusive dead-rank d takes the d-th
//     candidate of the stable descending order (ties keep the lower
//     index) if d is below the count of finite candidates and that
//     candidate is finite: x = (pt, 0...), P = P0, alive, misses 0,
//     track_id + 1, q_scale 1.
//
// Bound on Hopper: launch latency. At K = P = 1024, n = 6 the tail moves
// ~0.54 MB (0.16 us at 3.35 TB/s); the rest is compares, scans and
// integer work, so the launch and the block's barriers are its time.
// Design: one block of 1024 threads; every phase loops over the K slots
// or the P candidates in chunks of the block; all decisions live in
// shared memory:
//   1. each slot's gate and kill (recomputed from the inputs wherever a
//      later phase needs them: the same instructions, the same result);
//      the dead slots' ranks by block scans; the living tracks binned
//      into a uniform grid of at most 65 x 65 cells, each at least 1.01
//      min_distance wide (a counting sort in shared memory);
//   2. a candidate's near-live test reads only the tracks of its 3 x 3
//      cells instead of all K: a pair with d2 < f32(min_distance^2) lies
//      at most min_distance (1 + 2^-22) apart, so its cells differ by at
//      most one on each axis (the 1% margin covers the f32 roundings of
//      d2 and of the cell index);
//   3. each candidate gets a 64-bit key, its score's order bits inverted
//      over its index, sorted ascending by a bitonic sort in shared
//      memory: the twin's stable descending argsort, ties by index;
//   4. each dead slot looks its candidate up at its rank;
//   5. x (K, n) and P (K, n, n) leave in flat coalesced loops, each
//      element from x, x_pred or the seed and from P, P_pred or P0.
// Shared memory: 8 B a candidate (P rounded up to a power of two), 12 B
// a slot and 16.9 KB of grid with a pool; 4 B a slot without one (gate
// and kill alone). That holds K and P up to 8192 each (180.7 KB of the
// 227 KB a block can take): the configurations' num_tracks (256-1024)
// and corner_pool (max(256, num_tracks)) lie far inside, and the wrapper
// raises, naming the limit, beyond it.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kGridDim = 65;                  // grid cells a side, at most
constexpr int kCells = kGridDim * kGridDim;
constexpr unsigned kNegInfHi = 0xFF800000u;   // a key's high word at -inf
constexpr unsigned kPosInfHi = 0x007FFFFFu;   // and at +inf

struct Args {
  const float* x;
  const float* P;
  const float* x_pred;
  const float* P_pred;
  const float* nis;
  const unsigned char* alive;
  const int* misses;
  const int* track_id;
  const float* q_scale;     // null: no per-track Q scale
  const float* pts;         // null: no pool (gate and kill alone)
  const float* score;
  const float* P0;
  float* xo;
  float* Po;
  unsigned char* alive_o;
  int* misses_o;
  int* track_id_o;
  float* q_scale_o;
  int K, n, Pn, max_misses;
  float gate, w1, h1, thr;
};

struct Slot {
  float px, py;
  int misses;
  bool missed, alive;
};

// A slot after the gate and kill_lost.
__device__ __forceinline__ Slot slot(const Args& a, int k) {
  Slot s;
  const bool live = a.alive[k] != 0;
  s.missed = live && a.nis[k] > a.gate;
  const float* row =
      (s.missed ? a.x_pred : a.x) + static_cast<long>(k) * a.n;
  s.px = row[0];
  s.py = row[1];
  const int m = a.misses[k];
  s.misses = s.missed ? m + 1 : (live ? 0 : m);
  s.alive = live && s.misses < a.max_misses && s.px >= 0.f &&
            s.px <= a.w1 && s.py >= 0.f && s.py <= a.h1;
  return s;
}

struct Grid {
  float inv;     // 1 / cell width
  int gx, gy;
};

__device__ __forceinline__ Grid grid(const Args& a) {
  const float cell = fmaxf(fmaxf(1.01f * sqrtf(a.thr), 1.f),
                           fmaxf(a.w1, a.h1) * (1.f / 64.f));
  Grid g;
  g.inv = 1.f / cell;
  g.gx = min(__float2int_rd(a.w1 * g.inv) + 1, kGridDim);
  g.gy = min(__float2int_rd(a.h1 * g.inv) + 1, kGridDim);
  return g;
}

// A coordinate's cell on one axis (NaN takes 0, infinities clamp).
__device__ __forceinline__ int cell_of(const Grid& g, float v, int cells) {
  return kh::clampi(__float2int_rd(__fmul_rn(v, g.inv)), 0, cells - 1);
}

// Exclusive block-wide prefix sum of v; *total is the block's sum. Every
// thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = sums[lane];
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    sums[lane] = wi - w;
    if (lane == kWarps - 1) sums[kWarps] = wi;
  }
  __syncthreads();
  *total = sums[kWarps];
  const int r = incl - v + sums[warp];
  __syncthreads();   // sums is free for the next call
  return r;
}

// Whether a living track lies within d2 < thr of (x, y): the tracks of
// the 3 x 3 cells around it (a row of three cells is one run of the
// binned positions).
__device__ __forceinline__ bool near_live(const Args& a, const Grid& g,
                                          const int* start,
                                          const float2* pos, float x,
                                          float y) {
  const int cx = cell_of(g, x, g.gx), cy = cell_of(g, y, g.gy);
  const int x0 = max(cx - 1, 0), x1 = min(cx + 1, g.gx - 1);
  for (int yy = max(cy - 1, 0); yy <= min(cy + 1, g.gy - 1); ++yy) {
    const int e = start[yy * g.gx + x1 + 1];
    for (int j = start[yy * g.gx + x0]; j < e; ++j) {
      const float2 p = pos[j];
      const float dx = __fsub_rn(x, p.x), dy = __fsub_rn(y, p.y);
      if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < a.thr)
        return true;
    }
  }
  return false;
}

// A float's bits as an unsigned that orders as the float does (no NaN).
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

__global__ void __launch_bounds__(kThreads) tail_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sums[kWarps + 1];
  __shared__ int n_finite;
  const int tid = threadIdx.x;
  const bool pool = a.pts != nullptr;
  const int n2 = pool ? pow2_at_least(a.Pn) : 0;
  auto* keys = reinterpret_cast<unsigned long long*>(smem);   // n2
  auto* pos = reinterpret_cast<float2*>(keys + n2);           // K (pool)
  int* src = reinterpret_cast<int*>(pos + (pool ? a.K : 0));  // K
  int* start = src + a.K;                                     // kCells + 1
  const bool near_test = pool && a.thr > 0.f;
  const Grid g = grid(a);
  const int cells = g.gx * g.gy;

  if (near_test)
    for (int c = tid; c <= cells; c += kThreads) start[c] = 0;
  if (tid == 0) n_finite = 0;
  __syncthreads();

  // 1. gate and kill; the dead slots' ranks; the living tracks' cells
  int dead_base = 0;
  for (int k0 = 0; pool && k0 < a.K; k0 += kThreads) {
    const int k = k0 + tid;
    int dead = 0;
    if (k < a.K) {
      const Slot s = slot(a, k);
      dead = !s.alive;
      if (near_test && s.alive)
        atomicAdd(&start[cell_of(g, s.py, g.gy) * g.gx +
                         cell_of(g, s.px, g.gx)], 1);
    }
    int total;
    const int ex = block_scan(dead, sums, &total);
    if (k < a.K) src[k] = dead ? dead_base + ex : -1;
    dead_base += total;
  }
  if (near_test) {
    __syncthreads();
    // each cell's end in the binned order; the scatter below counts each
    // down to the cell's start
    int base = 0;
    for (int c0 = 0; c0 < cells; c0 += kThreads) {
      const int c = c0 + tid;
      const int v = c < cells ? start[c] : 0;
      int total;
      const int ex = block_scan(v, sums, &total);
      if (c < cells) start[c] = base + ex + v;
      base += total;
    }
    if (tid == 0) start[cells] = base;
    __syncthreads();
    for (int k = tid; k < a.K; k += kThreads) {
      const Slot s = slot(a, k);
      if (s.alive) {
        const int c = cell_of(g, s.py, g.gy) * g.gx + cell_of(g, s.px, g.gx);
        pos[atomicSub(&start[c], 1) - 1] = make_float2(s.px, s.py);
      }
    }
    __syncthreads();
  }

  // 2-3. the candidates' scores, keys and their stable descending order
  if (pool) {
    int finite = 0;
    for (int i = tid; i < n2; i += kThreads) {
      unsigned long long key = ~0ull;       // padding sorts last
      if (i < a.Pn) {
        const float s = a.score[i];
        const bool near = s > 0.f && near_test &&
                          near_live(a, g, start, pos, a.pts[2 * i],
                                    a.pts[2 * i + 1]);
        const float cand = (s > 0.f && !near) ? s : -CUDART_INF_F;
        finite += isfinite(cand) ? 1 : 0;
        key = (static_cast<unsigned long long>(~ordered(cand)) << 32) |
              static_cast<unsigned>(i);
      }
      keys[i] = key;
    }
    finite = __reduce_add_sync(0xffffffffu, finite);
    if ((tid & 31) == 0 && finite) atomicAdd(&n_finite, finite);
    __syncthreads();
    for (int size = 2; size <= n2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < (n2 >> 1); t += kThreads) {
          const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
          const unsigned long long p = keys[lo], q = keys[hi];
          if ((p > q) == ((lo & size) == 0)) {
            keys[lo] = q;
            keys[hi] = p;
          }
        }
        __syncthreads();
      }
    }
  }

  // 4. each slot's source row and its scalar outputs
  const int nf = n_finite;
  for (int k = tid; k < a.K; k += kThreads) {
    const Slot s = slot(a, k);
    int code = s.missed ? -2 : -1;          // x_pred, P_pred : x, P
    bool fill = false;
    if (pool) {
      const int d = src[k];
      if (d >= 0 && d < nf) {
        const unsigned long long key = keys[d];
        const unsigned hi = static_cast<unsigned>(key >> 32);
        if (hi != kNegInfHi && hi != kPosInfHi) {
          fill = true;
          code = static_cast<int>(static_cast<unsigned>(key));
        }
      }
      a.track_id_o[k] = fill ? a.track_id[k] + 1 : a.track_id[k];
      if (a.q_scale) a.q_scale_o[k] = fill ? 1.f : a.q_scale[k];
    }
    src[k] = code;
    a.alive_o[k] = (s.alive || fill) ? 1 : 0;
    a.misses_o[k] = fill ? 0 : s.misses;
  }
  __syncthreads();

  // 5. the rows
  const int n = a.n, nn = n * n;
  for (int q = tid; q < a.K * n; q += kThreads) {
    const int k = q / n, j = q - k * n;
    const int c = src[k];
    a.xo[q] = c >= 0 ? (j < 2 ? a.pts[2 * c + j] : 0.f)
                     : (c == -2 ? a.x_pred[q] : a.x[q]);
  }
  for (int q = tid; q < a.K * nn; q += kThreads) {
    const int k = q / nn, j = q - k * nn;
    const int c = src[k];
    a.Po[q] = c >= 0 ? a.P0[j] : (c == -2 ? a.P_pred[q] : a.P[q]);
  }
}

// The dynamic shared memory of one launch, bytes (the wrapper's limit
// check, kernels/lifecycle.py::smem_bytes, counts the same).
long smem_bytes(int K, int Pn, bool pool) {
  if (!pool) return 4L * K;
  long n2 = 1;
  while (n2 < Pn) n2 <<= 1;
  return 8L * n2 + 12L * K + 4L * (kCells + 1);
}

}  // namespace

// x (K, n), P (K, n, n), x_pred, P_pred likewise, nis (K,) f32, alive
// (K,) bool, misses and track_id (K,) int32, q_scale (K,) f32 or null;
// pts (P, 2), score (P,) and P0 (n, n) f32, or pts null for gate and kill
// alone (then track_id_o and q_scale_o are not written). Outputs xo, Po,
// alive_o, misses_o, track_id_o and, with q_scale, q_scale_o, never the
// inputs. gate = f32(gate_chi2), w1 = w - 1, h1 = h - 1, thr =
// f32(min_distance^2).
KH_API int kh_lifecycle_tail(const void* x, const void* P,
                             const void* x_pred, const void* P_pred,
                             const void* nis, const void* alive,
                             const void* misses, const void* track_id,
                             const void* q_scale, const void* pts,
                             const void* score, const void* P0, int K,
                             int n, int Pn, float gate, int max_misses,
                             float w1, float h1, float thr, void* xo,
                             void* Po, void* alive_o, void* misses_o,
                             void* track_id_o, void* q_scale_o,
                             void* stream) {
  const bool pool = pts != nullptr;
  if (K <= 0 || n < 2 || Pn < 0 ||
      (pool && (!score || !P0 || !track_id || !track_id_o)) ||
      (pool && q_scale && !q_scale_o))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.P = static_cast<const float*>(P);
  a.x_pred = static_cast<const float*>(x_pred);
  a.P_pred = static_cast<const float*>(P_pred);
  a.nis = static_cast<const float*>(nis);
  a.alive = static_cast<const unsigned char*>(alive);
  a.misses = static_cast<const int*>(misses);
  a.track_id = static_cast<const int*>(track_id);
  a.q_scale = pool ? static_cast<const float*>(q_scale) : nullptr;
  a.pts = static_cast<const float*>(pts);
  a.score = static_cast<const float*>(score);
  a.P0 = static_cast<const float*>(P0);
  a.xo = static_cast<float*>(xo);
  a.Po = static_cast<float*>(Po);
  a.alive_o = static_cast<unsigned char*>(alive_o);
  a.misses_o = static_cast<int*>(misses_o);
  a.track_id_o = static_cast<int*>(track_id_o);
  a.q_scale_o = static_cast<float*>(q_scale_o);
  a.K = K;
  a.n = n;
  a.Pn = Pn;
  a.max_misses = max_misses;
  a.gate = gate;
  a.w1 = w1;
  a.h1 = h1;
  a.thr = thr;
  const long smem = smem_bytes(K, Pn, pool);
  static kh::SmemGrant grant;
  const cudaError_t err = grant.allow(tail_kernel, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
