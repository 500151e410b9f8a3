// K5: every Farneback iteration of every gated coarse level of a frame
// pair in ONE launch, the flow's resize between the levels included.
//
// Replaces kalman_hydra_tpu/kernels/flow_level_pallas.py::flow_level
// (_flow_level_kernel), which runs one level's iterations a launch, and
// the resize glue between the gated levels (ops/farneback.py's
// resize_linear(...) * (1 / pyr_scale)). Its math is `iters` applications
// of K2 a level (no shift skip, which is exact), each level's prior the
// coarser level's result resized: every work item runs K2's own tile
// body (csrc/flow_tile.cuh with the select-sum warp), so a level equals
// `iters` K2 launches bit for bit, and the resize is computed as torch's
// eager ops compute it, each step rounded on its own.
//
// Bound on Hopper: latency, not bytes or FLOPs. A 1080p frame pair's four
// gated levels (34x60 ... 270x480) must move 36 B/px at bf16 (6.2 MB,
// 1.85 us at 3.35 TB/s); the FLOPs take ~1.1 us. What costs is the chain
// of 12 dependent iterations over levels of 2,040 to 129,600 pixels. The
// first design (a cooperative grid a level, K2's three per-pixel phases
// over the level with a grid-wide barrier after each: 36 barriers and 4
// launches a pair, M and its vertical pass in device memory, the resize as
// ~a dozen torch launches between levels) spent ~30 us a level, most of
// its blocks waiting at the barriers of small levels. This walk still
// runs ~90x its byte bound: each of its 12 steps costs one tile body's
// chain of dependent loads (phase 1: the flow, then the warp's rows of
// R1) and a progress word's release and acquire (PERF.md).
//
// Design (K13's, carried over the level walk): work items (level l,
// iteration j, band b, tile t) in one launch of one block an item, no
// grid barrier. Each level is cut into the smallest tiles (8 x 8, 8 x 16
// or 16 x 32) of which one iteration fits the blocks the card holds at
// once (three an SM), 16 x 32 where none does: a step's latency falls with
// the pixels of M a thread computes, and one iteration runs in one wave
// (at 1080p 40, 135, 255 and 255 blocks for 34x60 ... 270x480);
// kernels/flow_level.py::walk_plan computes the plan. Each block claims
// one item from a global ticket, in an order in which every item's inputs
// come from smaller tickets: level by level, coarsest first, and within a
// level K13's skewed order (pipe_item: by s = b + skew j, then j, then t)
// at skew = max(1, db, nb), which is iteration after iteration (a skew of
// 1, a wavefront over the bands, took one step a band). Item (l, j, b, t)
// runs the tile body on tile (b, t) of level l from the flow of
// iteration j - 1 into iteration j's flow. M at (r, c)
// reads the prior flow on row r at columns c - D ... c + D + 1, and the
// tile's M spans its rows and columns +- bw, so the item waits until
// iteration j - 1 has published bands b - db ... b + db (db = cdiv(bw,
// th)) and tiles t - dt ... t + dt (dt = cdiv(bw + D + 1, tw)). A level's
// first iteration (l > 0) reads its prior through the resize of level l -
// 1's last flow (ResizedFlow: cv2 INTER_LINEAR, rows, then columns, then
// the scale), so it waits until level l - 1 has published the tiles that
// the resize reads for its rows and columns. A per-tile progress word
// holds the iterations done, stored with release semantics by the
// writer's thread 0 after a __syncthreads, spun on with acquire loads by
// one reader thread per word before a __syncthreads.
//
// Why this cannot deadlock. A block takes its ticket only once it runs, so
// every claimed ticket is held by a resident block, and tickets are handed
// out in increasing order. Item (l, j, b, t) waits only on items of level
// l - 1 (smaller tickets: the order is level by level) or on items (l, j -
// 1, b', t') with b' <= b + db, whose s' = b' + skew (j - 1) <= s + db -
// skew <= s, and at s' = s their j - 1 < j: smaller tickets. The smallest
// unfinished claimed ticket therefore waits on nothing unfinished and runs
// to its end; by induction every item does. No cooperative launch is
// needed. The ticket and the progress words are cleared with
// cudaMemsetAsync on the launch's stream before every launch.
//
// Memory. Each iteration of each level writes its own full-level (2, lh,
// lw) buffer (the finest level's last one is `out`), so no item
// overwrites a flow another still reads. M and its vertical pass live in
// the block's shared memory only; the resize never reaches device memory
// (staging each tile's prior flow in shared memory first, resized there
// once, measured slower). `flow_level` is this walk over one level.
#include <cuda/atomic>


#include "flow_tile.cuh"

namespace {

using kh::fi::kTileThreads;
using kh::fi::Window;

constexpr int kMaxLevels = 8;

// The tile shapes of the walk: 16 x 32, 8 x 16 and 8 x 8.
constexpr int kShapes = 3;
__host__ __device__ constexpr int shape_h(int s) { return s == 0 ? 16 : 8; }
__host__ __device__ constexpr int shape_w(int s) {
  return s == 0 ? 32 : s == 1 ? 16 : 8;
}

struct WalkLevel {
  const void* R0;
  const void* R1;
  float* flows;      // iteration j's flow at flows + j * 2 h w
  // the resize from level l - 1 (l > 0), cv2 INTER_LINEAR's coefficients:
  // row r reads coarse rows y0[r] (weight 1 - fy[r]) and y1[r] (fy[r]),
  // column c coarse columns x0[c] and x1[c] likewise
  const int* y0;
  const int* y1;
  const float* fy;
  const int* x0;
  const int* x1;
  const float* fx;
  int h, w, shape, nb, nt, db, dt, skew, item0, prog0;
};

struct Walk {
  WalkLevel lv[kMaxLevels];
  const float* prior;    // (2, h, w) of level 0
  float* out;            // (2, h, w) of the last level
  int levels, iters;
  float D, scale;        // max_disp; 1 / pyr_scale, rounded to f32
};

// Level l's prior at (r, c), resized on the fly from level l - 1's last
// flow `cf` ((2, ch, cw)): statement for statement ops/pyramid.py::
// resize_linear, then the multiply by `scale`, each product and sum
// rounded on its own (torch's eager ops; never a fused multiply-add).
struct ResizedFlow {
  const float* cf;
  int cw;
  long cplane;
  const int *y0, *y1, *x0, *x1;       // the level's WalkLevel tables
  const float *fy, *fx;
  float scale;
  __device__ __forceinline__ float at(long off, int r, int c) const {
    const float* a = cf + off + (long)y0[r] * cw;
    const float* b = cf + off + (long)y1[r] * cw;
    const float wy = fy[r], vy = __fsub_rn(1.f, wy);
    const float wx = fx[c], vx = __fsub_rn(1.f, wx);
    const int c0 = x0[c], c1 = x1[c];
    const float r0 = __fadd_rn(__fmul_rn(a[c0], vy), __fmul_rn(b[c0], wy));
    const float r1 = __fadd_rn(__fmul_rn(a[c1], vy), __fmul_rn(b[c1], wy));
    return __fmul_rn(__fadd_rn(__fmul_rn(r0, vx), __fmul_rn(r1, wx)), scale);
  }
  __device__ __forceinline__ float dx(int r, int c) const {
    return at(0, r, c);
  }
  __device__ __forceinline__ float dy(int r, int c) const {
    return at(cplane, r, c);
  }
};

// Phase 1's M: the select-sum warp on the flow planes the tile body is
// given, or, for a level's first iteration after the coarsest, on the
// resized prior (a branch uniform over the block).
struct WalkM {
  float D;
  bool resized;
  ResizedFlow rf;
  template <typename PT>
  __device__ __forceinline__ void operator()(const PT* __restrict__ R0,
                                             const PT* __restrict__ R1,
                                             const float* flow, int h,
                                             int w, int r, int c,
                                             float m[5]) const {
    if (resized)
      kh::fi::warp_m(R0, R1, rf, h, w, D, r, c, m, 0, h);
    else
      kh::fi::warp_m(R0, R1, kh::fi::PlaneFlow{flow, w, (long)h * w}, h, w,
                     D, r, c, m, 0, h);
  }
};

// Dynamic shared memory of shape s's tile and its bw halo; a launch's
// blocks take that of the largest shape that fits one block
// (kernels/flow_level.py::walk_smem), and its plan uses no larger shape.
__host__ __device__ constexpr int shape_smem(int s, int bw) {
  return kh::fi::tile_smem_bytes(shape_h(s), shape_w(s), bw);
}

// Spin until progress word p holds at least `want` (acquire).
__device__ __forceinline__ void wait_for(int* p, int want) {
  cuda::atomic_ref<int, cuda::thread_scope_device> a(*p);
  while (a.load(cuda::memory_order_acquire) < want) __nanosleep(64);
  __threadfence();
}

// Three blocks an SM (80 registers): faster than two for 720p's walk,
// whose two finer levels have more tiles than two blocks an SM hold.
template <int TAPS, typename PT>
__global__ void __launch_bounds__(kTileThreads, 3)
flow_walk_kernel(const __grid_constant__ Walk wk, const Window win,
                 int* counters) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float s_w[kh::fi::kMaxTaps];
  __shared__ int s_item[4];
  int* progress = counters + 1;
  if (threadIdx.x == 0) {
    const int q = atomicAdd(counters, 1);
    int l = 0;
    while (l + 1 < wk.levels && q >= wk.lv[l + 1].item0) ++l;
    const WalkLevel& L = wk.lv[l];
    s_item[0] = l;
    kh::fi::pipe_item(q - L.item0, wk.iters, L.nb, L.nt, L.skew,
                      &s_item[1], &s_item[2], &s_item[3]);
  }
  __syncthreads();
  const int l = s_item[0], j = s_item[1], b = s_item[2], t = s_item[3];
  const WalkLevel& L = wk.lv[l];
  const int h = L.h, w = L.w;
  const int th = shape_h(L.shape), tw = shape_w(L.shape);
  const int bw = win.taps / 2, D = static_cast<int>(wk.D);
  if (j > 0) {
    // iteration j - 1 of bands b - db ... b + db, tiles t - dt ... t + dt
    const int b0 = max(0, b - L.db), b1 = min(L.nb - 1, b + L.db);
    const int t0 = max(0, t - L.dt), t1 = min(L.nt - 1, t + L.dt);
    const int ntw = t1 - t0 + 1;
    for (int i = threadIdx.x; i < (b1 - b0 + 1) * ntw; i += blockDim.x)
      wait_for(progress + L.prog0 + (b0 + i / ntw) * L.nt + t0 + i % ntw, j);
  } else if (l > 0) {
    // level l - 1's last iteration on the tiles the resize reads for the
    // flow this tile's M reads: rows r_lo ... r_hi (M's, +- bw), columns
    // c_lo ... c_hi (M's, and its warp's -D ... D + 1)
    const WalkLevel& C = wk.lv[l - 1];
    const int cth = shape_h(C.shape), ctw = shape_w(C.shape);
    const int r_lo = max(0, b * th - bw);
    const int r_hi = min(h - 1, b * th + th - 1 + bw);
    const int c_lo = max(0, t * tw - bw - D);
    const int c_hi = min(w - 1, t * tw + tw + bw + D);
    const int b0 = L.y0[r_lo] / cth, b1 = L.y1[r_hi] / cth;
    const int t0 = L.x0[c_lo] / ctw, t1 = L.x1[c_hi] / ctw;
    const int ntw = t1 - t0 + 1;
    for (int i = threadIdx.x; i < (b1 - b0 + 1) * ntw; i += blockDim.x)
      wait_for(progress + C.prog0 + (b0 + i / ntw) * C.nt + t0 + i % ntw,
               wk.iters);
  }
  __syncthreads();
  const long plane = (long)h * w;
  const float* src = j > 0 ? L.flows + (long)(j - 1) * 2 * plane : wk.prior;
  float* dst = l == wk.levels - 1 && j == wk.iters - 1
                   ? wk.out : L.flows + (long)j * 2 * plane;
  WalkM msrc{wk.D, j == 0 && l > 0, {}};
  if (msrc.resized) {
    const WalkLevel& C = wk.lv[l - 1];
    msrc.rf = ResizedFlow{C.flows + (long)(wk.iters - 1) * 2 * C.h * C.w,
                          C.w, (long)C.h * C.w, L.y0, L.y1, L.x0, L.x1,
                          L.fy, L.fx, wk.scale};
  }
  const PT* R0 = static_cast<const PT*>(L.R0);
  const PT* R1 = static_cast<const PT*>(L.R1);
  if (L.shape == 0)
    kh::fi::tile_body<shape_h(0), shape_w(0), TAPS>(
        R0, R1, src, h, w, msrc, win, b * th, t * tw, dst, sm, s_w);
  else if (L.shape == 1)
    kh::fi::tile_body<shape_h(1), shape_w(1), TAPS>(
        R0, R1, src, h, w, msrc, win, b * th, t * tw, dst, sm, s_w);
  else
    kh::fi::tile_body<shape_h(2), shape_w(2), TAPS>(
        R0, R1, src, h, w, msrc, win, b * th, t * tw, dst, sm, s_w);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    cuda::atomic_ref<int, cuda::thread_scope_device> p(
        progress[L.prog0 + b * L.nt + t]);
    p.store(j + 1, cuda::memory_order_release);
  }
}

template <int TAPS, typename PT>
int launch(const Walk& wk, const Window& win, int items, int words,
           int smem, int* counters, cudaStream_t s) {
  static kh::SmemGrant grant;
  auto kern = flow_walk_kernel<TAPS, PT>;
  cudaError_t err = grant.allow(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(counters, 0, sizeof(int) * (1 + (long)words), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<items, kTileThreads, smem, s>>>(wk, win, counters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The walk over `levels` gated levels, coarsest first. ptrs (host, 9 a
// level): R0, R1 ((5, h, w) bf16 [bf16 = 1] or f32), the level's flow
// buffers (iters x (2, h, w) f32; iters - 1 for the last level), and for
// l > 0 the resize's y0, y1 (int32, h), fy (f32, h), x0, x1 (int32, w), fx
// (f32, w) on the device. dims (host, 10 a level; kernels/flow_level.py::
// walk_plan): h, w, shape (0: 16 x 32 tiles, 1: 8 x 16, 2: 8 x 8), nb,
// nt, db, dt, skew, first ticket, first progress word. prior (2, h, w)
// of level 0; wts (taps,) f32 in HOST memory and, past 61 taps, in
// device memory too (wts_dev, else null); scale = 1 / pyr_scale; smem,
// the dynamic shared memory of one block (kernels/flow_level.py::
// walk_smem: at least every level's shape's); counters (1 + the
// progress words) int32; out (2, h, w) f32 of the last level.
KH_API int kh_flow_levels(int levels, const unsigned long long* ptrs,
                          const int* dims, int bf16, const void* prior,
                          int D, const void* wts, const void* wts_dev,
                          int taps, float post_scale, int iters, float scale,
                          int smem, void* counters, void* out,
                          void* stream) {
  if (levels < 1 || levels > kMaxLevels ||
      !kh::fi::window_ok(taps, wts_dev) || D < 0 || iters < 1 ||
      smem > 232448 - 4 * kh::fi::kMaxTaps - 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Walk wk{};
  wk.levels = levels;
  wk.iters = iters;
  wk.prior = static_cast<const float*>(prior);
  wk.out = static_cast<float*>(out);
  wk.D = static_cast<float>(D);
  wk.scale = scale;
  long items = 0, words = 0;
  for (int l = 0; l < levels; ++l) {
    const unsigned long long* p = ptrs + 9 * l;
    const int* d = dims + 10 * l;
    WalkLevel& L = wk.lv[l];
    L.R0 = reinterpret_cast<const void*>(p[0]);
    L.R1 = reinterpret_cast<const void*>(p[1]);
    L.flows = reinterpret_cast<float*>(p[2]);
    L.y0 = reinterpret_cast<const int*>(p[3]);
    L.y1 = reinterpret_cast<const int*>(p[4]);
    L.fy = reinterpret_cast<const float*>(p[5]);
    L.x0 = reinterpret_cast<const int*>(p[6]);
    L.x1 = reinterpret_cast<const int*>(p[7]);
    L.fx = reinterpret_cast<const float*>(p[8]);
    L.h = d[0]; L.w = d[1]; L.shape = d[2]; L.nb = d[3]; L.nt = d[4];
    L.db = d[5]; L.dt = d[6]; L.skew = d[7]; L.item0 = d[8]; L.prog0 = d[9];
    if (L.h <= 0 || L.w <= 0 || L.shape < 0 || L.shape >= kShapes ||
        L.nb != static_cast<int>(kh::cdiv(L.h, shape_h(L.shape))) ||
        L.nt != static_cast<int>(kh::cdiv(L.w, shape_w(L.shape))) ||
        L.skew < 1 || L.skew < L.db || L.item0 != items ||
        smem < shape_smem(L.shape, taps / 2) ||
        L.prog0 != words ||
        (l > 0 && !(L.y0 && L.y1 && L.fy && L.x0 && L.x1 && L.fx)))
      return static_cast<int>(cudaErrorInvalidValue);
    items += (long)iters * L.nb * L.nt;
    words += (long)L.nb * L.nt;
  }
  if (items > 2147483647L) return static_cast<int>(cudaErrorInvalidValue);
  const Window win = kh::fi::make_window(wts, taps, post_scale, wts_dev);
  auto c = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(items), nw = static_cast<int>(words);
  if (bf16)
    return taps == 15
               ? launch<15, __nv_bfloat16>(wk, win, n, nw, smem, c, s)
               : launch<0, __nv_bfloat16>(wk, win, n, nw, smem, c, s);
  return taps == 15 ? launch<15, float>(wk, win, n, nw, smem, c, s)
                    : launch<0, float>(wk, win, n, nw, smem, c, s);
}
