// K13: all `n_iters` fine-level Farneback iterations of one level in ONE
// launch, as a skewed pipeline over output tiles.
//
// Replaces kalman_hydra_tpu/kernels/flow_iter_pallas.py::flow_iters_pipelined
// (_flow_iters_pipe_kernel). Its result is exactly `n_iters` applications
// of K2: each work item runs K2's own tile body (csrc/flow_tile.cuh, on
// the per-pixel code of csrc/flow_iter.cuh), so K13 equals n_iters K2
// launches bit for bit.
//
// Work items and their order. The level is cut into K2's tiles of TH x TW
// = 32 x 64 pixels (past 61 taps, the smaller tile of K2's plan): nb row
// bands of nt column tiles. A work item is (iteration j, band
// b, tile t); one launch covers all n_iters * nb * nt items. Each block
// claims one item from a global ticket, in skewed order: by s = b + skew *
// j, then by j, then by t (skew >= 1, kernels/flow_iter.py::pipe_skew's
// choice: a larger skew puts more tickets between an item and the items it
// waits for, a smaller one keeps fewer bands' planes in flight in L2).
// Item (j, b, t) runs the tile body on tile (b, t) from the flow of
// iteration j - 1 (the prior flow for j = 0) into iteration j's flow. M at
// (r, c) reads the prior flow on row r alone, at columns up to D + 1 away
// (the fast warp shifts along rows by the flow at neighbouring COLUMNS of
// the same row: see warp_m/vlerp), and the tile's M spans its rows and
// columns +- bw. So the flow the item reads lies in bands b - db ... b +
// db, db = cdiv(bw, TH) (1 on the 32 x 64 tile up to 61 taps), and in
// column tiles t - dt ... t + dt, dt = cdiv(bw + D + 1, TW). The item waits until iteration j - 1 has published each of those
// tiles: a per-tile progress word holds the number of iterations done,
// stored with release semantics by the writer's thread 0 after a
// __syncthreads, and spun on with acquire loads by one reader thread per
// word before a __syncthreads. There is no grid-wide barrier: a tile runs
// iteration j + 1 while later bands still run j.
//
// Why this cannot deadlock. A block takes its ticket only once it runs, so
// every claimed ticket is held by a resident block, and tickets are handed
// out in increasing order. Item (j, b, t) waits only on items
// (j - 1, b', t') with b' <= b + db, whose s' = b' + skew (j - 1) <= s -
// (skew - db) <= s (the wrapper's skew >= db, or >= the bands left
// below), and at s' = s their j - 1 < j: smaller tickets, whatever t'
// is. The smallest unfinished claimed ticket
// therefore waits on nothing unfinished and runs to its end; by induction
// every item does. No cooperative launch is needed. The ticket and the
// progress words are cleared with cudaMemsetAsync on the launch's stream
// before every launch.
//
// Memory. Each intermediate iteration's flow gets its own full-frame
// (2, h, w) buffer (n_iters - 1 of them), so no iteration overwrites a
// flow another item still reads. M and its vertical pass live in the
// block's shared memory only.
//
// Bound on Hopper: memory. R0 and R1 must be read once, the prior flow
// once and the final flow written once: at 1080p with bf16 planes 20 B/px
// + 8 + 8 = 74.6 MB, 0.0223 ms at 3.35 TB/s (the same bytes as one K2
// call, for all n_iters iterations); at 540x960 18.7 MB, 0.0056 ms. The
// FLOPs (~136 per pixel and iteration with the box window as sliding sums)
// are below that. This design reads R0 and R1 once per iteration (from L2
// while the skewed order keeps a few bands' slabs there) and the
// intermediate flows through L2, and recomputes M on each tile's halo as
// K2 does; its floor is about n_iters K2 launches' device time.
#include <cuda/atomic>

#include "flow_tile.cuh"

namespace {

using kh::fi::kTileThreads;
using kh::fi::Window;

template <int TH, int TW, int TAPS, typename PT>
__global__ void __launch_bounds__(kTileThreads, 2)
flow_iters_pipe_kernel(const PT* __restrict__ R0, const PT* __restrict__ R1,
                       const float* flow_in, int h, int w, float D,
                       const Window win, int n_iters, int nb, int nt, int db,
                       int dt, int skew, float* inter, float* out,
                       int* counters) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float s_w[kh::fi::kMaxTaps];
  __shared__ int s_item[3];
  int* ticket = counters;
  int* progress = counters + 1;           // (nb, nt): iterations done
  if (threadIdx.x == 0) {
    const int q = atomicAdd(ticket, 1);
    kh::fi::pipe_item(q, n_iters, nb, nt, skew, &s_item[0], &s_item[1],
                      &s_item[2]);
  }
  __syncthreads();
  const int j = s_item[0], b = s_item[1], t = s_item[2];
  // wait for iteration j - 1 on bands b - db ... b + db and tiles
  // t - dt ... t + dt, one thread per progress word
  if (j > 0) {
    const int b0 = max(0, b - db), b1 = min(nb - 1, b + db);
    const int t0 = max(0, t - dt), t1 = min(nt - 1, t + dt);
    const int ntw = t1 - t0 + 1;
    for (int i = threadIdx.x; i < (b1 - b0 + 1) * ntw; i += blockDim.x) {
      cuda::atomic_ref<int, cuda::thread_scope_device> p(
          progress[(b0 + i / ntw) * nt + t0 + i % ntw]);
      while (p.load(cuda::memory_order_acquire) < j) __nanosleep(64);
      __threadfence();
    }
  }
  __syncthreads();
  const long plane = (long)h * w;
  const float* src = j == 0 ? flow_in : inter + (long)(j - 1) * 2 * plane;
  float* dst = j == n_iters - 1 ? out : inter + (long)j * 2 * plane;
  kh::fi::tile_body<TH, TW, TAPS>(R0, R1, src, h, w,
                                  kh::fi::SelectSumM{D, 0, h}, win, b * TH,
                                  t * TW, dst, sm, s_w);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    cuda::atomic_ref<int, cuda::thread_scope_device> p(progress[b * nt + t]);
    p.store(j + 1, cuda::memory_order_release);
  }
}

template <int TH, int TW, int TAPS, typename PT>
int launch(const void* R0, const void* R1, const float* flow, int h, int w,
           int D, const Window& win, int n_iters, int skew, int smem,
           float* inter, float* out, int* counters, cudaStream_t s) {
  auto kern = flow_iters_pipe_kernel<TH, TW, TAPS, PT>;
  const int bw = win.taps / 2;
  const int nb = static_cast<int>(kh::cdiv(h, TH));
  const int nt = static_cast<int>(kh::cdiv(w, TW));
  const int db = static_cast<int>(kh::cdiv(bw, TH));
  const int dt = static_cast<int>(kh::cdiv(bw + D + 1, TW));
  if (smem != kh::fi::tile_smem_bytes(TH, TW, bw) || skew < min(db, nb))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long)n_iters * nb * nt > 2147483647L)
    return static_cast<int>(cudaErrorInvalidValue);
  static kh::SmemGrant grant;
  cudaError_t err = grant.allow(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(counters, 0, sizeof(int) * (1 + (long)nb * nt), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<n_iters * nb * nt, kTileThreads, smem, s>>>(
      static_cast<const PT*>(R0), static_cast<const PT*>(R1), flow, h, w,
      static_cast<float>(D), win, n_iters, nb, nt, db, dt, skew, inter, out,
      counters);
  return static_cast<int>(cudaGetLastError());
}

// The tile of K2's plan (flow_tile.cuh::kShapes): shape 0 at 15 taps
// compiled in or generic, a smaller one (past 61 taps) generic.
template <typename PT>
int dispatch(const void* R0, const void* R1, const float* flow, int h,
             int w, int D, const Window& win, int n_iters, int skew,
             int shape, int smem, float* inter, float* out, int* counters,
             cudaStream_t s) {
  switch (shape) {
    case 0:
      return win.taps == 15
                 ? launch<32, 64, 15, PT>(R0, R1, flow, h, w, D, win,
                                          n_iters, skew, smem, inter, out,
                                          counters, s)
                 : launch<32, 64, 0, PT>(R0, R1, flow, h, w, D, win,
                                         n_iters, skew, smem, inter, out,
                                         counters, s);
    case 1:
      return launch<16, 64, 0, PT>(R0, R1, flow, h, w, D, win, n_iters,
                                   skew, smem, inter, out, counters, s);
    case 2:
      return launch<16, 32, 0, PT>(R0, R1, flow, h, w, D, win, n_iters,
                                   skew, smem, inter, out, counters, s);
    case 3:
      return launch<8, 16, 0, PT>(R0, R1, flow, h, w, D, win, n_iters,
                                  skew, smem, inter, out, counters, s);
    case 4:
      return launch<8, 8, 0, PT>(R0, R1, flow, h, w, D, win, n_iters, skew,
                                 smem, inter, out, counters, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// R0, R1 (5, h, w) bf16 [bf16 = 1] or f32; flow (2, h, w) f32 prior;
// wts (taps,) f32 in HOST memory and, past 61 taps, in device memory too
// (wts_dev, else null); n_iters >= 2; skew >= 1 (the order above); shape
// and smem, the tile of kernels/flow_iter.py::tile_plan (0: 32 x 64; a
// window too wide for every tile does not come here) and its dynamic
// shared memory; scratch inter (n_iters - 1, 2, h, w) f32 and counters
// (1 + the plan's tiles,) int32; out (2, h, w) f32.
KH_API int kh_flow_iters_pipe(const void* R0, const void* R1, int bf16,
                              const void* flow, int h, int w, int D,
                              const void* wts, const void* wts_dev, int taps,
                              float post_scale, int n_iters, int skew,
                              int shape, int smem, void* inter, void* out,
                              void* counters, void* stream) {
  if (h <= 0 || w <= 0 || !kh::fi::window_ok(taps, wts_dev) || D < 0 ||
      n_iters < 2 || skew < 1 || (shape > 0 && taps <= kh::fi::kMaxTaps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Window win = kh::fi::make_window(wts, taps, post_scale, wts_dev);
  auto f = static_cast<const float*>(flow);
  auto in = static_cast<float*>(inter);
  auto o = static_cast<float*>(out);
  auto c = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(R0, R1, f, h, w, D, win, n_iters, skew,
                                   shape, smem, in, o, c, s);
  return dispatch<float>(R0, R1, f, h, w, D, win, n_iters, skew, shape, smem,
                         in, o, c, s);
}
