// K13: all `n_iters` fine-level Farneback iterations of one level in ONE
// launch, as a skewed pipeline over row bands.
//
// Replaces kalman_hydra_tpu/kernels/flow_iter_pallas.py::flow_iters_pipelined
// (_flow_iters_pipe_kernel). Its result is exactly `n_iters` applications
// of K2: the per-pixel code is K2's own (csrc/flow_iter.cuh: m_at,
// window_v_at, window_h_solve_at, on the same (5, h, w) layouts), so K13
// equals n_iters K2 launches bit for bit.
//
// Work items and their order. The level is cut into nb row bands of th
// rows (th >= winsize / 2 = bw, the wrapper's choice; the last band may be
// shorter). A work item is (iteration j, band b); one launch covers all
// n_iters * nb items. Each block claims one item from a global ticket in
// skewed order: by s = b + j, then by j. Item (j, b) computes, for its
// band:
//   1. M (the warp and the damped normal equations) on the band's rows and
//      the bw-row halo above and below (clamped to the image: the rows K2's
//      clamped window reads), from the flow of iteration j - 1 (the prior
//      flow for j = 0);
//   2. the vertical window pass on the band's rows;
//   3. the horizontal pass and the 2x2 solve into iteration j's flow.
// M at row r reads the prior flow on row r alone (the fast warp shifts
// along rows by the flow at neighbouring COLUMNS of the same row: see
// m_at/vlerp), so the rows item (j, b) reads of iteration j - 1 lie in
// bands b - 1, b and b + 1 (th >= bw). It waits until iteration j - 1 has
// published each of those bands: a per-band progress word holds the number
// of iterations done, stored with release semantics by the writer's
// thread 0 after a __syncthreads, and spun on with acquire loads by the
// reader's thread 0 before a __syncthreads. There is no grid-wide
// barrier: band b runs iteration j + 1 while later bands still run j.
//
// Why this cannot deadlock. A block takes its ticket only once it runs, so
// every claimed ticket is held by a resident block, and tickets are handed
// out in increasing order. Item (j, b) waits only on items (j - 1, b') with
// b' <= b + 1, whose s' = b' + j - 1 <= s, and at s' = s their j - 1 < j:
// smaller tickets. The smallest unfinished claimed ticket therefore waits
// on nothing unfinished and runs to its end; by induction every item does.
// No cooperative launch is needed. The ticket and the progress words are
// cleared with cudaMemsetAsync on the launch's stream before every launch.
//
// Memory: a simple layout. Each intermediate iteration's flow gets its own
// full-frame (2, h, w) buffer (n_iters - 1 of them), so no iteration
// overwrites a flow another item still reads. M lives in three full-frame
// (5, h, w) buffers, band b writing its rows (halo included) in buffer
// b % 3: bands b and b + 3 touch disjoint rows (th >= bw), and band b's
// next iteration reuses its rows only after waiting for this one. The
// vertical pass Mv is written on the band's own rows only, so one
// full-frame buffer serves all bands. Each band recomputes the M rows of
// its halo (2 bw rows per band).
//
// Bound on Hopper: memory. R0 and R1 must be read once, the prior flow
// once and the final flow written once: at 1080p with bf16 planes 20 B/px
// + 8 + 8 = 74.6 MB, 0.0223 ms at 3.35 TB/s (the same bytes as one K2
// call, for all n_iters iterations); at 540x960 18.7 MB, 0.0056 ms. The
// FLOPs (~136 per pixel and iteration with the box window as sliding sums)
// are below that. This first design is far from it: every iteration reads
// R0 and R1 again and moves M, Mv and the flow through device memory (L2
// for the smaller levels), one band per block (8-row bands: 135 items an
// iteration at 1080p, 68 at 540x960; taller bands were slower). Keeping
// each band's R slabs in shared memory (TMA) and fusing the three phases
// is later work.
#include <cuda/atomic>

#include "flow_iter.cuh"

namespace {

using kh::fi::m_at;
using kh::fi::window_h_solve_at;
using kh::fi::window_v_at;

constexpr int kThreads = 512;

// Item t of the skewed order -> (j, b): items by s = b + j, then by j.
__device__ void item_of(int t, int n_iters, int nb, int* j_out,
                        int* b_out) {
  for (int s = 0;; ++s) {
    const int j0 = max(0, s - nb + 1), j1 = min(n_iters - 1, s);
    const int n = j1 - j0 + 1;
    if (t < n) {
      *j_out = j0 + t;
      *b_out = s - (j0 + t);
      return;
    }
    t -= n;
  }
}

template <typename PT>
__global__ void __launch_bounds__(kThreads)
flow_iters_pipe_kernel(const PT* __restrict__ R0, const PT* __restrict__ R1,
                       const float* flow_in, int h, int w, float D,
                       const float* __restrict__ wts, int taps,
                       float post_scale, int n_iters, int th, int nb,
                       float* M, float* Mv, float* inter, float* out,
                       int* counters) {
  __shared__ int s_item[2];
  int* ticket = counters;
  int* progress = counters + 1;
  if (threadIdx.x == 0) {
    const int t = atomicAdd(ticket, 1);
    item_of(t, n_iters, nb, &s_item[0], &s_item[1]);
  }
  __syncthreads();
  const int j = s_item[0], b = s_item[1];
  const int bw = taps / 2;
  const long plane = (long)h * w;
  const int r0 = b * th, r1 = min(h, r0 + th);          // core rows
  const int m0 = max(0, r0 - bw), m1 = min(h, r1 + bw);  // M rows
  // wait for iteration j - 1 on every band the M rows read (and on this
  // band, whose M rows this item rewrites)
  if (threadIdx.x == 0 && j > 0) {
    for (int bb = m0 / th; bb <= (m1 - 1) / th; ++bb) {
      cuda::atomic_ref<int, cuda::thread_scope_device> p(progress[bb]);
      while (p.load(cuda::memory_order_acquire) < j) __nanosleep(100);
    }
    __threadfence();
  }
  __syncthreads();
  const float* src = j == 0 ? flow_in : inter + (long)(j - 1) * 2 * plane;
  float* dst = j == n_iters - 1 ? out : inter + (long)j * 2 * plane;
  float* Mb = M + (long)(b % 3) * 5 * plane;
  for (long i = threadIdx.x; i < (long)(m1 - m0) * w; i += blockDim.x)
    m_at(R0, R1, src, h, w, D, m0 + static_cast<int>(i / w),
         static_cast<int>(i % w), Mb);
  __syncthreads();
  for (long i = threadIdx.x; i < (long)(r1 - r0) * w; i += blockDim.x)
    window_v_at(Mb, h, w, wts, taps, r0 + static_cast<int>(i / w),
                static_cast<int>(i % w), Mv);
  __syncthreads();
  for (long i = threadIdx.x; i < (long)(r1 - r0) * w; i += blockDim.x)
    window_h_solve_at(Mv, h, w, wts, taps, post_scale,
                      r0 + static_cast<int>(i / w), static_cast<int>(i % w),
                      dst);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    cuda::atomic_ref<int, cuda::thread_scope_device> p(progress[b]);
    p.store(j + 1, cuda::memory_order_release);
  }
}

template <typename PT>
int run(const void* R0, const void* R1, const float* flow, int h, int w,
        int D, const float* wts, int taps, float post_scale, int n_iters,
        int th, float* M, float* Mv, float* inter, float* out, int* counters,
        cudaStream_t s) {
  const int nb = static_cast<int>(kh::cdiv(h, th));
  cudaError_t err = cudaMemsetAsync(counters, 0, sizeof(int) * (nb + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  flow_iters_pipe_kernel<PT><<<n_iters * nb, kThreads, 0, s>>>(
      static_cast<const PT*>(R0), static_cast<const PT*>(R1), flow, h, w,
      static_cast<float>(D), wts, taps, post_scale, n_iters, th, nb, M, Mv,
      inter, out, counters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// R0, R1 (5, h, w) bf16 [bf16 = 1] or f32; flow (2, h, w) f32 prior;
// wts (taps,) f32 on the device; n_iters >= 2; band height th >= taps / 2;
// scratch M (3, 5, h, w), Mv (5, h, w) and inter (n_iters - 1, 2, h, w)
// f32, counters (cdiv(h, th) + 1,) int32; out (2, h, w) f32.
KH_API int kh_flow_iters_pipe(const void* R0, const void* R1, int bf16,
                              const void* flow, int h, int w, int D,
                              const void* wts, int taps, float post_scale,
                              int n_iters, int th, void* M, void* Mv,
                              void* inter, void* out, void* counters,
                              void* stream) {
  if (h <= 0 || w <= 0 || taps <= 0 || D < 0 || n_iters < 2 ||
      th < taps / 2 || th <= 0 || (long)n_iters * kh::cdiv(h, th) > 2147483647L)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = static_cast<const float*>(flow);
  auto wt = static_cast<const float*>(wts);
  auto m = static_cast<float*>(M);
  auto mv = static_cast<float*>(Mv);
  auto in = static_cast<float*>(inter);
  auto o = static_cast<float*>(out);
  auto c = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(R0, R1, f, h, w, D, wt, taps, post_scale,
                              n_iters, th, m, mv, in, o, c, s);
  return run<float>(R0, R1, f, h, w, D, wt, taps, post_scale, n_iters, th,
                    m, mv, in, o, c, s);
}
