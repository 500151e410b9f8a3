// K8: one exact-warp Farneback iteration after the gather: the normal
// equations from R0 and the already-warped R1w, the winsize window and the
// 2x2 solve for the new absolute flow.
//
// Replaces kalman_hydra_tpu/kernels/flow_update_pallas.py::flow_update
// (_flow_update_kernel). The bilinear gather of R1 by the prior flow stays
// outside, in plain torch (ops/farneback.py::warp_poly_planar), as the
// reference leaves it to XLA. Per pixel: M from R0, R1w and the flow at
// that same pixel (no warp), damped by OpenCV's 5-px border taper; the
// window (K8's own taps: float32(1/n) for the box, the cv2 Gaussian
// otherwise, no post-scale) over M with a replicate border, where the TPU
// kernel reads edge-padded slabs; then the solve. All f32.
//
// Bound on Hopper: memory. Each call must read R0, R1w (5 f32 planes each)
// and the flow (2) and write the new flow (2): 56 B/px, 116 MB at
// 1080x1920 (35 us at 3.35 TB/s). With the box as sliding sums the
// function needs ~136 FLOPs per pixel (0.28 GFLOP, 4 us at 67 TFLOP/s
// f32), well below that; this code sums every tap. Design: K2's three
// launches (csrc/flow_iter.cu), a thread per pixel with coalesced
// row-major access: phase 1 is the per-pixel normal equations shared with
// K2 (flow_iter.cuh::normal_eqs_at) fed by R1w instead of a warp; phases
// 2 and 3 are K2's window passes. Like K2 it writes and reads two f32 M
// intermediates; folding the gather into phase 1 and the three passes
// into one are later work.
//
// K8-pairs, the port's own pair variant (no TPU kernel: it replaces the
// reference's vmapped plain-XLA update_matrices_p / update_flow_p of the
// pair-batched exact warp, kalman_hydra_tpu/ops/farneback.py:633-640):
// the same three kernels with the pair index in blockIdx.z, as K6 is K2's.
// Pair b reads R0 at frame p = b + b / ppc (ppc > 0 chains clips) or
// p = b of the plane stack, in place (bf16 or f32, widened on load as K8's
// caller widens them), and its own warped R1w, flow and outputs. With
// round_m the phase-1 store rounds M to bf16 (and back to f32), where the
// reference's update_matrices_p stores M in the bf16 plane dtype; the
// window and the solve stay f32 as there. That M is computed without
// fused multiply-adds (flow_iter.cuh::normal_eqs_exact_at), so that the
// kernel and its plain version round the same f32 value. K8 is K8-pairs
// with one pair, f32 planes and no rounding, so per-pair K8 equals
// K8-pairs bit for bit.
#include "flow_iter.cuh"

namespace {

using kh::fi::normal_eqs_at;
using kh::fi::normal_eqs_exact_at;
using kh::fi::window_h_solve_at;
using kh::fi::window_v_at;

constexpr int kThreads = 128;

template <typename PT>
__global__ void __launch_bounds__(kThreads)
update_m_kernel(const PT* __restrict__ R0, int ppc,
                const float* __restrict__ R1w,
                const float* __restrict__ flow, int h, int w, int round_m,
                float* __restrict__ M) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= w) return;
  const int b = blockIdx.z;
  const long plane = (long)h * w;
  const long o = (long)r * w + c;
  const long p = ppc > 0 ? b + b / ppc : b;
  const float* rw = R1w + b * 5 * plane;
  const float* fl = flow + b * 2 * plane;
  float* m = M + b * 5 * plane;
  float q[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) q[k] = rw[k * plane + o];
  if (!round_m) {
    normal_eqs_at(R0 + p * 5 * plane, q, fl[o], fl[plane + o], h, w, r, c,
                  m);
    return;
  }
  normal_eqs_exact_at(R0 + p * 5 * plane, q, fl[o], fl[plane + o], h, w, r,
                      c, m);
#pragma unroll
  for (int k = 0; k < 5; ++k)
    m[k * plane + o] =
        __bfloat162float(__float2bfloat16_rn(m[k * plane + o]));
}

__global__ void __launch_bounds__(kThreads)
window_v_kernel(const float* __restrict__ M, int h, int w,
                const float* __restrict__ wts, int taps,
                float* __restrict__ Mv) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= w) return;
  const long off = blockIdx.z * 5 * (long)h * w;
  window_v_at(M + off, h, w, wts, taps, r, c, Mv + off);
}

__global__ void __launch_bounds__(kThreads)
window_h_solve_kernel(const float* __restrict__ Mv, int h, int w,
                      const float* __restrict__ wts, int taps,
                      float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= w) return;
  const long plane = (long)h * w;
  window_h_solve_at(Mv + blockIdx.z * 5 * plane, h, w, wts, taps, 1.f, r, c,
                    out + blockIdx.z * 2 * plane);
}

template <typename PT>
int run(const void* R0, int pairs, int ppc, const void* R1w,
        const void* flow, int h, int w, const void* wts, int taps,
        int round_m, void* M, void* Mv, void* out, cudaStream_t s) {
  const dim3 grid(kh::cdiv(w, kThreads), h, pairs);
  auto wt = static_cast<const float*>(wts);
  auto m = static_cast<float*>(M);
  auto mv = static_cast<float*>(Mv);
  update_m_kernel<PT><<<grid, kThreads, 0, s>>>(
      static_cast<const PT*>(R0), ppc, static_cast<const float*>(R1w),
      static_cast<const float*>(flow), h, w, round_m, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_v_kernel<<<grid, kThreads, 0, s>>>(m, h, w, wt, taps, mv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_h_solve_kernel<<<grid, kThreads, 0, s>>>(
      mv, h, w, wt, taps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8. R0, R1w (5, h, w) f32; flow (2, h, w) f32; wts (taps,) f32 on the
// device; scratch M, Mv (5, h, w) f32; out (2, h, w) f32.
KH_API int kh_flow_update(const void* R0, const void* R1w, const void* flow,
                          int h, int w, const void* wts, int taps, void* M,
                          void* Mv, void* out, void* stream) {
  if (h <= 0 || w <= 0 || taps <= 0 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return run<float>(R0, 1, 0, R1w, flow, h, w, wts, taps, 0, M, Mv, out,
                    static_cast<cudaStream_t>(stream));
}

// K8-pairs. R0 the (N, 5, h, w) plane stack, bf16 [bf16 = 1] or f32; pair
// b (b < pairs) reads its frame p as above (ppc pairs per clip, 0 = one
// clip); R1w (pairs, 5, h, w) and flow (pairs, 2, h, w) f32; scratch M, Mv
// (pairs, 5, h, w) f32; out (pairs, 2, h, w) f32; round_m: M to bf16.
KH_API int kh_flow_update_pairs(const void* R0, int bf16, int pairs, int ppc,
                                const void* R1w, const void* flow, int h,
                                int w, const void* wts, int taps,
                                int round_m, void* M, void* Mv, void* out,
                                void* stream) {
  if (h <= 0 || w <= 0 || taps <= 0 || h > 65535 || pairs <= 0 ||
      pairs > 65535 || ppc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(R0, pairs, ppc, R1w, flow, h, w, wts, taps,
                              round_m, M, Mv, out, s);
  return run<float>(R0, pairs, ppc, R1w, flow, h, w, wts, taps, round_m, M,
                    Mv, out, s);
}
