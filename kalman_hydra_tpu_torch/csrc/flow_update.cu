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
#include "flow_iter.cuh"

namespace {

using kh::fi::normal_eqs_at;
using kh::fi::window_h_solve_at;
using kh::fi::window_v_at;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
update_m_kernel(const float* __restrict__ R0, const float* __restrict__ R1w,
                const float* __restrict__ flow, int h, int w,
                float* __restrict__ M) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= w) return;
  const long plane = (long)h * w;
  const long o = (long)r * w + c;
  float q[5];
#pragma unroll
  for (int p = 0; p < 5; ++p) q[p] = R1w[p * plane + o];
  normal_eqs_at(R0, q, flow[o], flow[plane + o], h, w, r, c, M);
}

__global__ void __launch_bounds__(kThreads)
window_v_kernel(const float* __restrict__ M, int h, int w,
                const float* __restrict__ wts, int taps,
                float* __restrict__ Mv) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= w) return;
  window_v_at(M, h, w, wts, taps, r, c, Mv);
}

__global__ void __launch_bounds__(kThreads)
window_h_solve_kernel(const float* __restrict__ Mv, int h, int w,
                      const float* __restrict__ wts, int taps,
                      float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= w) return;
  window_h_solve_at(Mv, h, w, wts, taps, 1.f, r, c, out);
}

}  // namespace

// R0, R1w (5, h, w) f32; flow (2, h, w) f32; wts (taps,) f32 on the
// device; scratch M, Mv (5, h, w) f32; out (2, h, w) f32.
KH_API int kh_flow_update(const void* R0, const void* R1w, const void* flow,
                          int h, int w, const void* wts, int taps, void* M,
                          void* Mv, void* out, void* stream) {
  if (h <= 0 || w <= 0 || taps <= 0 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(kh::cdiv(w, kThreads), h);
  auto wt = static_cast<const float*>(wts);
  auto m = static_cast<float*>(M);
  auto mv = static_cast<float*>(Mv);
  update_m_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(R0), static_cast<const float*>(R1w),
      static_cast<const float*>(flow), h, w, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_v_kernel<<<grid, kThreads, 0, s>>>(m, h, w, wt, taps, mv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_h_solve_kernel<<<grid, kThreads, 0, s>>>(
      mv, h, w, wt, taps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
