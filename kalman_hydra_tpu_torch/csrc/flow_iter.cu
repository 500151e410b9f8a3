// K2: one fine-level Farneback iteration with the select-sum warp.
//
// Replaces kalman_hydra_tpu/kernels/flow_iter_pallas.py::flow_iter
// (_flow_iter_kernel, _tile_body, _box_solve). Semantics, per pixel:
//   1. warp: flow clamped to +-D; y_idx = floor(dy), ay = dy - y_idx, the
//      same for x. v(r, c) = lerp_ay(r,c)(R1[clamp(r + y_idx)],
//      R1[clamp(r + y_idx + 1)]) and R1w(r, c) = lerp_ax(r,c)(v(r, c0),
//      v(r, c1)) with c0/c1 = clamp(c + x_idx [+ 1]); v at a neighbour
//      column uses THAT column's dy (the select-sum reuse, not a true
//      bilinear warp);
//   2. averaged-matrix normal equations, damped by OpenCV's 5-px border
//      taper (separable, _damp_vec), M = (G11, G12, G22, h1, h2);
//   3. winsize window (box or Gaussian taps) over M with a replicate
//      border — M outside the image is its edge row / column;
//   4. 2x2 solve, idet = 1 / (g11 g22 - g12^2 + 1e-3).
// Planes load as bf16 or f32; flow, M and all arithmetic are f32.
//
// Bound on Hopper: memory. At 1080p bf16 one iteration moves ~40 MB of
// planes, 16 MB of flow and 2 x 40 MB of f32 M intermediates, against
// ~150 FLOPs per pixel (0.3 GFLOP) — ~0.05 ms at 3.35 TB/s. Design: three
// launches, each a thread per pixel with coalesced row-major access.
// The warp is two clamped indexed loads per tap instead of the TPU's
// (2D+2)-term select chain (gathers are cheap here; the chain was a
// workaround for TPU gathers). The window is split into a vertical and a
// horizontal pass over M so each pixel reads 2 x winsize values per
// plane instead of winsize^2; neighbouring threads share those reads in
// L1/L2. Fusing the three passes in shared memory is later work.
#include "common.cuh"

namespace {

using kh::clampi;
using kh::load;

constexpr int kThreads = 128;

__device__ __forceinline__ float damp1(int i, int n) {
  // ops/farneback.py _BORDER_SCALE, indexed by the distance to the edge
  const int d = min(i, n - 1 - i);
  if (d >= 5) return 1.f;
  return d < 2 ? 0.14f : 0.4472f;
}

template <typename PT>
__device__ __forceinline__ void vlerp(const PT* __restrict__ R1,
                                      const float* __restrict__ fy, int r,
                                      int c, int h, int w, float D,
                                      float v[5]) {
  const float dy = fminf(fmaxf(fy[(long)r * w + c], -D), D);
  const float yf = floorf(dy);
  const float ay = dy - yf;
  const int yi = static_cast<int>(yf);
  const long ra = (long)clampi(r + yi, 0, h - 1) * w + c;
  const long rb = (long)clampi(r + yi + 1, 0, h - 1) * w + c;
  const long plane = (long)h * w;
#pragma unroll
  for (int p = 0; p < 5; ++p)
    v[p] = (1.f - ay) * load(R1 + p * plane + ra) +
           ay * load(R1 + p * plane + rb);
}

template <typename PT>
__global__ void __launch_bounds__(kThreads)
flow_m_kernel(const PT* __restrict__ R0, const PT* __restrict__ R1,
              const float* __restrict__ flow, int h, int w, float D,
              float* __restrict__ M) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= w) return;
  const long plane = (long)h * w;
  const long o = (long)r * w + c;
  const float dx = flow[o], dy = flow[plane + o];
  const float dxc = fminf(fmaxf(dx, -D), D);
  const float xf = floorf(dxc);
  const float ax = dxc - xf;
  const int xi = static_cast<int>(xf);
  float va[5], vb[5];
  vlerp(R1, flow + plane, r, clampi(c + xi, 0, w - 1), h, w, D, va);
  vlerp(R1, flow + plane, r, clampi(c + xi + 1, 0, w - 1), h, w, D, vb);
  float q[5];
#pragma unroll
  for (int p = 0; p < 5; ++p)
    q[p] = (1.f - ax) * va[p] + ax * vb[p];   // warped R1 plane p

  float a_xx = (load(R0 + 2 * plane + o) + q[2]) * 0.5f;
  float a_yy = (load(R0 + 3 * plane + o) + q[3]) * 0.5f;
  float axy = (load(R0 + 4 * plane + o) + q[4]) * 0.25f;
  float db_x = (load(R0 + o) - q[0]) * 0.5f + a_xx * dx + axy * dy;
  float db_y = (load(R0 + plane + o) - q[1]) * 0.5f + axy * dx + a_yy * dy;
  const float damp = damp1(r, h) * damp1(c, w);
  a_xx *= damp;
  a_yy *= damp;
  axy *= damp;
  db_x *= damp;
  db_y *= damp;
  M[o] = a_xx * a_xx + axy * axy;
  M[plane + o] = (a_xx + a_yy) * axy;
  M[2 * plane + o] = a_yy * a_yy + axy * axy;
  M[3 * plane + o] = a_xx * db_x + axy * db_y;
  M[4 * plane + o] = axy * db_x + a_yy * db_y;
}

// Mv[p, r, c] = sum_k wts[k] * M[p, clamp(r + k - bw), c]
__global__ void __launch_bounds__(kThreads)
window_v_kernel(const float* __restrict__ M, int h, int w,
                const float* __restrict__ wts, int taps,
                float* __restrict__ Mv) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= w) return;
  const long plane = (long)h * w;
  const int bw = taps / 2;
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < taps; ++k) {
    const long src = (long)clampi(r + k - bw, 0, h - 1) * w + c;
    const float wk = wts[k];
#pragma unroll
    for (int p = 0; p < 5; ++p) acc[p] += wk * M[p * plane + src];
  }
  const long o = (long)r * w + c;
#pragma unroll
  for (int p = 0; p < 5; ++p) Mv[p * plane + o] = acc[p];
}

// horizontal window pass, then the 2x2 solve -> out (2, h, w)
__global__ void __launch_bounds__(kThreads)
window_h_solve_kernel(const float* __restrict__ Mv, int h, int w,
                      const float* __restrict__ wts, int taps,
                      float post_scale, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= w) return;
  const long plane = (long)h * w;
  const long row = (long)r * w;
  const int bw = taps / 2;
  float g[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < taps; ++k) {
    const long src = row + clampi(c + k - bw, 0, w - 1);
    const float wk = wts[k];
#pragma unroll
    for (int p = 0; p < 5; ++p) g[p] += wk * Mv[p * plane + src];
  }
#pragma unroll
  for (int p = 0; p < 5; ++p) g[p] *= post_scale;
  const float idet = 1.f / (g[0] * g[2] - g[1] * g[1] + 1e-3f);
  out[row + c] = (g[2] * g[3] - g[1] * g[4]) * idet;
  out[plane + row + c] = (g[0] * g[4] - g[1] * g[3]) * idet;
}

template <typename PT>
int run(const void* R0, const void* R1, const float* flow, int h, int w,
        int D, const float* wts, int taps, float post_scale, float* M,
        float* Mv, float* out, cudaStream_t s) {
  const dim3 grid(kh::cdiv(w, kThreads), h);
  flow_m_kernel<PT><<<grid, kThreads, 0, s>>>(
      static_cast<const PT*>(R0), static_cast<const PT*>(R1), flow, h, w,
      static_cast<float>(D), M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_v_kernel<<<grid, kThreads, 0, s>>>(M, h, w, wts, taps, Mv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_h_solve_kernel<<<grid, kThreads, 0, s>>>(Mv, h, w, wts, taps,
                                                  post_scale, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// R0, R1 (5, h, w) bf16 [bf16 = 1] or f32; flow (2, h, w) f32; wts (taps,)
// f32 on the device; scratch M, Mv (5, h, w) f32; out (2, h, w) f32.
KH_API int kh_flow_iter(const void* R0, const void* R1, int bf16,
                        const void* flow, int h, int w, int D,
                        const void* wts, int taps, float post_scale, void* M,
                        void* Mv, void* out, void* stream) {
  if (h <= 0 || w <= 0 || taps <= 0 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = static_cast<const float*>(flow);
  auto wt = static_cast<const float*>(wts);
  auto m = static_cast<float*>(M);
  auto mv = static_cast<float*>(Mv);
  auto o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(R0, R1, f, h, w, D, wt, taps, post_scale, m,
                              mv, o, s);
  return run<float>(R0, R1, f, h, w, D, wt, taps, post_scale, m, mv, o, s);
}
