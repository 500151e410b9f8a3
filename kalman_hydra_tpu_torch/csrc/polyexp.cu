// K3: Farneback polynomial expansion, (H, W) f32 -> (5, H, W) f32 or bf16.
//
// Replaces kalman_hydra_tpu/kernels/polyexp_pallas.py::poly_expansion_planar
// (_polyexp_kernel / _pe_compute): 9 separable Gaussian-moment
// correlations with a replicate border (vertical g, xg, xxg taps, then six
// horizontal moments), combined through the inverse-Gram scalars
// ig11/ig03/ig33/ig55 into [b_x, b_y, a_xx, a_yy, axy].
//
// Bound on Hopper: memory. At 1080p the kernel reads 8 MB and writes
// 20 MB (bf16) or 40 MB (f32) for ~130 FMAs per pixel — ~0.3 GFLOP against
// 67 TFLOP/s f32, so the bytes set the floor (~10 us at 3.35 TB/s).
// Design: one 16 x 64 output tile per 256-thread block. The block stages
// the (16 + 2n) x (64 + 2n) input tile once in shared memory with
// clamped indices (the border costs no padded copy in device memory),
// runs the vertical taps into three shared planes, then the horizontal
// taps, so each input pixel is read from device memory ~1.4 times and
// the intermediates never leave the SM. Coefficients round to bf16 once,
// at the store (round to nearest even).
#include "polyexp.cuh"

namespace {

using kh::clampi;
using kh::store;

constexpr int kNMax = 8;              // poly_n <= 8 (cv2 uses 5 or 7)
constexpr int kTaps = 2 * kNMax + 1;
constexpr int kTH = 16;
constexpr int kTW = 64;
constexpr int kThreads = 256;
constexpr int kInH = kTH + 2 * kNMax;
constexpr int kInW = kTW + 2 * kNMax;

struct PolyTaps {
  float g[kTaps], xg[kTaps], xxg[kTaps];
  float ig11, ig03, ig33, ig55;
  int n;
};

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
polyexp_kernel(const float* __restrict__ src, int src_h, int src_w, int off,
               int h, int w, PolyTaps t, OutT* __restrict__ out) {
  __shared__ float tile[kInH][kInW];
  __shared__ float vs[3][kTH][kInW];
  __shared__ float tg[3][kTaps];
  const int n = t.n, taps = 2 * n + 1;
  const int tin_h = kTH + 2 * n, tin_w = kTW + 2 * n;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;

  if (tid < taps) {
    tg[0][tid] = t.g[tid];
    tg[1][tid] = t.xg[tid];
    tg[2][tid] = t.xxg[tid];
  }
  for (int i = tid; i < tin_h * tin_w; i += kThreads) {
    const int rr = i / tin_w, cc = i - rr * tin_w;
    const int sr = clampi(r0 + rr + off, 0, src_h - 1);
    const int sc = clampi(c0 + cc + off, 0, src_w - 1);
    tile[rr][cc] = src[(long)sr * src_w + sc];
  }
  __syncthreads();

  for (int i = tid; i < kTH * tin_w; i += kThreads) {
    const int rr = i / tin_w, cc = i - rr * tin_w;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    for (int k = 0; k < taps; ++k) {
      const float s = tile[rr + k][cc];
      v0 += tg[0][k] * s;
      v1 += tg[1][k] * s;
      v2 += tg[2][k] * s;
    }
    vs[0][rr][cc] = v0;
    vs[1][rr][cc] = v1;
    vs[2][rr][cc] = v2;
  }
  __syncthreads();

  const long plane = (long)h * w;
  for (int i = tid; i < kTH * kTW; i += kThreads) {
    const int rr = i / kTW, cc = i - rr * kTW;
    const int r = r0 + rr, c = c0 + cc;
    if (r >= h || c >= w) continue;
    float m00 = 0.f, m10 = 0.f, m20 = 0.f, m01 = 0.f, m11 = 0.f, m02 = 0.f;
    for (int k = 0; k < taps; ++k) {
      const float a = vs[0][rr][cc + k];
      const float b = vs[1][rr][cc + k];
      const float d = vs[2][rr][cc + k];
      m00 += tg[0][k] * a;
      m10 += tg[1][k] * a;
      m20 += tg[2][k] * a;
      m01 += tg[0][k] * b;
      m11 += tg[1][k] * b;
      m02 += tg[0][k] * d;
    }
    const long o = (long)r * w + c;
    store(out + o, m10 * t.ig11);
    store(out + plane + o, m01 * t.ig11);
    store(out + 2 * plane + o, m00 * t.ig03 + m20 * t.ig33);
    store(out + 3 * plane + o, m00 * t.ig03 + m02 * t.ig33);
    store(out + 4 * plane + o, m11 * t.ig55);
  }
}

}  // namespace

namespace kh {

int launch_polyexp(const float* src, int src_h, int src_w, int off, int h,
                   int w, const float* taps_host, int n, int out_bf16,
                   void* out, cudaStream_t stream) {
  if (n < 1 || n > kNMax || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PolyTaps t = {};
  const int taps = 2 * n + 1;
  for (int k = 0; k < taps; ++k) {
    t.g[k] = taps_host[k];
    t.xg[k] = taps_host[taps + k];
    t.xxg[k] = taps_host[2 * taps + k];
  }
  t.ig11 = taps_host[3 * taps];
  t.ig03 = taps_host[3 * taps + 1];
  t.ig33 = taps_host[3 * taps + 2];
  t.ig55 = taps_host[3 * taps + 3];
  t.n = n;
  const dim3 grid(cdiv(w, kTW), cdiv(h, kTH));
  if (out_bf16) {
    polyexp_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        src, src_h, src_w, off, h, w, t, static_cast<__nv_bfloat16*>(out));
  } else {
    polyexp_kernel<float><<<grid, kThreads, 0, stream>>>(
        src, src_h, src_w, off, h, w, t, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kh

// img (h, w) f32 -> out (5, h, w), replicate border.
KH_API int kh_polyexp(const void* img, int h, int w, const void* taps_host,
                      int n, int out_bf16, void* out, void* stream) {
  return kh::launch_polyexp(static_cast<const float*>(img), h, w, -n, h, w,
                            static_cast<const float*>(taps_host), n,
                            out_bf16, out, static_cast<cudaStream_t>(stream));
}
