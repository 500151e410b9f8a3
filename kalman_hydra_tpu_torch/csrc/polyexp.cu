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
// Bound on Hopper: memory. At 1080p the kernel reads 8 MB and writes
// 20 MB (bf16) or 40 MB (f32) for ~130 FMAs per pixel — ~0.3 GFLOP against
// 67 TFLOP/s f32, so the bytes set the floor (~10 us at 3.35 TB/s).
// Design: one 16 x 64 output tile per 256-thread block. The block stages
// the (16 + 2n) x (64 + 2n) input tile once in shared memory with
// clamped indices (the border costs no padded copy in device memory),
// runs the vertical taps into three shared planes, then the horizontal
// taps, so each input pixel is read from device memory ~1.4 times and
// the intermediates never leave the SM. Coefficients round to bf16 once,
// at the store (round to nearest even). The tile body (vertical and
// horizontal taps, the combination, the store) is polyexp.cuh's
// polyexp_tile, which K4/K7b run on level tiles they build in shared
// memory. The frame index is blockIdx.z:
// K3 is K7a with one frame, the same kernel, so a batched launch equals
// its per-frame launches bit for bit.
#include "polyexp.cuh"

namespace {

using kh::clampi;
using kh::kPeInH;
using kh::kPeInW;
using kh::kPeNMax;
using kh::kPeTaps;
using kh::kPeTH;
using kh::kPeTW;
using kh::PolyTaps;

constexpr int kThreads = 256;

// Output pixel (r, c) correlates src rows/cols clamp(r + k - n), k in
// [0, 2n]: the replicate border of the unpadded (h, w) image.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
polyexp_kernel(const float* __restrict__ src, int h, int w, PolyTaps t,
               OutT* __restrict__ out) {
  src += blockIdx.z * (long)h * w;
  out += blockIdx.z * 5 * (long)h * w;
  __shared__ float tile[kPeInH][kPeInW];
  __shared__ float vs[3][kPeTH][kPeInW];
  __shared__ float tg[3][kPeTaps];
  const int n = t.n, taps = 2 * n + 1;
  const int tin_h = kPeTH + 2 * n, tin_w = kPeTW + 2 * n;
  const int r0 = blockIdx.y * kPeTH, c0 = blockIdx.x * kPeTW;
  const int tid = threadIdx.x;

  if (tid < taps) {
    tg[0][tid] = t.g[tid];
    tg[1][tid] = t.xg[tid];
    tg[2][tid] = t.xxg[tid];
  }
  for (int i = tid; i < tin_h * tin_w; i += kThreads) {
    const int rr = i / tin_w, cc = i - rr * tin_w;
    const int sr = clampi(r0 + rr - n, 0, h - 1);
    const int sc = clampi(c0 + cc - n, 0, w - 1);
    tile[rr][cc] = src[(long)sr * w + sc];
  }
  __syncthreads();
  kh::polyexp_tile<OutT, kThreads>(&tile[0][0], &vs[0][0][0], &tg[0][0], t,
                                   r0, c0, h, w, h, w, out);
}

}  // namespace

// img (frames, h, w) f32 -> out (frames, 5, h, w), replicate border.
KH_API int kh_polyexp(const void* img, int frames, int h, int w,
                      const void* taps_host, int n, int out_bf16, void* out,
                      void* stream) {
  if (n < 1 || n > kPeNMax || h <= 0 || w <= 0 || frames <= 0 ||
      frames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const PolyTaps t = kh::poly_taps(static_cast<const float*>(taps_host), n);
  const float* src = static_cast<const float*>(img);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(kh::cdiv(w, kPeTW), kh::cdiv(h, kPeTH), frames);
  if (out_bf16) {
    polyexp_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        src, h, w, t, static_cast<__nv_bfloat16*>(out));
  } else {
    polyexp_kernel<float><<<grid, kThreads, 0, s>>>(
        src, h, w, t, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
