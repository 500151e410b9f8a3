// K4 and K7b: coarse Farneback level images + their polynomial expansion,
// for one frame (K4) or a stack of N frames (K7b); K11 (at the end): the
// level images alone.
//
// Replaces kalman_hydra_tpu/kernels/level_image_pallas.py::
// coarse_polyexp_fused (_levels_polyexp_kernel) and
// ::coarse_polyexp_fused_batch (_levels_polyexp_batch_kernel). Each
// coarse level k >= 1
// is GaussianBlur(original, reflect101, up to 79 taps at 1080p) composed
// with the INTER_LINEAR resize, replicate-padded by n, then expanded into
// the 5 polyexp planes. The TPU kernel applies the composition as two
// banded MXU products V_k . img . H_k^T; here the same composed weights
// are host-built tap tables (source index + weight per output row or
// column, _band_mats/_band_mats_padded entry for entry, see
// kernels/level_image.py), applied as direct stencils.
//
// Bound on Hopper: memory. Per level the vertical pass reads the 8 MB
// 1080p image once per output row's taps — served from L2 (50 MB holds
// the image), so device-memory traffic is ~the image plus the level
// intermediates (< 5 MB at level 1); arithmetic is < 10 MFLOP per level.
// Design: the band products are sparse (<= ksize + 1 non-zeros per row),
// so a GEMM would spend >99% of its FLOPs on zeros; a thread per output
// element walks its tap list instead (vertical pass: coalesced along
// image columns; horizontal pass: neighbouring threads read overlapping
// windows of one row, which the L1 serves). The padded level image then
// goes through K3's device code in valid mode. All arithmetic is f32.
// The frame index is blockIdx.z and every frame shares the tap tables:
// K4 is K7b with one frame, so a batched launch equals its per-frame
// launches bit for bit.
#include "polyexp.cuh"

namespace {

constexpr int kThreads = 256;

// tmp[f, o, x] = sum_t wt[o, t] * img[f, idx[o, t], x]   (o < ho, x < w)
__global__ void level_vpass(const float* __restrict__ img, int h, int w,
                            const int* __restrict__ idx,
                            const float* __restrict__ wt, int taps,
                            float* __restrict__ tmp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int o = blockIdx.y;
  if (x >= w) return;
  img += blockIdx.z * (long)h * w;
  tmp += blockIdx.z * (long)gridDim.y * w;
  const int* ix = idx + (long)o * taps;
  const float* wv = wt + (long)o * taps;
  float acc = 0.f;
  for (int t = 0; t < taps; ++t) acc += wv[t] * img[(long)ix[t] * w + x];
  tmp[(long)o * w + x] = acc;
}

// out[f, o, p] = sum_t wt[p, t] * tmp[f, o, idx[p, t]]  (o < ho, p < wo)
__global__ void level_hpass(const float* __restrict__ tmp, int w,
                            const int* __restrict__ idx,
                            const float* __restrict__ wt, int taps, int wo,
                            float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int o = blockIdx.y;
  if (p >= wo) return;
  tmp += blockIdx.z * (long)gridDim.y * w;
  out += blockIdx.z * (long)gridDim.y * wo;
  const int* ix = idx + (long)p * taps;
  const float* wv = wt + (long)p * taps;
  const float* row = tmp + (long)o * w;
  float acc = 0.f;
  for (int t = 0; t < taps; ++t) acc += wv[t] * row[ix[t]];
  out[(long)o * wo + p] = acc;
}

}  // namespace

// One coarse level of `frames` images. img (frames, h, w) f32; vertical
// table (ho, tv), horizontal table (wo, th) with ho = lh + 2n,
// wo = lw + 2n; scratch tmp (frames, ho, w) and lvl (frames, ho, wo) f32;
// out (frames, 5, lh, lw) f32 or bf16.
KH_API int kh_level_polyexp(const void* img, int frames, int h, int w,
                            const void* iv, const void* wv, int tv, int ho,
                            const void* ih, const void* wh, int th, int wo,
                            const void* taps_host, int n, int out_bf16,
                            void* tmp, void* lvl, void* out, void* stream) {
  if (frames <= 0 || frames > 65535 || ho > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  level_vpass<<<dim3(kh::cdiv(w, kThreads), ho, frames), kThreads, 0, s>>>(
      static_cast<const float*>(img), h, w, static_cast<const int*>(iv),
      static_cast<const float*>(wv), tv, static_cast<float*>(tmp));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  level_hpass<<<dim3(kh::cdiv(wo, kThreads), ho, frames), kThreads, 0, s>>>(
      static_cast<const float*>(tmp), w, static_cast<const int*>(ih),
      static_cast<const float*>(wh), th, wo, static_cast<float*>(lvl));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return kh::launch_polyexp(static_cast<const float*>(lvl), ho, wo, 0,
                            ho - 2 * n, wo - 2 * n,
                            static_cast<const float*>(taps_host), n,
                            out_bf16, frames, out, s);
}

// K11: one coarse level image of one frame, with no polyexp. Replaces
// level_image_pallas.py::farneback_images_pallas (_levels_kernel), whose
// two MXU band products V_k . img . H_k^T per level are the same composed
// weights as above at padding 0 (level_tables(..., n=0) is the unpadded
// _band_mats). Bound on Hopper: memory; a 1080p frame's five coarse levels
// must read the 8.3 MB image and write 2.8 MB (3.3 us at 3.35 TB/s), and
// the image is re-read from L2 per level. img (h, w) f32; vertical table
// (lh, tv), horizontal table (lw, th); scratch tmp (lh, w) f32; out
// (lh, lw) f32.
KH_API int kh_level_images(const void* img, int h, int w, const void* iv,
                           const void* wv, int tv, int lh, const void* ih,
                           const void* wh, int th, int lw, void* tmp,
                           void* out, void* stream) {
  if (lh <= 0 || lw <= 0 || lh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  level_vpass<<<dim3(kh::cdiv(w, kThreads), lh, 1), kThreads, 0, s>>>(
      static_cast<const float*>(img), h, w, static_cast<const int*>(iv),
      static_cast<const float*>(wv), tv, static_cast<float*>(tmp));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  level_hpass<<<dim3(kh::cdiv(lw, kThreads), lh, 1), kThreads, 0, s>>>(
      static_cast<const float*>(tmp), w, static_cast<const int*>(ih),
      static_cast<const float*>(wh), th, lw, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
