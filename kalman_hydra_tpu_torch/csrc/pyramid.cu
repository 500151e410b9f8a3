// K9: cv2.pyrDown of one f32 image, (H, W) -> ((H + 1) / 2, (W + 1) / 2).
//
// Replaces kalman_hydra_tpu/kernels/pyramid_pallas.py::pyr_down
// (_pyr_kernel, _decim_band): the separable [1, 4, 6, 4, 1] / 16 blur
// with a REFLECT_101 border, kept at the even rows and columns. The TPU
// kernel pre-pads the image and applies the decimating blur as two banded
// MXU products (Mosaic refuses stride-2 slices); here each output pixel
// is a direct 5 x 5 stencil whose reflect101 indices are computed in the
// kernel (no pre-pad, no band matrices), so the odd edge — the last
// output row or column of an odd size reads taps past the end — and
// levels of a few pixels (37 x 53 reaches 3 x 4 at five levels) need no
// special case.
//
// Arithmetic order is the plain version's (ops.filters.sep_filter2d):
// the vertical 5-tap sums at the five source columns, then the
// horizontal 5-tap sum of those, each tap a multiply then an add in tap
// order.
//
// Bound on Hopper: memory. A 1080p level reads 8.3 MB and writes 2.1 MB
// (~3 us at 3.35 TB/s) for ~30 FLOPs per output pixel. Design: one thread
// per output pixel, 32 x 8 blocks; the 25 reads per pixel overlap their
// neighbours' and are served by L1/L2, so device memory sees each input
// byte about once.
#include "common.cuh"

namespace {

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  i = abs(i) % period;
  return i >= n ? period - i : i;
}

__global__ void pyr_down_kernel(const float* __restrict__ src, int h, int w,
                                float* __restrict__ dst, int oh, int ow) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= ow || oy >= oh) return;
  const float wk[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
  int rows[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) rows[k] = reflect101(2 * oy + k - 2, h) * w;
  float out = 0.f;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float* col = src + reflect101(2 * ox + j - 2, w);
    float v = __fmul_rn(wk[0], __ldg(col + rows[0]));
#pragma unroll
    for (int k = 1; k < 5; ++k)
      v = __fadd_rn(v, __fmul_rn(wk[k], __ldg(col + rows[k])));
    out = j == 0 ? __fmul_rn(wk[0], v) : __fadd_rn(out, __fmul_rn(wk[j], v));
  }
  dst[(long)oy * ow + ox] = out;
}

}  // namespace

KH_API int kh_pyr_down(const void* src, int h, int w, void* dst,
                       void* stream) {
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  const dim3 block(32, 8);
  const dim3 grid(kh::cdiv(ow, block.x), kh::cdiv(oh, block.y));
  pyr_down_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), h, w, static_cast<float*>(dst), oh, ow);
  return static_cast<int>(cudaGetLastError());
}
