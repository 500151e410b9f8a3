// K10: the pyrLK Scharr derivatives of one f32 image, gx and gy in one
// pass.
//
// Replaces kalman_hydra_tpu/kernels/scharr_pallas.py::scharr_gradients
// (_scharr_kernel): gx = smooth_y(edge_x f), gy = edge_y(smooth_x f),
// edge [-1, 0, 1], smooth [3, 10, 3] / 32, replicate border. The XLA
// version runs four correlate1d passes, each with its own padded copy in
// device memory; the TPU kernel keeps the intermediates in VMEM. Here one
// thread reads its 3 x 3 neighbourhood (indices clamped: the replicate
// border) and writes both outputs, so nothing but the image and the two
// planes touches device memory.
//
// Arithmetic order is the plain version's (two ops.filters.correlate1d
// passes per gradient), each tap a multiply then an add in tap order;
// the edge taps' -1, 0 and 1 products are exact.
//
// Bound on Hopper: memory. 1080p reads 8.3 MB and writes 16.6 MB (~7 us
// at 3.35 TB/s) for ~12 FLOPs per pixel. Design: one thread per pixel,
// 32 x 8 blocks, rows coalesced; the nine reads overlap the neighbours'
// and hit L1.
#include "common.cuh"

namespace {

constexpr float kS0 = 0.09375f;   // 3 / 32
constexpr float kS1 = 0.3125f;    // 10 / 32

__global__ void scharr_kernel(const float* __restrict__ src, int h, int w,
                              float* __restrict__ gx,
                              float* __restrict__ gy) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int cols[3] = {max(x - 1, 0), x, min(x + 1, w - 1)};
  const int rows[3] = {max(y - 1, 0), y, min(y + 1, h - 1)};
  float ex[3], sx[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* p = src + (long)rows[r] * w;
    const float a = __ldg(p + cols[0]), b = __ldg(p + cols[1]),
                c = __ldg(p + cols[2]);
    // -1 * a + 0 * b + 1 * c, as correlate1d sums it
    ex[r] = __fadd_rn(__fadd_rn(-a, __fmul_rn(0.f, b)), c);
    sx[r] = __fadd_rn(__fadd_rn(__fmul_rn(kS0, a), __fmul_rn(kS1, b)),
                      __fmul_rn(kS0, c));
  }
  const long o = (long)y * w + x;
  gx[o] = __fadd_rn(__fadd_rn(__fmul_rn(kS0, ex[0]), __fmul_rn(kS1, ex[1])),
                    __fmul_rn(kS0, ex[2]));
  gy[o] = __fadd_rn(__fadd_rn(-sx[0], __fmul_rn(0.f, sx[1])), sx[2]);
}

}  // namespace

KH_API int kh_scharr(const void* src, int h, int w, void* gx, void* gy,
                     void* stream) {
  const dim3 block(32, 8);
  const dim3 grid(kh::cdiv(w, block.x), kh::cdiv(h, block.y));
  scharr_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), h, w, static_cast<float*>(gx),
      static_cast<float*>(gy));
  return static_cast<int>(cudaGetLastError());
}
