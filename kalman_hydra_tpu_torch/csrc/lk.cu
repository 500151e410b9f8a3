// K12: one pyramid level of sparse pyramidal Lucas-Kanade for K points.
//
// Replaces kalman_hydra_tpu/kernels/lk_pallas.py::lk_sparse (_lk_level,
// _lk_point_kernel), the drop-in kernel of ops/lk.py::_track_point_level;
// with a per-point clamp window it also computes the reference's batched
// block-halo solvers (ops/lk.py::_lk_level_batched_corr, _klast,
// _lk_level_batched), which differ from the exact path only in where the
// moving guess is clamped. Per point:
//   1. bilinear (win x win) patches of the previous image and its two
//      Scharr planes at the point (the template), the structure tensor
//      G = sum [gx gx, gx gy; gx gy, gy gy], its min eigenvalue / win^2
//      and determinant gate `ok`;
//   2. up to max_iter Gauss-Newton steps while the point is active (it
//      starts as `ok`): the next image's patch at the guess, whose
//      top-left offset o = clip(guess - half - base, 0, span) is clamped
//      to the point's window, b = sum (patch_b - patch_a) * grad,
//      d = -G^-1 b, guess += d; the point stops once |d|^2 <= eps^2.
//      The exact window is base 0, span = padded extent - win - 2; the
//      block window is the halo'd block around the level's initial guess,
//      span 2 * halo (the wrapper computes both).
// Coordinates are those of the level image replicate-padded by `pad`;
// the padding is never built: every read clamps its index to the image.
//
// Numerics: every elementwise step is the plain version's in its order
// with round-to-nearest intrinsics (no FMA contraction), and the window
// sums accumulate in float64 before they round to f32. The plain version
// sums in float64 too, so the two agree to the last bit but for a rare
// tie: with f32 sums the summation order alone would move |d|^2 across
// eps^2 for about one point in 10^4 and shift that point by up to eps.
//
// Bound on Hopper: memory on paper. A 1080p frame pair at K = 1024 and
// five levels reads (win + 1)^2 floats per point and level for each of
// the three template blocks and per Gauss-Newton step; on the synthetic
// blob clip that is ~46 MB for 8,167 steps (~14 us at 3.35 TB/s, ~0.15
// GFLOP). In practice the work is latency: dependent steps of a gather,
// a reduction and a 2 x 2 solve, and the blocks overlap in L2.
// Design: one warp per point, four points per block. The lanes stride
// over the win^2 samples; the template and its gradients stay in shared
// memory (3 win^2 floats per warp); each iteration's patch reads go
// through L1/L2 (a 1080p level image is 8 MB); the sums reduce with warp
// shuffles, so every lane holds the same G, b and d and the early exit
// is warp-uniform.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

struct Images {
  const float* a;    // previous level image
  const float* b;    // next level image
  const float* gx;   // Scharr planes of a
  const float* gy;
  int h, w, pad;
};

// pixel (r, c) of `img` replicate-padded by `pad`
__device__ __forceinline__ float padded(const float* img, const Images& im,
                                        int r, int c) {
  r = kh::clampi(r - im.pad, 0, im.h - 1);
  c = kh::clampi(c - im.pad, 0, im.w - 1);
  return __ldg(img + (long)r * im.w + c);
}

// sample (i, j) of the bilinear patch whose (win + 1)^2 block starts at
// padded (by, bx), with cfx = 1 - fx and cfy = 1 - fy:
// blk00 (1-fx)(1-fy) + blk01 fx (1-fy) + blk10 (1-fx) fy + blk11 fx fy,
// each product and sum in the plain version's order
__device__ __forceinline__ float bilin(const float* img, const Images& im,
                                       int by, int bx, int i, int j,
                                       float fx, float fy, float cfx,
                                       float cfy) {
  const float p00 = padded(img, im, by + i, bx + j);
  const float p01 = padded(img, im, by + i, bx + j + 1);
  const float p10 = padded(img, im, by + i + 1, bx + j);
  const float p11 = padded(img, im, by + i + 1, bx + j + 1);
  float t = __fmul_rn(__fmul_rn(p00, cfx), cfy);
  t = __fadd_rn(t, __fmul_rn(__fmul_rn(p01, fx), cfy));
  t = __fadd_rn(t, __fmul_rn(__fmul_rn(p10, cfx), fy));
  return __fadd_rn(t, __fmul_rn(__fmul_rn(p11, fx), fy));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void lk_level_kernel(Images im, const float* __restrict__ pt,
                                const float* __restrict__ guess,
                                const float* __restrict__ base,
                                float span_x, float span_y, int K, int win,
                                int max_iter, float eps2, float min_eig_thr,
                                float* __restrict__ out,
                                unsigned char* __restrict__ ok_out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= K) return;                // the whole warp leaves together
  const int n = win * win;
  float* pa = smem + warp * 3 * n;
  float* pgx = pa + n;
  float* pgy = pgx + n;
  const float half = (win - 1) * 0.5f;

  // ---- template patches and the structure tensor ----
  const float tx = __fsub_rn(pt[2 * k], half);
  const float ty = __fsub_rn(pt[2 * k + 1], half);
  const int ax = (int)floorf(tx), ay = (int)floorf(ty);
  const float fx = __fsub_rn(tx, (float)ax), fy = __fsub_rn(ty, (float)ay);
  const float cfx = __fsub_rn(1.f, fx), cfy = __fsub_rn(1.f, fy);
  double s11 = 0.0, s12 = 0.0, s22 = 0.0;
  for (int s = lane; s < n; s += 32) {
    const int i = s / win, j = s - (s / win) * win;
    const float va = bilin(im.a, im, ay, ax, i, j, fx, fy, cfx, cfy);
    const float vx = bilin(im.gx, im, ay, ax, i, j, fx, fy, cfx, cfy);
    const float vy = bilin(im.gy, im, ay, ax, i, j, fx, fy, cfx, cfy);
    pa[s] = va;
    pgx[s] = vx;
    pgy[s] = vy;
    s11 += (double)__fmul_rn(vx, vx);
    s12 += (double)__fmul_rn(vx, vy);
    s22 += (double)__fmul_rn(vy, vy);
  }
  const float g11 = (float)warp_sum(s11);
  const float g12 = (float)warp_sum(s12);
  const float g22 = (float)warp_sum(s22);
  __syncwarp();
  const float dg = __fsub_rn(g11, g22);
  const float root = __fsqrt_rn(
      __fadd_rn(__fmul_rn(dg, dg), __fmul_rn(4.f, __fmul_rn(g12, g12))));
  const float min_eig = __fdiv_rn(
      __fmul_rn(__fsub_rn(__fadd_rn(g11, g22), root), 0.5f),
      (float)(win * win));
  const float det = __fsub_rn(__fmul_rn(g11, g22), __fmul_rn(g12, g12));
  const bool ok = (min_eig > min_eig_thr) && (det > 1e-12f);
  const float inv_det = ok ? __fdiv_rn(1.f, det) : 0.f;

  // ---- Gauss-Newton on the next image ----
  float gxp = guess[2 * k], gyp = guess[2 * k + 1];
  const float bx0 = base[2 * k], by0 = base[2 * k + 1];
  bool active = ok;
  for (int it = 0; it < max_iter && active; ++it) {
    const float ox =
        fminf(fmaxf(__fsub_rn(__fsub_rn(gxp, half), bx0), 0.f), span_x);
    const float oy =
        fminf(fmaxf(__fsub_rn(__fsub_rn(gyp, half), by0), 0.f), span_y);
    const float ix = floorf(ox), iy = floorf(oy);
    const float bfx = __fsub_rn(ox, ix), bfy = __fsub_rn(oy, iy);
    const float cbx = __fsub_rn(1.f, bfx), cby = __fsub_rn(1.f, bfy);
    const int sx = (int)bx0 + (int)ix, sy = (int)by0 + (int)iy;
    double b1 = 0.0, b2 = 0.0;
    for (int s = lane; s < n; s += 32) {
      const int i = s / win, j = s - (s / win) * win;
      const float diff = __fsub_rn(
          bilin(im.b, im, sy, sx, i, j, bfx, bfy, cbx, cby), pa[s]);
      b1 += (double)__fmul_rn(diff, pgx[s]);
      b2 += (double)__fmul_rn(diff, pgy[s]);
    }
    const float f1 = (float)warp_sum(b1), f2 = (float)warp_sum(b2);
    const float dx =
        __fmul_rn(-__fsub_rn(__fmul_rn(g22, f1), __fmul_rn(g12, f2)),
                  inv_det);
    const float dy =
        __fmul_rn(-__fsub_rn(__fmul_rn(g11, f2), __fmul_rn(g12, f1)),
                  inv_det);
    gxp = __fadd_rn(gxp, dx);
    gyp = __fadd_rn(gyp, dy);
    active = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) > eps2;
  }
  if (lane == 0) {
    out[2 * k] = gxp;
    out[2 * k + 1] = gyp;
    ok_out[k] = ok ? 1 : 0;
  }
}

}  // namespace

KH_API int kh_lk_level(const void* a, const void* b, const void* gx,
                       const void* gy, int h, int w, int pad, const void* pt,
                       const void* guess, const void* base, float span_x,
                       float span_y, int K, int win, int max_iter, float eps2,
                       float min_eig, void* out, void* ok, void* stream) {
  const Images im{static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<const float*>(gx),
                  static_cast<const float*>(gy), h, w, pad};
  const size_t smem = sizeof(float) * 3 * kWarps * win * win;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lk_level_kernel<<<kh::cdiv(K, kWarps), 32 * kWarps, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      im, static_cast<const float*>(pt), static_cast<const float*>(guess),
      static_cast<const float*>(base), span_x, span_y, K, win, max_iter, eps2,
      min_eig, static_cast<float*>(out), static_cast<unsigned char*>(ok));
  return static_cast<int>(cudaGetLastError());
}
