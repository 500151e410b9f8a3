// Per-pixel device code of one Farneback iteration, shared by K2/K6
// (csrc/flow_iter.cu), K13 (csrc/flow_iters_pipe.cu), K5
// (csrc/flow_level.cu) and K8/K8-pairs (csrc/flow_update.cu), so that
// these kernels compute the same values bit for bit. Semantics, per pixel:
//   1. warp, one of two:
//      - the select-sum warp (K2, K5, K6, K13): flow clamped to +-D;
//        y_idx = floor(dy), ay = dy - y_idx, the same for x. v(r, c) =
//        lerp_ay(r,c)(R1[clamp(r + y_idx)], R1[clamp(r + y_idx + 1)]) and
//        R1w(r, c) = lerp_ax(r,c)(v(r, c0), v(r, c1)) with c0/c1 =
//        clamp(c + x_idx [+ 1]); v at a neighbour column uses THAT
//        column's dy (the select-sum reuse, not a true bilinear warp);
//      - the exact bilinear gather (K8, K8-pairs): R1 sampled at (r + dy,
//        c + dx), clamped to the image, with no displacement clamp;
//   2. averaged-matrix normal equations, damped by OpenCV's 5-px border
//      taper (separable), M = (G11, G12, G22, h1, h2); in K2's band mode
//      (a row slab of a taller image) the taper reads the image's rows;
//   3. winsize window (box or Gaussian taps) over M with a replicate
//      border — M outside the image is its edge row / column;
//   4. 2x2 solve, idet = 1 / (g11 g22 - g12^2 + 1e-3).
// Planes load as bf16 or f32; flow, M and all arithmetic are f32.
//
// Each step's arithmetic is written once: warp_m / exact_m / normal_eqs
// return M's five values, tap() is the one window multiply-add, solve()
// the 2x2 solve; csrc/flow_tile.cuh keeps them in shared memory. The
// select-sum warp reads the prior flow through an accessor: the (2, h, w)
// planes (PlaneFlow), or K5's prior resized from the coarser level on the
// fly (csrc/flow_level.cu).
//
// The flow carries no __restrict__: K5 and K13 read flows that other
// blocks of their launch wrote, where read-only loads would be wrong.
#pragma once

#include "common.cuh"

namespace kh {
namespace fi {

__device__ __forceinline__ float damp1(int i, int n) {
  // OpenCV's FarnebackUpdateMatrices taper, by the distance to the edge
  const int d = min(i, n - 1 - i);
  if (d >= 5) return 1.f;
  return d < 2 ? 0.14f : 0.4472f;
}

// The prior flow of the select-sum warp as (2, h, w) planes.
struct PlaneFlow {
  const float* f;
  int w;
  long plane;
  __device__ __forceinline__ float dx(int r, int c) const {
    return f[(long)r * w + c];
  }
  __device__ __forceinline__ float dy(int r, int c) const {
    return f[plane + (long)r * w + c];
  }
};

template <typename PT, typename Flow>
__device__ __forceinline__ void vlerp(const PT* __restrict__ R1,
                                      const Flow& fl, int r, int c, int h,
                                      int w, float D, float v[5]) {
  const float dy = fminf(fmaxf(fl.dy(r, c), -D), D);
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

// Step 2 at (r, c), given the warped R1 planes q[5] there: the
// averaged-matrix normal equations, damped, into m[5]. Shared by the
// select-sum warp (warp_m) and the exact warp without rounding (exact_m).
// The taper reads row r + row0 of an image img_h rows tall: a slab's rows
// in K2's band mode, else (row0 = 0, img_h = h) the plane's own rows.
template <typename PT>
__device__ __forceinline__ void normal_eqs(const PT* __restrict__ R0,
                                           const float q[5], float dx,
                                           float dy, int h, int w, int r,
                                           int c, float m[5], int row0,
                                           int img_h) {
  const long plane = (long)h * w;
  const long o = (long)r * w + c;
  float a_xx = (load(R0 + 2 * plane + o) + q[2]) * 0.5f;
  float a_yy = (load(R0 + 3 * plane + o) + q[3]) * 0.5f;
  float axy = (load(R0 + 4 * plane + o) + q[4]) * 0.25f;
  float db_x = (load(R0 + o) - q[0]) * 0.5f + a_xx * dx + axy * dy;
  float db_y = (load(R0 + plane + o) - q[1]) * 0.5f + axy * dx + a_yy * dy;
  const float damp = damp1(r + row0, img_h) * damp1(c, w);
  a_xx *= damp;
  a_yy *= damp;
  axy *= damp;
  db_x *= damp;
  db_y *= damp;
  m[0] = a_xx * a_xx + axy * axy;
  m[1] = (a_xx + a_yy) * axy;
  m[2] = a_yy * a_yy + axy * axy;
  m[3] = a_xx * db_x + axy * db_y;
  m[4] = axy * db_x + a_yy * db_y;
}

// normal_eqs with every product and sum rounded on its own, in the order
// of the plain version's elementwise torch ops (no fused multiply-add):
// the M that K8-pairs rounds to bf16 is then the plain version's M bit
// for bit, so both round it to the same bf16 value (a one-ulp f32
// difference at a bf16 rounding boundary would move that M sample by a
// bf16 ulp, 2^-8 relative).
template <typename PT>
__device__ __forceinline__ void normal_eqs_exact(const PT* __restrict__ R0,
                                                 const float q[5], float dx,
                                                 float dy, int h, int w,
                                                 int r, int c, float m[5]) {
  const long plane = (long)h * w;
  const long o = (long)r * w + c;
  float a_xx = __fmul_rn(__fadd_rn(load(R0 + 2 * plane + o), q[2]), 0.5f);
  float a_yy = __fmul_rn(__fadd_rn(load(R0 + 3 * plane + o), q[3]), 0.5f);
  float axy = __fmul_rn(__fadd_rn(load(R0 + 4 * plane + o), q[4]), 0.25f);
  float db_x = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(load(R0 + o), q[0]), 0.5f),
                __fmul_rn(a_xx, dx)),
      __fmul_rn(axy, dy));
  float db_y = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(load(R0 + plane + o), q[1]), 0.5f),
                __fmul_rn(axy, dx)),
      __fmul_rn(a_yy, dy));
  const float damp = __fmul_rn(damp1(r, h), damp1(c, w));
  a_xx = __fmul_rn(a_xx, damp);
  a_yy = __fmul_rn(a_yy, damp);
  axy = __fmul_rn(axy, damp);
  db_x = __fmul_rn(db_x, damp);
  db_y = __fmul_rn(db_y, damp);
  m[0] = __fadd_rn(__fmul_rn(a_xx, a_xx), __fmul_rn(axy, axy));
  m[1] = __fmul_rn(__fadd_rn(a_xx, a_yy), axy);
  m[2] = __fadd_rn(__fmul_rn(a_yy, a_yy), __fmul_rn(axy, axy));
  m[3] = __fadd_rn(__fmul_rn(a_xx, db_x), __fmul_rn(axy, db_y));
  m[4] = __fadd_rn(__fmul_rn(axy, db_x), __fmul_rn(a_yy, db_y));
}

// The exact bilinear gather of R1 (5, h, w) at (r, c) by the flow (dx, dy)
// there, into q[5]: statement for statement the plain gather,
// ops/warp.py::warp_poly_planar (the reference's _warp_poly_planar).
// The sample point is clamped to the image and its top-left corner to
// [0, w - 2] x [0, h - 2], so the last column and row lerp at ax = 1 /
// ay = 1 (h, w >= 2). Every step is rounded on its own (__f*_rn, never
// contracted into a fused multiply-add), as eager torch rounds each op,
// and the bilinear sum runs left to right as torch evaluates it; bf16
// corners are widened on load, as torch's f32 weights promote them.
// float(x0) is exact (x0 < 2^24).
template <typename PT>
__device__ __forceinline__ void exact_warp(const PT* __restrict__ R1,
                                           float dx, float dy, int h, int w,
                                           int r, int c, float q[5]) {
  const float fx = fminf(fmaxf(__fadd_rn(static_cast<float>(c), dx), 0.f),
                         static_cast<float>(w - 1));
  const float fy = fminf(fmaxf(__fadd_rn(static_cast<float>(r), dy), 0.f),
                         static_cast<float>(h - 1));
  const int x0 = clampi(static_cast<int>(floorf(fx)), 0, w - 2);
  const int y0 = clampi(static_cast<int>(floorf(fy)), 0, h - 2);
  const float ax = __fsub_rn(fx, static_cast<float>(x0));
  const float ay = __fsub_rn(fy, static_cast<float>(y0));
  const float bx = __fsub_rn(1.f, ax);     // torch's (1 - ax)
  const float by = __fsub_rn(1.f, ay);
  const long plane = (long)h * w;
  const long o = (long)y0 * w + x0;
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    const PT* s = R1 + p * plane + o;
    const float c00 = load(s), c01 = load(s + 1);
    const float c10 = load(s + w), c11 = load(s + w + 1);
    float acc = __fmul_rn(__fmul_rn(c00, bx), by);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c01, ax), by));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c10, bx), ay));
    q[p] = __fadd_rn(acc, __fmul_rn(__fmul_rn(c11, ax), ay));
  }
}

// Phase 1 of the exact-warp iteration at (r, c): the exact gather, then
// M's five values into m[5]; with round_m M is computed without fused
// multiply-adds and rounded to bf16 (and back), where the reference's
// update_matrices_p stores M in the bf16 plane dtype (K8-pairs).
template <typename PT>
__device__ __forceinline__ void exact_m(const PT* __restrict__ R0,
                                        const PT* __restrict__ R1,
                                        const float* flow, int h, int w,
                                        int round_m, int r, int c,
                                        float m[5]) {
  const long plane = (long)h * w;
  const long o = (long)r * w + c;
  const float dx = flow[o], dy = flow[plane + o];
  float q[5];
  exact_warp(R1, dx, dy, h, w, r, c, q);
  if (!round_m) {
    normal_eqs(R0, q, dx, dy, h, w, r, c, m, 0, h);
    return;
  }
  normal_eqs_exact(R0, q, dx, dy, h, w, r, c, m);
#pragma unroll
  for (int p = 0; p < 5; ++p)
    m[p] = __bfloat162float(__float2bfloat16_rn(m[p]));
}

// Phase 1 at (r, c): warp R1 by the prior flow `fl` (PlaneFlow or
// another accessor with dx(r, c) and dy(r, c)), M's five values into m[5];
// row0 and img_h as in normal_eqs.
template <typename PT, typename Flow>
__device__ __forceinline__ void warp_m(const PT* __restrict__ R0,
                                       const PT* __restrict__ R1,
                                       const Flow& fl, int h, int w,
                                       float D, int r, int c, float m[5],
                                       int row0, int img_h) {
  const float dx = fl.dx(r, c), dy = fl.dy(r, c);
  const float dxc = fminf(fmaxf(dx, -D), D);
  const float xf = floorf(dxc);
  const float ax = dxc - xf;
  const int xi = static_cast<int>(xf);
  float va[5], vb[5];
  vlerp(R1, fl, r, clampi(c + xi, 0, w - 1), h, w, D, va);
  vlerp(R1, fl, r, clampi(c + xi + 1, 0, w - 1), h, w, D, vb);
  float q[5];
#pragma unroll
  for (int p = 0; p < 5; ++p)
    q[p] = (1.f - ax) * va[p] + ax * vb[p];   // warped R1 plane p
  normal_eqs(R0, q, dx, dy, h, w, r, c, m, row0, img_h);
}

// One window tap: acc += wk * x, one fused multiply-add in every kernel.
// Every window sum runs its taps k = 0 ... taps - 1 in this order.
__device__ __forceinline__ void tap(float& acc, float wk, float x) {
  acc += wk * x;
}

// Step 4 on the window sums g[5] (G11, G12, G22, h1, h2): scale, then the
// 2x2 solve for the new flow (u, v).
__device__ __forceinline__ void solve(float g[5], float post_scale,
                                      float* u, float* v) {
#pragma unroll
  for (int p = 0; p < 5; ++p) g[p] *= post_scale;
  const float idet = 1.f / (g[0] * g[2] - g[1] * g[1] + 1e-3f);
  *u = (g[2] * g[3] - g[1] * g[4]) * idet;
  *v = (g[0] * g[4] - g[1] * g[3]) * idet;
}

}  // namespace fi
}  // namespace kh
