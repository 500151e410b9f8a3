// Polynomial-expansion device code shared by K4/K7b (csrc/level_image.cu)
// and K3/K7a (csrc/polyexp.cu): the taps, and the tile body that K4/K7b
// run on their level tiles (K3/K7a's own 32 x 64 tiles with a register
// ring sum every tap in the same order, so their bytes agree).
#pragma once

#include "common.cuh"

namespace kh {

constexpr int kPeNMax = 8;                  // poly_n <= 8 (cv2 uses 5 or 7)
constexpr int kPeTaps = 2 * kPeNMax + 1;
constexpr int kPeTH = 16;                   // output rows of one tile body
constexpr int kPeTW = 64;                   // output columns of one
constexpr int kPeInW = kPeTW + 2 * kPeNMax; // row stride of its source

struct PolyTaps {
  float g[kPeTaps], xg[kPeTaps], xxg[kPeTaps];
  float ig11, ig03, ig33, ig55;
  int n;
};

// taps_host = [g, xg, xxg (2n+1 each), ig11, ig03, ig33, ig55], f32.
inline PolyTaps poly_taps(const float* taps_host, int n) {
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
  return t;
}

// The tile body: the 5 planes of the kPeTH x kPeTW output pixels whose
// top left is (r0, c0), from `tile`, a (kPeTH + 2n) x (kPeTW + 2n) block
// of the (already bordered) source in shared memory with row stride
// kPeInW, whose (0, 0) is the source pixel under output (r0, c0)'s
// top-left tap. The vertical taps run into the three shared planes `vs`
// (3 x kPeTH x kPeInW), then the horizontal taps, each a multiply-add in
// tap order; the planes are stored to `out` ((5, h, w) of OutT) where
// r < r_end and c < c_end. kN = 0 reads n from `t` and the taps from
// `tg` (g, xg, xxg: 3 x kPeTaps in shared memory); kN > 0 is n known at
// compile time, its tap loops unrolled and the taps read from `t` (the
// kernel's parameter space, an operand of the multiply-add itself, not a
// shared-memory load): the same multiply-adds in the same order. Ends
// with no barrier: the caller syncs before reusing vs.
template <typename OutT, int kThreads, int kN = 0>
__device__ __forceinline__ void polyexp_tile(
    const float* __restrict__ tile, float* __restrict__ vs,
    const float* __restrict__ tg, const PolyTaps& t, int r0, int c0,
    int h, int w, int r_end, int c_end, OutT* __restrict__ out) {
  const int n = kN ? kN : t.n, taps = 2 * n + 1;
  const int tin_w = kPeTW + 2 * n;
  const int tid = threadIdx.x;
  constexpr int kPlane = kPeTH * kPeInW;
  for (int i = tid; i < kPeTH * tin_w; i += kThreads) {
    const int rr = i / tin_w, cc = i - rr * tin_w;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    if constexpr (kN > 0) {
#pragma unroll
      for (int k = 0; k < 2 * kN + 1; ++k) {
        const float s = tile[(rr + k) * kPeInW + cc];
        v0 += t.g[k] * s;
        v1 += t.xg[k] * s;
        v2 += t.xxg[k] * s;
      }
    } else {
      for (int k = 0; k < taps; ++k) {
        const float s = tile[(rr + k) * kPeInW + cc];
        v0 += tg[k] * s;
        v1 += tg[kPeTaps + k] * s;
        v2 += tg[2 * kPeTaps + k] * s;
      }
    }
    vs[rr * kPeInW + cc] = v0;
    vs[kPlane + rr * kPeInW + cc] = v1;
    vs[2 * kPlane + rr * kPeInW + cc] = v2;
  }
  __syncthreads();

  const long plane = (long)h * w;
  for (int i = tid; i < kPeTH * kPeTW; i += kThreads) {
    const int rr = i / kPeTW, cc = i - rr * kPeTW;
    const int r = r0 + rr, c = c0 + cc;
    if (r >= r_end || c >= c_end) continue;
    float m00 = 0.f, m10 = 0.f, m20 = 0.f, m01 = 0.f, m11 = 0.f, m02 = 0.f;
    if constexpr (kN > 0) {
#pragma unroll
      for (int k = 0; k < 2 * kN + 1; ++k) {
        const float a = vs[rr * kPeInW + cc + k];
        const float b = vs[kPlane + rr * kPeInW + cc + k];
        const float d = vs[2 * kPlane + rr * kPeInW + cc + k];
        m00 += t.g[k] * a;
        m10 += t.xg[k] * a;
        m20 += t.xxg[k] * a;
        m01 += t.g[k] * b;
        m11 += t.xg[k] * b;
        m02 += t.g[k] * d;
      }
    } else {
      for (int k = 0; k < taps; ++k) {
        const float a = vs[rr * kPeInW + cc + k];
        const float b = vs[kPlane + rr * kPeInW + cc + k];
        const float d = vs[2 * kPlane + rr * kPeInW + cc + k];
        m00 += tg[k] * a;
        m10 += tg[kPeTaps + k] * a;
        m20 += tg[2 * kPeTaps + k] * a;
        m01 += tg[k] * b;
        m11 += tg[kPeTaps + k] * b;
        m02 += tg[k] * d;
      }
    }
    const long o = (long)r * w + c;
    store(out + o, m10 * t.ig11);
    store(out + plane + o, m01 * t.ig11);
    store(out + 2 * plane + o, m00 * t.ig03 + m20 * t.ig33);
    store(out + 3 * plane + o, m00 * t.ig03 + m02 * t.ig33);
    store(out + 4 * plane + o, m11 * t.ig55);
  }
}

}  // namespace kh
