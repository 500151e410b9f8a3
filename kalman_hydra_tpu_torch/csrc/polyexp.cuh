// Polynomial-expansion device code shared by K4/K7b (csrc/level_image.cu)
// and K3/K7a (csrc/polyexp.cu): the taps, and the tile body that K4/K7b
// run on their level tiles (K3/K7a's own 32 x 64 tiles with a register
// ring sum every tap in the same order, so their bytes agree).
#pragma once

#include "common.cuh"

namespace kh {

constexpr int kPeNMax = 8;                  // taps by value up to n = 8
constexpr int kPeTaps = 2 * kPeNMax + 1;
constexpr int kPeTH = 16;                   // output rows of one tile body
constexpr int kPeTW = 64;                   // output columns of one
constexpr int kPeInW = kPeTW + 2 * kPeNMax; // row stride of its source

// A larger n (cv2 documents 5 and 7; the reference takes any odd n) has
// its source rows and tap rows widened to n: row stride pe_in_w(n), tap
// row stride pe_tap_stride(n) (kPeInW and kPeTaps up to n = 8, so those
// launches keep their layout), and its taps read from device memory.
__host__ __device__ constexpr int pe_in_w(int n) {
  return kPeTW + 2 * (n > kPeNMax ? n : kPeNMax);
}
__host__ __device__ constexpr int pe_tap_stride(int n) {
  return 2 * (n > kPeNMax ? n : kPeNMax) + 1;
}

struct PolyTaps {
  float g[kPeTaps], xg[kPeTaps], xxg[kPeTaps];
  float ig11, ig03, ig33, ig55;
  int n;
};

// taps_host = [g, xg, xxg (2n+1 each), ig11, ig03, ig33, ig55], f32; the
// tap arrays are filled up to n = kPeNMax (a larger n reads its taps from
// device memory).
inline PolyTaps poly_taps(const float* taps_host, int n) {
  PolyTaps t = {};
  const int taps = 2 * n + 1;
  for (int k = 0; k < taps && n <= kPeNMax; ++k) {
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
// in_w = pe_in_w(n), whose (0, 0) is the source pixel under output (r0,
// c0)'s top-left tap. The vertical taps run into the three shared planes
// `vs` (3 x kPeTH x in_w), then the horizontal taps, each a multiply-add
// in tap order; the planes are stored to `out` ((5, h, w) of OutT) where
// r < r_end and c < c_end. kN = 0 reads n from `t` and the taps from
// `tg` (g, xg, xxg: 3 rows of pe_tap_stride(n) in shared memory); kN > 0
// is n known at compile time, its tap loops unrolled and the taps read
// from `t` (the kernel's parameter space, an operand of the multiply-add
// itself, not a shared-memory load): the same multiply-adds in the same
// order. Ends with no barrier: the caller syncs before reusing vs.
template <typename OutT, int kThreads, int kN = 0>
__device__ __forceinline__ void polyexp_tile(
    const float* __restrict__ tile, float* __restrict__ vs,
    const float* __restrict__ tg, const PolyTaps& t, int r0, int c0,
    int h, int w, int r_end, int c_end, OutT* __restrict__ out) {
  const int n = kN ? kN : t.n, taps = 2 * n + 1;
  const int tin_w = kPeTW + 2 * n;
  const int tid = threadIdx.x;
  const int in_w = kN ? kPeInW : pe_in_w(n);   // the row stride
  const int ts = pe_tap_stride(n);
  const int plane_s = kPeTH * in_w;
  for (int i = tid; i < kPeTH * tin_w; i += kThreads) {
    const int rr = i / tin_w, cc = i - rr * tin_w;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    if constexpr (kN > 0) {
#pragma unroll
      for (int k = 0; k < 2 * kN + 1; ++k) {
        const float s = tile[(rr + k) * in_w + cc];
        v0 += t.g[k] * s;
        v1 += t.xg[k] * s;
        v2 += t.xxg[k] * s;
      }
    } else {
      for (int k = 0; k < taps; ++k) {
        const float s = tile[(rr + k) * in_w + cc];
        v0 += tg[k] * s;
        v1 += tg[ts + k] * s;
        v2 += tg[2 * ts + k] * s;
      }
    }
    vs[rr * in_w + cc] = v0;
    vs[plane_s + rr * in_w + cc] = v1;
    vs[2 * plane_s + rr * in_w + cc] = v2;
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
        const float a = vs[rr * in_w + cc + k];
        const float b = vs[plane_s + rr * in_w + cc + k];
        const float d = vs[2 * plane_s + rr * in_w + cc + k];
        m00 += t.g[k] * a;
        m10 += t.xg[k] * a;
        m20 += t.xxg[k] * a;
        m01 += t.g[k] * b;
        m11 += t.xg[k] * b;
        m02 += t.g[k] * d;
      }
    } else {
      for (int k = 0; k < taps; ++k) {
        const float a = vs[rr * in_w + cc + k];
        const float b = vs[plane_s + rr * in_w + cc + k];
        const float d = vs[2 * plane_s + rr * in_w + cc + k];
        m00 += tg[k] * a;
        m10 += tg[ts + k] * a;
        m20 += tg[2 * ts + k] * a;
        m01 += tg[k] * b;
        m11 += tg[ts + k] * b;
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
