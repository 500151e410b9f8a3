// K1: fused EKF predict + position update for a batch of tracks.
//
// Replaces kalman_hydra_tpu/kernels/ekf_pallas.py::ekf_fused_step
// (_ekf_kernel). Per track: x <- F x, P <- F P F^T + Q, S = H P H^T + r I
// (2x2), closed-form 2x2 Cholesky with the 1e-12 clamps, gain
// K = P H^T S^-1, x update, Joseph-form P, and NIS = y^T S^-1 y.
// y is the residual against the PREDICTED state; the kernel runs its own
// predict from the pre-predict state (models/ekf.py ekf_step contract).
// With z_mode it is given the measurement z instead and forms y = z -
// H x_pred itself, and it can also write x_pred and P_pred (the frame
// loop's commit needs them), so that the caller runs no predict of its
// own.
//
// Bound on Hopper: latency. At K = 1024, n = 6 the kernel must move
// ~320 KB (0.1 us at 3.35 TB/s) and do ~1.6k FLOPs a track (0.02 us at
// 67 TFLOP/s f32): neither is near its roof. The first design (one
// thread a track, 128-thread blocks: 8 blocks on 132 SMs at K = 1024)
// ran each track's ~3k dependent FLOPs as one chain, its 36-float P
// loads 144 B apart across a warp.
// Design: G = 8 (n = 6) or 4 (n = 4) lanes a track, lane i owning row i
// of x, P and every n x n product; 64-thread blocks (8 or 16 tracks), so
// K = 1024 spreads over 128 (n = 6) blocks. A block stages its tracks'
// x, P, y and H through shared memory with coalesced loads; each lane
// forms its row of F P, P_pred, P_pred H^T, the gain and I - K H; the
// rows other lanes need (P H^T for S, P_pred and I - K H and the gain
// for the Joseph form) go through shared memory, a warp barrier apart (a
// track's lanes share one warp), and P_post and x_post leave through it
// as coalesced stores. Every output element is summed by one lane in the
// first design's order, with the same expressions (so the same
// multiply-adds), so the bytes are the first design's; S, the Cholesky
// and the NIS are computed alike by every lane of a track.
// F and Q travel in the kernel parameters (constant bank), r as a scalar.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;

struct EkfConsts {
  float F[36];
  float Q[36];
};

template <int N, int G>
__global__ void __launch_bounds__(kThreads)
ekf_kernel(const float* __restrict__ x, const float* __restrict__ P,
           const float* __restrict__ y, const float* __restrict__ H,
           int h_per_track, int z_mode, EkfConsts c, float r, int K,
           float* __restrict__ xo, float* __restrict__ Po,
           float* __restrict__ nis, float* __restrict__ xpo,
           float* __restrict__ Ppo) {
  static_assert(32 % G == 0 && G >= N, "a track's lanes in one warp");
  constexpr int T = kThreads / G;          // tracks a block
  constexpr int NN = N * N;
  __shared__ float sP[T * NN];     // P, then P_post
  __shared__ float sPp[T * NN];    // P_pred
  __shared__ float sA[T * NN];     // I - K H
  __shared__ float sx[T * N];      // x, then x_post
  __shared__ float sxp[T * N];     // x_pred
  __shared__ float sy[T * 2];
  __shared__ float sH[T * 2 * N];
  __shared__ float sPH[T * N * 2]; // P_pred H^T
  __shared__ float sK[T * N * 2];  // the gain
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * T, nt = min(T, K - k0);
  for (int i = tid; i < nt * NN; i += kThreads) sP[i] = P[(long)k0 * NN + i];
  for (int i = tid; i < nt * N; i += kThreads) sx[i] = x[(long)k0 * N + i];
  for (int i = tid; i < nt * 2; i += kThreads) sy[i] = y[2L * k0 + i];
  if (h_per_track) {
    for (int i = tid; i < nt * 2 * N; i += kThreads)
      sH[i] = H[2L * N * k0 + i];
  } else {
    for (int i = tid; i < T * 2 * N; i += kThreads) sH[i] = H[i % (2 * N)];
  }
  __syncthreads();
  const int t = tid / G, i = tid - t * G;
  const bool on = t < nt && i < N;
  const float* Ps = sP + t * NN;
  const float* xs = sx + t * N;
  const float* Hm = sH + t * 2 * N;

  // ---- predict: row i ----
  float xp = 0.f, Pp[N];
  if (on) {
#pragma unroll
    for (int j = 0; j < N; ++j) xp += c.F[i * N + j] * xs[j];
    float FP[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) acc += c.F[i * N + m] * Ps[m * N + j];
      FP[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) acc += FP[m] * c.F[j * N + m];
      Pp[j] = acc + c.Q[i * N + j];
      sPp[t * NN + i * N + j] = Pp[j];
    }
    sxp[t * N + i] = xp;
    // ---- row i of P_pred H^T ----
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) acc += Pp[j] * Hm[a * N + j];
      sPH[(t * N + i) * 2 + a] = acc;
    }
  }
  __syncwarp();      // a track's lanes share one warp (G divides 32)

  float Kg0 = 0.f, Kg1 = 0.f, y0 = 0.f, y1 = 0.f;
  if (on) {
    const float* PHt = sPH + t * N * 2;
    y0 = sy[2 * t];
    y1 = sy[2 * t + 1];
    if (z_mode) {           // y = z - H x_pred
      float h0 = 0.f, h1 = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        h0 += Hm[j] * sxp[t * N + j];
        h1 += Hm[N + j] * sxp[t * N + j];
      }
      y0 = y0 - h0;
      y1 = y1 - h1;
    }
    // ---- S = H P_pred H^T + r I, its Cholesky, the NIS ----
    float S[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) acc += Hm[a * N + j] * PHt[j * 2 + b];
        S[a][b] = a == b ? acc + r : acc;
      }
    const float eps = 1e-12f;
    const float l11 = sqrtf(fmaxf(S[0][0], eps));
    const float l21 = S[1][0] / l11;
    const float l22 = sqrtf(fmaxf(S[1][1] - l21 * l21, eps));
    auto solve = [&](float b0, float b1, float& z1, float& z2) {
      const float w1 = b0 / l11;
      const float w2 = (b1 - l21 * w1) / l22;
      z2 = w2 / l22;
      z1 = (w1 - l21 * z2) / l11;
    };
    if (i == 0) {
      float a0, a1;
      solve(y0, y1, a0, a1);
      nis[k0 + t] = y0 * a0 + y1 * a1;
    }
    // ---- row i of the gain, x_post and I - K H ----
    solve(PHt[i * 2], PHt[i * 2 + 1], Kg0, Kg1);
    sK[(t * N + i) * 2] = Kg0;
    sK[(t * N + i) * 2 + 1] = Kg1;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float kh = Kg0 * Hm[j] + Kg1 * Hm[N + j];
      sA[t * NN + i * N + j] = (i == j ? 1.f : 0.f) - kh;
    }
  }
  __syncwarp();
  if (on) {
    sx[t * N + i] = xp + Kg0 * y0 + Kg1 * y1;
    // ---- Joseph form, row i: (I - K H) P_pred (I - K H)^T + r K K^T ----
    const float* A = sA + t * NN;
    const float* Ppt = sPp + t * NN;
    const float* Kt = sK + t * N * 2;
    float AP[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) acc += A[i * N + m] * Ppt[m * N + j];
      AP[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) acc += AP[m] * A[j * N + m];
      sP[t * NN + i * N + j] =
          acc + r * (Kg0 * Kt[j * 2] + Kg1 * Kt[j * 2 + 1]);
    }
  }
  __syncthreads();
  for (int q = tid; q < nt * NN; q += kThreads) Po[(long)k0 * NN + q] = sP[q];
  for (int q = tid; q < nt * N; q += kThreads) xo[(long)k0 * N + q] = sx[q];
  if (Ppo) {
    for (int q = tid; q < nt * NN; q += kThreads)
      Ppo[(long)k0 * NN + q] = sPp[q];
    for (int q = tid; q < nt * N; q += kThreads)
      xpo[(long)k0 * N + q] = sxp[q];
  }
}

}  // namespace

// x (K, n), P (K, n, n), y (K, 2) the residual against the prediction, or
// with z_mode the measurement z, H (2, n) or (K, 2, n) [h_per_track],
// F/Q host arrays (n, n); outputs xo (K, n), Po (K, n, n), nis (K,) and,
// unless null, x_pred (K, n) and P_pred (K, n, n). n is 4 or 6.
KH_API int kh_ekf_step(const void* x, const void* P, const void* y,
                       const void* H, int h_per_track, int z_mode,
                       const void* F_host, const void* Q_host, float r,
                       int n, int K, void* xo, void* Po, void* nis,
                       void* x_pred, void* P_pred, void* stream) {
  if (K <= 0 || (n != 4 && n != 6) || (!x_pred) != (!P_pred))
    return static_cast<int>(cudaErrorInvalidValue);
  EkfConsts c = {};
  const float* Fh = static_cast<const float*>(F_host);
  const float* Qh = static_cast<const float*>(Q_host);
  for (int i = 0; i < n * n; ++i) {
    c.F[i] = Fh[i];
    c.Q[i] = Qh[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fx = static_cast<const float*>(x);
  auto fP = static_cast<const float*>(P);
  auto fy = static_cast<const float*>(y);
  auto fH = static_cast<const float*>(H);
  auto oxo = static_cast<float*>(xo);
  auto oPo = static_cast<float*>(Po);
  auto onis = static_cast<float*>(nis);
  auto oxp = static_cast<float*>(x_pred);
  auto oPp = static_cast<float*>(P_pred);
  if (n == 4) {
    ekf_kernel<4, 4><<<kh::cdiv(K, kThreads / 4), kThreads, 0, s>>>(
        fx, fP, fy, fH, h_per_track, z_mode, c, r, K, oxo, oPo, onis, oxp,
        oPp);
  } else {
    ekf_kernel<6, 8><<<kh::cdiv(K, kThreads / 8), kThreads, 0, s>>>(
        fx, fP, fy, fH, h_per_track, z_mode, c, r, K, oxo, oPo, onis, oxp,
        oPp);
  }
  return static_cast<int>(cudaGetLastError());
}
