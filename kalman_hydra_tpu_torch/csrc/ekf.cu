// K1: fused EKF predict + position update for a batch of tracks.
//
// Replaces kalman_hydra_tpu/kernels/ekf_pallas.py::ekf_fused_step
// (_ekf_kernel). Per track: x <- F x, P <- F P F^T + Q, S = H P H^T + r I
// (2x2), closed-form 2x2 Cholesky with the 1e-12 clamps, gain
// K = P H^T S^-1, x update, Joseph-form P, and NIS = y^T S^-1 y.
// y is the residual against the PREDICTED state; the kernel runs its own
// predict from the pre-predict state (models/ekf.py ekf_step contract).
//
// Bound on Hopper: at K = 1024, n = 6 the kernel moves ~200 KB and does
// ~3k FLOPs per track — launch latency dominates; neither memory nor
// compute is near its roof. Design: one thread per track with the state
// dimension a template parameter, so every n x n product is unrolled into
// registers (no shared memory, no synchronisation); the ragged tail is a
// bounds check instead of the TPU's (8, 128) lane padding. F and Q travel
// in the kernel parameters (constant bank), r as a scalar.
#include "common.cuh"

namespace {

struct EkfConsts {
  float F[36];
  float Q[36];
};

template <int N>
__global__ void ekf_kernel(const float* __restrict__ x,
                           const float* __restrict__ P,
                           const float* __restrict__ y,
                           const float* __restrict__ H, int h_per_track,
                           EkfConsts c, float r, int K,
                           float* __restrict__ xo, float* __restrict__ Po,
                           float* __restrict__ nis) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float xs[N], Ps[N][N], Hm[2][N];
  for (int i = 0; i < N; ++i) xs[i] = x[k * N + i];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) Ps[i][j] = P[(k * N + i) * N + j];
  const float* hk = H + (h_per_track ? k * 2 * N : 0);
  for (int a = 0; a < 2; ++a)
    for (int j = 0; j < N; ++j) Hm[a][j] = hk[a * N + j];
  const float y0 = y[2 * k], y1 = y[2 * k + 1];

  // ---- predict ----
  float xp[N], FP[N][N], Pp[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) acc += c.F[i * N + j] * xs[j];
    xp[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) acc += c.F[i * N + m] * Ps[m][j];
      FP[i][j] = acc;
    }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) acc += FP[i][m] * c.F[j * N + m];
      Pp[i][j] = acc + c.Q[i * N + j];
    }

  // ---- innovation covariance S = H Pp H^T + r I ----
  float PHt[N][2];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) acc += Pp[i][j] * Hm[a][j];
      PHt[i][a] = acc;
    }
  float S[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) acc += Hm[a][j] * PHt[j][b];
      S[a][b] = a == b ? acc + r : acc;
    }

  // ---- closed-form 2x2 Cholesky (eps clamps of ekf_pallas.py) ----
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
  float a0, a1;
  solve(y0, y1, a0, a1);
  nis[k] = y0 * a0 + y1 * a1;

  float Kg[N][2];
#pragma unroll
  for (int i = 0; i < N; ++i) solve(PHt[i][0], PHt[i][1], Kg[i][0], Kg[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    xo[k * N + i] = xp[i] + Kg[i][0] * y0 + Kg[i][1] * y1;

  // ---- Joseph form: (I - K H) Pp (I - K H)^T + r K K^T ----
  float A[N][N], AP[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float kh = Kg[i][0] * Hm[0][j] + Kg[i][1] * Hm[1][j];
      A[i][j] = (i == j ? 1.f : 0.f) - kh;
    }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) acc += A[i][m] * Pp[m][j];
      AP[i][j] = acc;
    }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) acc += AP[i][m] * A[j][m];
      Po[(k * N + i) * N + j] =
          acc + r * (Kg[i][0] * Kg[j][0] + Kg[i][1] * Kg[j][1]);
    }
}

}  // namespace

// x (K, n), P (K, n, n), y (K, 2), H (2, n) or (K, 2, n) [h_per_track],
// F/Q host arrays (n, n); outputs xo (K, n), Po (K, n, n), nis (K,).
KH_API int kh_ekf_step(const void* x, const void* P, const void* y,
                       const void* H, int h_per_track, const void* F_host,
                       const void* Q_host, float r, int n, int K, void* xo,
                       void* Po, void* nis, void* stream) {
  EkfConsts c = {};
  const float* Fh = static_cast<const float*>(F_host);
  const float* Qh = static_cast<const float*>(Q_host);
  for (int i = 0; i < n * n; ++i) {
    c.F[i] = Fh[i];
    c.Q[i] = Qh[i];
  }
  const int threads = 128;
  const dim3 grid(kh::cdiv(K, threads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fx = static_cast<const float*>(x);
  auto fP = static_cast<const float*>(P);
  auto fy = static_cast<const float*>(y);
  auto fH = static_cast<const float*>(H);
  auto oxo = static_cast<float*>(xo);
  auto oPo = static_cast<float*>(Po);
  auto onis = static_cast<float*>(nis);
  if (n == 4) {
    ekf_kernel<4><<<grid, threads, 0, s>>>(fx, fP, fy, fH, h_per_track, c, r,
                                           K, oxo, oPo, onis);
  } else if (n == 6) {
    ekf_kernel<6><<<grid, threads, 0, s>>>(fx, fP, fy, fH, h_per_track, c, r,
                                           K, oxo, oPo, onis);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
