// K12: sparse pyramidal Lucas-Kanade for K points: every level of a frame
// step in ONE launch (the walk), or one level (the one-level launch of the
// same kernel).
//
// Replaces kalman_hydra_tpu/kernels/lk_pallas.py::lk_sparse (_lk_level,
// pallas_call :225, and the level loop around it, :256), the drop-in
// kernel of ops/lk.py::_track_point_level; with a per-point clamp window
// it also computes the reference's batched block-halo solvers
// (ops/lk.py::_lk_level_batched_corr, _klast, _lk_level_batched), which
// differ from the exact path only in where the moving guess is clamped.
// Per point and level:
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
//      span 2 * halo.
// The walk also does, coarsest level first, what ops/lk.py did between
// one-level launches (each op rounded as torch rounds it): the point
// scaled to the level and clipped to it, the guess clipped to pad // 2
// beyond it, both moved into the level's frame replicate-padded by
// `pad`, the window (the block window, or the exact one where the level
// is smaller than the halo'd block), the answer moved back out, x2
// between levels, and level 0's status ok & in-bounds.
// Coordinates in a level are those of the level image replicate-padded
// by `pad`; the padding is never built: every read clamps its index.
//
// Numerics: every elementwise step is the plain version's in its order
// with round-to-nearest intrinsics (no FMA contraction), and the window
// sums accumulate in float64 before they round to f32, in the order of
// the one-warp kernel this replaced (lane l sums samples l, l + 32, ...
// in turn, then a butterfly of warp shuffles): the products are computed
// by all the block's threads into shared memory and one warp sums them
// so, bit for bit that kernel's positions and status.
//
// Bound on Hopper: memory on paper. A 1080p frame pair at K = 1024 and
// five levels reads (win + 1)^2 floats per point and level for each of
// the three template blocks and per Gauss-Newton step; on the synthetic
// blob clip that is ~46 MB for 8,167 steps (~14 us at 3.35 TB/s, ~0.15
// GFLOP). In practice the work is latency: dependent steps of a gather,
// a reduction and a 2 x 2 solve. The one-warp-a-point kernel this
// replaced ran 8 of an SM's 64 warps at K = 1024, each step a chain of
// ~14 bilinear samples a lane, four clamped L1/L2 loads each, and one
// launch a level with 15-20 torch ops of glue between (0.1296 ms of
// kernels and 0.29 ms in all a frame pair of path H on an H100).
// Design: one 128-thread block a point walks all its levels (K = 1024 is
// 1,024 blocks, one wave); the samples of a step spread over 128 threads
// (3-4 each); at halo > 0 the level's block window of the next image,
// (win + 1 + 2 halo)^2 floats (38^2 at win 21, halo 8), is staged in
// shared memory once a level, so the steps read only shared memory; at
// halo 0 the step reads go through L1. The template and its gradients
// stay in shared memory. What it leaves (PERF.md section 6, on an H100
// 80GB HBM3 at 700 W): a frame step of path H takes ~0.08 ms on the
// device (the five one-level launches 0.13, with the glue 0.29), above
// its 0.06 target: each step is still a chain of two barriers, a
// 14-deep float64 sum on one warp and a 5-level shuffle butterfly, and
// the template's bilinear gathers come from L2.
#include "common.cuh"

namespace {

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

// the same sample from a block in shared memory: p points at its
// top-left corner, rows `stride` floats apart
__device__ __forceinline__ float bilin_s(const float* p, int stride,
                                         float fx, float fy, float cfx,
                                         float cfy) {
  float t = __fmul_rn(__fmul_rn(p[0], cfx), cfy);
  t = __fadd_rn(t, __fmul_rn(__fmul_rn(p[1], fx), cfy));
  t = __fadd_rn(t, __fmul_rn(__fmul_rn(p[stride], cfx), fy));
  return __fadd_rn(t, __fmul_rn(__fmul_rn(p[stride + 1], fx), fy));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kThreads = 128;
constexpr int kMaxLevels = 8;
constexpr int kStageMax = 48 * 48;   // floats of a staged block window

struct Walk {
  Images lv[kMaxLevels];   // level 0 (finest) first
  int levels, K, win, max_iter, halo;
  float eps2, min_eig;
  // walk: pts (K, 2) level-0 points, guess (K, 2) the coarsest level's
  // initial guess or null (pts / 2^(levels - 1)); out (K, 2) level-0
  // points, ok (K,) status. One level (walk == 0): pts and guess in the
  // padded frame, base (K, 2), span; out in the padded frame, ok the gate.
  const float* pts;
  int pts_stride;          // floats from one point to the next
  const float* guess;
  const float* base;
  float span_x, span_y;
  int walk;
  float* out;
  unsigned char* ok;
};

// (l, ...) of one level: the lane-order f64 sums of `n` products in
// shared memory, by warp 0, into `res` (shared); every thread then syncs
__device__ __forceinline__ void lane_sums(const float* p0, const float* p1,
                                          const float* p2, int n, int cnt,
                                          float* res) {
  if (threadIdx.x < 32) {
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
    for (int s = threadIdx.x; s < n; s += 32) {
      s0 += (double)p0[s];
      s1 += (double)p1[s];
      if (cnt > 2) s2 += (double)p2[s];
    }
    const float f0 = (float)warp_sum(s0);
    const float f1 = (float)warp_sum(s1);
    const float f2 = cnt > 2 ? (float)warp_sum(s2) : 0.f;
    if (threadIdx.x == 0) {
      res[0] = f0;
      res[1] = f1;
      res[2] = f2;
    }
  }
  __syncthreads();
}

// One level for the block's point: pt, guess in the padded frame, the
// clamp window (bx0, by0) + [0, span]; returns the new guess (padded
// frame) in gxp, gyp and the gate.
__device__ bool level_point(const Images& im, float ptx, float pty,
                            float& gxp, float& gyp, float bx0, float by0,
                            float span_x, float span_y, int win,
                            int max_iter, float eps2, float min_eig_thr,
                            float* smem) {
  const int n = win * win, tid = threadIdx.x;
  float* pa = smem;
  float* pgx = pa + n;
  float* pgy = pgx + n;
  float* q0 = pgy + n;
  float* q1 = q0 + n;
  float* q2 = q1 + n;
  float* res = q2 + n;                 // 4 floats: sums, then the step
  float* wnd = res + 4;                // the staged window
  const float half = (win - 1) * 0.5f;

  // ---- template patches and the structure tensor ----
  const float tx = __fsub_rn(ptx, half);
  const float ty = __fsub_rn(pty, half);
  const int ax = (int)floorf(tx), ay = (int)floorf(ty);
  const float fx = __fsub_rn(tx, (float)ax), fy = __fsub_rn(ty, (float)ay);
  const float cfx = __fsub_rn(1.f, fx), cfy = __fsub_rn(1.f, fy);
  // the block window of the next image, where it fits
  const int ww = (int)span_x + win + 1, wh = (int)span_y + win + 1;
  const bool staged = ww * wh <= kStageMax;
  const int wx0 = (int)bx0, wy0 = (int)by0;
  if (staged) {
    for (int s = tid; s < ww * wh; s += kThreads) {
      const int r = s / ww, c = s - r * ww;
      wnd[s] = padded(im.b, im, wy0 + r, wx0 + c);
    }
  }
  for (int s = tid; s < n; s += kThreads) {
    const int i = s / win, j = s - (s / win) * win;
    const float va = bilin(im.a, im, ay, ax, i, j, fx, fy, cfx, cfy);
    const float vx = bilin(im.gx, im, ay, ax, i, j, fx, fy, cfx, cfy);
    const float vy = bilin(im.gy, im, ay, ax, i, j, fx, fy, cfx, cfy);
    pa[s] = va;
    pgx[s] = vx;
    pgy[s] = vy;
    q0[s] = __fmul_rn(vx, vx);
    q1[s] = __fmul_rn(vx, vy);
    q2[s] = __fmul_rn(vy, vy);
  }
  __syncthreads();
  lane_sums(q0, q1, q2, n, 3, res);
  const float g11 = res[0], g12 = res[1], g22 = res[2];
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
    for (int s = tid; s < n; s += kThreads) {
      const int i = s / win, j = s - (s / win) * win;
      const float vb =
          staged ? bilin_s(wnd + (sy - wy0 + i) * ww + (sx - wx0 + j), ww,
                           bfx, bfy, cbx, cby)
                 : bilin(im.b, im, sy, sx, i, j, bfx, bfy, cbx, cby);
      const float diff = __fsub_rn(vb, pa[s]);
      q0[s] = __fmul_rn(diff, pgx[s]);
      q1[s] = __fmul_rn(diff, pgy[s]);
    }
    __syncthreads();
    lane_sums(q0, q1, q2, n, 2, res);
    const float f1 = res[0], f2 = res[1];
    const float dx =
        __fmul_rn(-__fsub_rn(__fmul_rn(g22, f1), __fmul_rn(g12, f2)),
                  inv_det);
    const float dy =
        __fmul_rn(-__fsub_rn(__fmul_rn(g11, f2), __fmul_rn(g12, f1)),
                  inv_det);
    gxp = __fadd_rn(gxp, dx);
    gyp = __fadd_rn(gyp, dy);
    active = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) > eps2;
    // no barrier: the next step writes q0/q1 (read by warp 0 before
    // lane_sums' barrier) and its own barrier precedes the next res
  }
  return ok;
}

__global__ void __launch_bounds__(kThreads) lk_kernel(const Walk wk) {
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  const float ptx = wk.pts[(long)k * wk.pts_stride];
  const float pty = wk.pts[(long)k * wk.pts_stride + 1];
  if (!wk.walk) {                      // one level, as given
    const Images& im = wk.lv[0];
    float gx = wk.guess[2 * k], gy = wk.guess[2 * k + 1];
    const bool ok = level_point(im, ptx, pty, gx, gy, wk.base[2 * k],
                                wk.base[2 * k + 1], wk.span_x, wk.span_y,
                                wk.win, wk.max_iter, wk.eps2, wk.min_eig,
                                smem);
    if (threadIdx.x == 0) {
      wk.out[2 * k] = gx;
      wk.out[2 * k + 1] = gy;
      wk.ok[k] = ok ? 1 : 0;
    }
    return;
  }
  const int win = wk.win, pad = (win - 1) / 2 + 2, D = wk.halo;
  const float half = (win - 1) * 0.5f;
  const float top = 1.f / (float)(1 << (wk.levels - 1));
  float gx = wk.guess ? wk.guess[2 * k] : __fmul_rn(ptx, top);
  float gy = wk.guess ? wk.guess[2 * k + 1] : __fmul_rn(pty, top);
  bool status = true;
  for (int l = wk.levels - 1; l >= 0; --l) {
    const Images& im = wk.lv[l];
    const float sc = 1.f / (float)(1 << l);
    const float w1 = (float)(im.w - 1), h1 = (float)(im.h - 1);
    const float ppx =
        __fadd_rn(fminf(fmaxf(__fmul_rn(ptx, sc), 0.f), w1), (float)pad);
    const float ppy =
        __fadd_rn(fminf(fmaxf(__fmul_rn(pty, sc), 0.f), h1), (float)pad);
    const float lo = -(float)(pad / 2);
    float gpx = __fadd_rn(fminf(fmaxf(gx, lo), w1 + (float)(pad / 2)),
                          (float)pad);
    float gpy = __fadd_rn(fminf(fmaxf(gy, lo), h1 + (float)(pad / 2)),
                          (float)pad);
    const int hp = im.h + 2 * pad, wp = im.w + 2 * pad;
    const int bb = win + 1 + 2 * D;
    float bx0 = 0.f, by0 = 0.f;
    float span_x = (float)(wp - win - 2), span_y = (float)(hp - win - 2);
    if (D > 0 && min(hp, wp) >= bb) {
      const long long fx = (long long)floorf(__fsub_rn(gpx, half)) - D;
      const long long fy = (long long)floorf(__fsub_rn(gpy, half)) - D;
      bx0 = (float)min(max(fx, 0LL), (long long)(wp - bb));
      by0 = (float)min(max(fy, 0LL), (long long)(hp - bb));
      span_x = span_y = (float)(2 * D);
    }
    const bool ok = level_point(im, ppx, ppy, gpx, gpy, bx0, by0, span_x,
                                span_y, win, wk.max_iter, wk.eps2,
                                wk.min_eig, smem);
    gx = __fsub_rn(gpx, (float)pad);
    gy = __fsub_rn(gpy, (float)pad);
    if (l == 0) {
      status = ok && gx >= 0.f && gx <= w1 && gy >= 0.f && gy <= h1;
    } else {
      gx = __fmul_rn(gx, 2.f);
      gy = __fmul_rn(gy, 2.f);
    }
  }
  if (threadIdx.x == 0) {
    wk.out[2 * k] = gx;
    wk.out[2 * k + 1] = gy;
    wk.ok[k] = status ? 1 : 0;
  }
}

size_t smem_bytes(int win) {
  return sizeof(float) * (6 * win * win + 4 + kStageMax);
}

int launch(const Walk& wk, cudaStream_t s) {
  if (wk.K <= 0 || wk.levels < 1 || wk.levels > kMaxLevels || wk.win < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(wk.win);
  static kh::SmemGrant grant;
  const cudaError_t e = grant.allow(lk_kernel, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  lk_kernel<<<wk.K, kThreads, smem, s>>>(wk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One level: the level's images (h, w) f32; pt, guess, base (K, 2) f32 in
// the frame padded by `pad`; out (K, 2) in that frame, ok (K,) the gate.
KH_API int kh_lk_level(const void* a, const void* b, const void* gx,
                       const void* gy, int h, int w, int pad, const void* pt,
                       const void* guess, const void* base, float span_x,
                       float span_y, int K, int win, int max_iter, float eps2,
                       float min_eig, void* out, void* ok, void* stream) {
  Walk wk{};
  wk.lv[0] = Images{static_cast<const float*>(a),
                    static_cast<const float*>(b),
                    static_cast<const float*>(gx),
                    static_cast<const float*>(gy), h, w, pad};
  wk.levels = 1;
  wk.K = K;
  wk.win = win;
  wk.max_iter = max_iter;
  wk.eps2 = eps2;
  wk.min_eig = min_eig;
  wk.pts = static_cast<const float*>(pt);
  wk.pts_stride = 2;
  wk.guess = static_cast<const float*>(guess);
  wk.base = static_cast<const float*>(base);
  wk.span_x = span_x;
  wk.span_y = span_y;
  wk.walk = 0;
  wk.out = static_cast<float*>(out);
  wk.ok = static_cast<unsigned char*>(ok);
  return launch(wk, static_cast<cudaStream_t>(stream));
}

// The walk: levels 0 .. levels - 1 (finest first), ptrs[4 l ..] = a, b,
// gx, gy of level l and dims[2 l ..] = its (h, w); pts (K, 2) level-0
// points, pts_stride floats apart (a column slice of the filter state
// needs no copy); guess (K, 2) the coarsest level's initial guess or
// null; out (K, 2) the level-0 points, status (K,).
KH_API int kh_lk_levels(const unsigned long long* ptrs, const int* dims,
                        int levels, const void* pts, int pts_stride,
                        const void* guess,
                        int K, int win, int max_iter, float eps2,
                        float min_eig, int halo, void* out, void* status,
                        void* stream) {
  if (levels < 1 || levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Walk wk{};
  const int pad = (win - 1) / 2 + 2;
  for (int l = 0; l < levels; ++l)
    wk.lv[l] = Images{reinterpret_cast<const float*>(ptrs[4 * l]),
                      reinterpret_cast<const float*>(ptrs[4 * l + 1]),
                      reinterpret_cast<const float*>(ptrs[4 * l + 2]),
                      reinterpret_cast<const float*>(ptrs[4 * l + 3]),
                      dims[2 * l], dims[2 * l + 1], pad};
  wk.levels = levels;
  wk.K = K;
  wk.win = win;
  wk.max_iter = max_iter;
  wk.halo = halo;
  wk.eps2 = eps2;
  wk.min_eig = min_eig;
  wk.pts = static_cast<const float*>(pts);
  wk.pts_stride = pts_stride;
  wk.guess = static_cast<const float*>(guess);
  wk.walk = 1;
  wk.out = static_cast<float*>(out);
  wk.ok = static_cast<unsigned char*>(status);
  return launch(wk, static_cast<cudaStream_t>(stream));
}
