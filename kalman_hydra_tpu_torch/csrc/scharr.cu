// K10: the pyrLK Scharr derivatives gx and gy of every level of a
// pyramid, in ONE launch.
//
// Replaces kalman_hydra_tpu/kernels/scharr_pallas.py::scharr_gradients
// (_scharr_kernel): gx = smooth_y(edge_x f), gy = edge_y(smooth_x f),
// edge [-1, 0, 1], smooth [3, 10, 3] / 32, replicate border, f32. The
// XLA version runs four correlate1d passes, each with its own padded copy
// in device memory; the TPU kernel keeps the intermediates in VMEM and
// runs once per level. Here nothing but the levels and their two planes
// touches device memory, and one launch covers every level.
//
// Arithmetic order is the plain version's (two ops.filters.correlate1d
// passes per gradient), each tap a multiply then an add in tap order,
// without FMAs; the edge taps' -1, 0 and 1 products are exact. So every
// level of a multi-level launch equals a one-level launch bit for bit.
//
// Bound on Hopper: memory. 1080p reads 8.3 MB and writes 16.6 MB (7.4 us
// at 3.35 TB/s) for ~12 FLOPs per pixel; a 5-level pyramid ~1.33x that.
// Design:
//   * a by-value table of up to kMaxLevels levels; one flattened tile
//     index walks all of them, largest level first, so the small levels'
//     tiles fill the SMs the large level's last wave leaves idle;
//   * a block stages its 16 x 128 tile and a one-pixel halo in shared
//     memory (rows and columns clamped at the load: the replicate
//     border), with 16-byte loads on the interior of a level whose width
//     is a multiple of 4 and masked scalar loads otherwise;
//   * each thread computes 4 consecutive pixels of 2 rows from the tile
//     and writes gx and gy as float4 (scalar stores on a ragged edge).
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTileW = 128;           // 32 threads x 4 pixels
constexpr int kTileH = 16;            // 8 thread rows x 2
constexpr int kStride = kTileW + 8;   // smem row: pad, halo, 128, halo, pad
constexpr int kX0 = 4;                // smem column of the tile's column 0
constexpr float kS0 = 0.09375f;       // 3 / 32
constexpr float kS1 = 0.3125f;        // 10 / 32

struct Level {
  const float* src;
  float* gx;
  float* gy;
  int h, w, tiles_x, tile0, vec;
};

struct Table {
  Level lv[kMaxLevels];
  int n;
};

__device__ __forceinline__ void edge_smooth(float a, float b, float c,
                                            float* e, float* s) {
  // -1 * a + 0 * b + 1 * c and 3/32 a + 10/32 b + 3/32 c, as
  // correlate1d sums them
  *e = __fadd_rn(__fadd_rn(-a, __fmul_rn(0.f, b)), c);
  *s = __fadd_rn(__fadd_rn(__fmul_rn(kS0, a), __fmul_rn(kS1, b)),
                 __fmul_rn(kS0, c));
}

__global__ void __launch_bounds__(256)
scharr_levels_kernel(const Table tab) {
  __shared__ __align__(16) float tile[kTileH + 2][kStride];
  int li = 0;
  while (li + 1 < tab.n && blockIdx.x >= tab.lv[li + 1].tile0) ++li;
  const Level L = tab.lv[li];
  const int t = blockIdx.x - L.tile0;
  const int x0 = (t % L.tiles_x) * kTileW, y0 = (t / L.tiles_x) * kTileH;
  const int h = L.h, w = L.w, tid = threadIdx.x;

  // stage rows y0 - 1 .. y0 + 16 and columns x0 - 1 .. x0 + 128, clamped
  for (int i = tid; i < (kTileH + 2) * (kTileW / 4); i += blockDim.x) {
    const int r = i / (kTileW / 4), g = i % (kTileW / 4);
    const float* row = L.src + (long)kh::clampi(y0 - 1 + r, 0, h - 1) * w;
    const int c = x0 + 4 * g;
    float4 v;
    if (L.vec && c < w) {
      v = __ldg(reinterpret_cast<const float4*>(row + c));
    } else {
      v.x = __ldg(row + min(c, w - 1));
      v.y = __ldg(row + min(c + 1, w - 1));
      v.z = __ldg(row + min(c + 2, w - 1));
      v.w = __ldg(row + min(c + 3, w - 1));
    }
    *reinterpret_cast<float4*>(&tile[r][kX0 + 4 * g]) = v;
  }
  for (int i = tid; i < 2 * (kTileH + 2); i += blockDim.x) {
    const int r = i >> 1, right = i & 1;
    const float* row = L.src + (long)kh::clampi(y0 - 1 + r, 0, h - 1) * w;
    tile[r][right ? kX0 + kTileW : kX0 - 1] =
        __ldg(row + (right ? min(x0 + kTileW, w - 1) : max(x0 - 1, 0)));
  }
  __syncthreads();

  const int tx = tid & 31, ty = tid >> 5;
  const int x = x0 + 4 * tx;
  if (x >= w) return;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int yl = ty + 8 * k, y = y0 + yl;
    if (y >= h) break;
    float ex[3][4], sx[3][4];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* s = &tile[yl + r][kX0 + 4 * tx];
      const float4 m = *reinterpret_cast<const float4*>(s);
      const float v[6] = {s[-1], m.x, m.y, m.z, m.w, s[4]};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        edge_smooth(v[q], v[q + 1], v[q + 2], &ex[r][q], &sx[r][q]);
    }
    float gx[4], gy[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gx[q] = __fadd_rn(__fadd_rn(__fmul_rn(kS0, ex[0][q]),
                                  __fmul_rn(kS1, ex[1][q])),
                        __fmul_rn(kS0, ex[2][q]));
      gy[q] = __fadd_rn(__fadd_rn(-sx[0][q], __fmul_rn(0.f, sx[1][q])),
                        sx[2][q]);
    }
    const long o = (long)y * w + x;
    if (L.vec) {
      *reinterpret_cast<float4*>(L.gx + o) =
          make_float4(gx[0], gx[1], gx[2], gx[3]);
      *reinterpret_cast<float4*>(L.gy + o) =
          make_float4(gy[0], gy[1], gy[2], gy[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (x + q < w) {
          L.gx[o + q] = gx[q];
          L.gy[o + q] = gy[q];
        }
      }
    }
  }
}

}  // namespace

// n levels; ptrs (host) holds src, gx, gy of each level in turn; table
// (host) holds h, w, tiles_x, tile0, vec of each level (the wrapper's
// scharr_plan; vec: w % 4 == 0 and every pointer 16-byte aligned).
KH_API int kh_scharr_levels(int n, const unsigned long long* ptrs,
                            const int* table, int tiles, void* stream) {
  if (n < 1 || n > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Table tab{};
  tab.n = n;
  for (int i = 0; i < n; ++i) {
    Level& L = tab.lv[i];
    L.src = reinterpret_cast<const float*>(ptrs[3 * i]);
    L.gx = reinterpret_cast<float*>(ptrs[3 * i + 1]);
    L.gy = reinterpret_cast<float*>(ptrs[3 * i + 2]);
    const int* e = table + 5 * i;
    L.h = e[0];
    L.w = e[1];
    L.tiles_x = e[2];
    L.tile0 = e[3];
    L.vec = e[4];
  }
  scharr_levels_kernel<<<tiles, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      tab);
  return static_cast<int>(cudaGetLastError());
}
