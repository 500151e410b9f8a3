// Polynomial-expansion device code shared by K3 (csrc/polyexp.cu) and
// K4 (csrc/level_image.cu).
#pragma once

#include "common.cuh"

namespace kh {

// Expands the (h, w) image read from `src` (src_h x src_w, row-major)
// into 5 planes (5, h, w) of OutT = float or bf16 (out_bf16). Output pixel
// (r, c) correlates src rows/cols clamp(r + k + off), k in [0, 2n]:
// off = -n is the replicate border of an unpadded image (K3), off = 0 the
// valid-mode expansion of an image already padded by n (K4).
// taps_host = [g, xg, xxg (2n+1 each), ig11, ig03, ig33, ig55], f32.
int launch_polyexp(const float* src, int src_h, int src_w, int off, int h,
                   int w, const float* taps_host, int n, int out_bf16,
                   void* out, cudaStream_t stream);

}  // namespace kh
