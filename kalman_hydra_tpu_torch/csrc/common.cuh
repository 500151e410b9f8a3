// Shared helpers for the port's CUDA kernels (plain C interface, bound
// with ctypes from kernels/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define KH_API extern "C" __attribute__((visibility("default")))

namespace kh {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Loads widen to f32; all arithmetic in the port's kernels is f32.
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// bf16 stores round to nearest even, as torch's .to(torch.bfloat16) does.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

inline unsigned cdiv(long a, long b) { return (unsigned)((a + b - 1) / b); }

}  // namespace kh
