// Shared helpers for the port's CUDA kernels (plain C interface, bound
// with ctypes from kernels/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <mutex>

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

constexpr int kMaxDevices = 64;

// The dynamic shared memory a kernel may take is an attribute of the
// function on each device. A launcher keeps one SmemGrant a kernel (a
// static local): it records the grant per device ordinal and only raises
// it, under its lock, so a process on several cards, or launching from
// several threads, never skips a card that lacks the grant, and the warm
// calls a CUDA graph captures make no attribute call. carveout > 0 also
// sets the kernel's shared-memory carveout to the least share of the SM's
// shared memory that holds `carveout` bytes (the rest stays L1).
class SmemGrant {
 public:
  template <typename Kernel>
  cudaError_t allow(Kernel kern, int smem, long carveout = 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const std::lock_guard<std::mutex> hold(lock_);
    if (dev < kMaxDevices && smem <= granted_[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && carveout > 0) {
      int cap = 0;     // shared memory an SM can give, bytes
      err = cudaDeviceGetAttribute(
          &cap, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributePreferredSharedMemoryCarveout,
            static_cast<int>(carveout >= cap
                                 ? 100 : (100 * carveout + cap - 1) / cap));
    }
    if (err == cudaSuccess && dev < kMaxDevices) granted_[dev] = smem;
    return err;
  }

 private:
  std::mutex lock_;
  int granted_[kMaxDevices] = {};
};

}  // namespace kh
