#include "common.cuh"

KH_API const char* kh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
