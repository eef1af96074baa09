// Shared helpers of the crfp_torch kernels: float <-> storage type
// conversion, the clamp's derivative and the error-string export every
// kernel library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace crfp {

template <typename T> __device__ __forceinline__ float load_f(const T* p);
template <> __device__ __forceinline__ float load_f<float>(const float* p) {
  return __ldg(p);
}
template <> __device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <typename T> __device__ __forceinline__ T store_f(float v);
template <> __device__ __forceinline__ float store_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// torch.clamp's derivative: passes where -D <= v <= D (D < 0: no clamp)
__device__ __forceinline__ float clamp_pass(float v, float D) {
  return (D < 0.f || (v >= -D && v <= D)) ? 1.f : 0.f;
}

}  // namespace crfp

// cudaGetErrorString for the Python wrapper's message (ctypes has no cudart)
#define CRFP_EXPORT_ERROR_STRING                                   \
  extern "C" const char* crfp_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
