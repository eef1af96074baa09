// Shared helpers of the crfp_torch kernels: float <-> storage type
// conversion, the window clamp and its derivative, the device code kernels
// A (dcn_fwd.cu) and E (dcn_fused.cu) share (bilinear corner sampling with
// zeros outside the frame, the weight tile in shared memory), and the
// error-string export every kernel library carries.
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

// the window: clamp to +-D (D < 0: no clamp)
__device__ __forceinline__ float clamp_window(float v, float D) {
  return D >= 0.f ? fminf(fmaxf(v, -D), D) : v;
}

// torch.clamp's derivative: passes where -D <= v <= D (D < 0: no clamp)
__device__ __forceinline__ float clamp_pass(float v, float D) {
  return (D < 0.f || (v >= -D && v <= D)) ? 1.f : 0.f;
}

// The four corners of a bilinear sample at (sy, sx) in an (H, W) plane:
// their weights, which of them lie inside the frame, and the flat index of
// the top-left one. Built once per (pixel, tap), used for every channel.
struct Corners {
  float w00, w01, w10, w11;
  bool v00, v01, v10, v11;
  long long i00;
};

__device__ __forceinline__ Corners corners_at(float sy, float sx, int H, int W) {
  const float y0f = floorf(sy);
  const float x0f = floorf(sx);
  const float fy = sy - y0f;
  const float fx = sx - x0f;
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  Corners c;
  c.w00 = (1.f - fy) * (1.f - fx);
  c.w01 = (1.f - fy) * fx;
  c.w10 = fy * (1.f - fx);
  c.w11 = fy * fx;
  c.v00 = vy0 && vx0;
  c.v01 = vy0 && vx1;
  c.v10 = vy1 && vx0;
  c.v11 = vy1 && vx1;
  c.i00 = (long long)y0 * W + x0;
  return c;
}

// the sample of one channel plane xc at the corners c, zeros outside
template <typename T>
__device__ __forceinline__ float sample_at(const T* __restrict__ xc,
                                           const Corners& c, int W) {
  float v = 0.f;
  if (c.v00) v += c.w00 * load_f(xc + c.i00);
  if (c.v01) v += c.w01 * load_f(xc + c.i00 + 1);
  if (c.v10) v += c.w10 * load_f(xc + c.i00 + W);
  if (c.v11) v += c.w11 * load_f(xc + c.i00 + W + 1);
  return v;
}

// Stage the (O, C, K2) DCN weight in shared memory as ws[(k*C + c)*O + o],
// so that a thread's inner loop over o reads one broadcast address per
// step; ends in __syncthreads().
template <int O>
__device__ __forceinline__ void stage_weight(float* ws,
                                             const float* __restrict__ weight,
                                             int C, int K2) {
  const int nw = O * C * K2;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int k = i % K2;
    const int c = (i / K2) % C;
    const int o = i / (K2 * C);
    ws[(k * C + c) * O + o] = weight[i];
  }
  __syncthreads();
}

}  // namespace crfp

// cudaGetErrorString for the Python wrapper's message (ctypes has no cudart)
#define CRFP_EXPORT_ERROR_STRING                                   \
  extern "C" const char* crfp_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
