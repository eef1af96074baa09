// Kernel B: windowed backward flow warp, NCHW.
//
// Replaces crfp_tpu/ops/pallas/warp.py::flow_warp_windowed_pallas (:29) and
// flow_warp_windowed_pallas_s2d (:55), which run the DCN kernel
// crfp_tpu/ops/pallas/dcn.py::_dcn_kernel (:59) at k=1 with an identity
// weight. Semantics of crfp_torch/ops/warp.py::flow_warp_windowed_ref: the
// flow (dx, dy) is clamped to +-D (D < 0: no clamp) and x is sampled
// bilinearly at (y + dy, x + dx), zeros outside the frame.
//
// Design: one thread per (pixel, block of kCBlock channels). The thread
// reads the pixel's flow once, computes the four corner weights once and
// blends every channel of its block; a k=1 DCN would spend a C x C
// identity contraction on every pixel.
//
// Bound on the H100 at the main-path shapes: HR state (1,4,720,720) bf16
// 4.1 MB + flow (1,2,720,720) f32 4.1 MB + out 4.1 MB = 12.4 MB, ~3.7 us at
// 3.35 TB/s; lv states (1,24,180,180) bf16 1.6 MB + flow 0.26 MB + out
// 1.6 MB = 3.4 MB, ~1.0 us. Bytes bound both; reads and writes are
// coalesced along the row, and the corner gathers of neighbouring
// threads fall in the same cache lines for smooth flow.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flow_warp_kernel(const T* __restrict__ x, const float* __restrict__ flow,
                 T* __restrict__ out, int C, int H, int W, float D) {
  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int c0 = blockIdx.y * kCBlock;
  const int n = blockIdx.z;
  const int py = (int)(p / W);
  const int px = (int)(p % W);
  float dx = flow[(long long)n * 2 * HW + p];
  float dy = flow[(long long)n * 2 * HW + HW + p];
  if (D >= 0.f) {
    dx = fminf(fmaxf(dx, -D), D);
    dy = fminf(fmaxf(dy, -D), D);
  }
  const float sx = (float)px + dx;
  const float sy = (float)py + dy;
  const float y0f = floorf(sy);
  const float x0f = floorf(sx);
  const float fy = sy - y0f;
  const float fx = sx - x0f;
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
  const float w10 = fy * (1.f - fx), w11 = fy * fx;
  const long long i00 = (long long)y0 * W + x0;
  const int c1 = min(C, c0 + kCBlock);
  for (int c = c0; c < c1; ++c) {
    const T* xc = x + ((long long)n * C + c) * HW;
    const float v00 = (vy0 && vx0) ? crfp::load_f(xc + i00) : 0.f;
    const float v01 = (vy0 && vx1) ? crfp::load_f(xc + i00 + 1) : 0.f;
    const float v10 = (vy1 && vx0) ? crfp::load_f(xc + i00 + W) : 0.f;
    const float v11 = (vy1 && vx1) ? crfp::load_f(xc + i00 + W + 1) : 0.f;
    out[((long long)n * C + c) * HW + p] =
        crfp::store_f<T>(v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* flow, void* out, int N, int C,
                   int H, int W, float D, cudaStream_t s) {
  const long long HW = (long long)H * W;
  dim3 grid((unsigned)((HW + kThreads - 1) / kThreads),
            (unsigned)((C + kCBlock - 1) / kCBlock), (unsigned)N);
  flow_warp_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), flow, static_cast<T*>(out), C, H, W, D);
  return cudaGetLastError();
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// x: (N, C, H, W) f32 or bf16 (x_bf16); flow (N, 2, H, W) f32, channels
// (dx, dy); out (N, C, H, W) in x's type. All contiguous.
extern "C" int crfp_flow_warp(const void* x, const void* flow, void* out,
                              int N, int C, int H, int W, float D, int x_bf16,
                              void* stream) {
  const float* f = static_cast<const float*>(flow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = x_bf16
                      ? launch<__nv_bfloat16>(x, f, out, N, C, H, W, D, s)
                      : launch<float>(x, f, out, N, C, H, W, D, s);
  return (int)e;
}
