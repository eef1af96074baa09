// Kernel D at k=1 (the warp): windowed backward flow warp, backward pass,
// NCHW.
//
// Replaces crfp_tpu/ops/pallas/dcn.py::_dcn_bwd_kernel (:219, pallas_call in
// _bwd_call :593) where crfp_tpu/ops/pallas/warp.py::flow_warp_windowed_pallas
// (:29) runs it at k=1 with an identity weight and no mask. The forward is
// kernel B (csrc/flow_warp.cu): out[c,p] = bilinear sample of x[c] at
// p + clamp(flow(p), +-D), zeros outside the frame. Backward:
//   dx        : grad_out[c,p] times each corner weight, scattered with
//               atomicAdd into an f32 buffer (the wrapper casts it to x's
//               type);
//   d flow_x  = sum_c grad_out[c,p] dv_c/dsx, and d flow_y likewise, times
//               torch's clamp derivative (1 where |flow| <= D, else 0).
//
// Design: one thread per output pixel (over N*H*W) that reads its flow and
// builds the corner weights once, then walks every channel, so the flow
// gradient is a sum in registers and needs no atomics. The window
// cotangents the TPU kernel overlap-adds are scattered here.
//
// Bound on the H100 at the training shapes (bf16 activations): HR state
// (2,4,192,192) bf16 0.59 MB + flow f32 0.59 MB + grad_out 0.59 MB in, dx
// 0.59 MB + d-flow 0.59 MB out = 2.9 MB, ~0.9 us at 3.35 TB/s; lv3_state
// (2,32,48,48) 1.0 MB (~0.3 us); lv states (2,24,48,48) 0.8 MB. Bytes bound
// all three; grad_out and flow reads are coalesced along the row, and the
// corner atomics of neighbouring threads fall in the same cache lines for
// smooth flow.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flow_warp_bwd_kernel(const T* __restrict__ x, const float* __restrict__ flow,
                     const T* __restrict__ gout, float* __restrict__ dx,
                     float* __restrict__ dflow, int N, int C, int H, int W,
                     float D) {
  const long long HW = (long long)H * W;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)N * HW) return;
  const int n = (int)(q / HW);
  const long long p = q % HW;
  const int py = (int)(p / W);
  const int px = (int)(p % W);
  const float fx_raw = flow[(long long)n * 2 * HW + p];
  const float fy_raw = flow[(long long)n * 2 * HW + HW + p];
  float dxv = fx_raw, dyv = fy_raw;
  if (D >= 0.f) {
    dxv = fminf(fmaxf(dxv, -D), D);
    dyv = fminf(fmaxf(dyv, -D), D);
  }
  const float sx = (float)px + dxv;
  const float sy = (float)py + dyv;
  const float y0f = floorf(sy);
  const float x0f = floorf(sx);
  const float fy = sy - y0f;
  const float fx = sx - x0f;
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const bool b00 = vy0 && vx0, b01 = vy0 && vx1, b10 = vy1 && vx0, b11 = vy1 && vx1;
  const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
  const float w10 = fy * (1.f - fx), w11 = fy * fx;
  const long long i00 = (long long)y0 * W + x0;
  float gsx = 0.f, gsy = 0.f;
  for (int c = 0; c < C; ++c) {
    const long long cHW = ((long long)n * C + c) * HW;
    const float g = crfp::load_f(gout + cHW + p);
    if (g == 0.f) continue;
    const T* xc = x + cHW;
    const float v00 = b00 ? crfp::load_f(xc + i00) : 0.f;
    const float v01 = b01 ? crfp::load_f(xc + i00 + 1) : 0.f;
    const float v10 = b10 ? crfp::load_f(xc + i00 + W) : 0.f;
    const float v11 = b11 ? crfp::load_f(xc + i00 + W + 1) : 0.f;
    gsx = fmaf(g, (1.f - fy) * (v01 - v00) + fy * (v11 - v10), gsx);
    gsy = fmaf(g, (1.f - fx) * (v10 - v00) + fx * (v11 - v01), gsy);
    float* dxc = dx + cHW;
    if (b00) atomicAdd(dxc + i00, g * w00);
    if (b01) atomicAdd(dxc + i00 + 1, g * w01);
    if (b10) atomicAdd(dxc + i00 + W, g * w10);
    if (b11) atomicAdd(dxc + i00 + W + 1, g * w11);
  }
  dflow[(long long)n * 2 * HW + p] = crfp::clamp_pass(fx_raw, D) * gsx;
  dflow[(long long)n * 2 * HW + HW + p] = crfp::clamp_pass(fy_raw, D) * gsy;
}

template <typename T>
cudaError_t launch(const void* x, const float* flow, const void* gout,
                   float* dx, float* dflow, int N, int C, int H, int W,
                   float D, cudaStream_t s) {
  const long long NHW = (long long)N * H * W;
  dim3 grid((unsigned)((NHW + kThreads - 1) / kThreads));
  flow_warp_bwd_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), flow, static_cast<const T*>(gout), dx, dflow,
      N, C, H, W, D);
  return cudaGetLastError();
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// x: (N, C, H, W) f32 or bf16 (x_bf16); flow (N, 2, H, W) f32, channels
// (dx, dy); grad_out (N, C, H, W) in x's type. Outputs f32: dx (N, C, H, W),
// zeroed by the caller (atomics), and d_flow (N, 2, H, W), every element
// written. All contiguous.
extern "C" int crfp_flow_warp_bwd(const void* x, const void* flow,
                                  const void* grad_out, void* dx,
                                  void* d_flow, int N, int C, int H, int W,
                                  float D, int x_bf16, void* stream) {
  const float* f = static_cast<const float*>(flow);
  float* gx = static_cast<float*>(dx);
  float* gf = static_cast<float*>(d_flow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      x_bf16 ? launch<__nv_bfloat16>(x, f, grad_out, gx, gf, N, C, H, W, D, s)
             : launch<float>(x, f, grad_out, gx, gf, N, C, H, W, D, s);
  return (int)e;
}
