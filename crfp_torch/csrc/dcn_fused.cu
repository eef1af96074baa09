// Kernel E: the per-tap windowed DCNv2 forward straight from the offset and
// mask heads' raw conv outputs ("fused prep"), NCHW, inference only.
//
// Replaces crfp_tpu/ops/pallas/dcn.py::_dcn_kernel_fusedprep (:1468,
// pallas_call :1659, entry deform_conv2d_pallas_fusedprep :1667) together
// with the epilogue the JAX package leaves to XLA around it
// (crfp_tpu/nn/align.py:281, :292-296): from raw_off channel
// (g*K2 + k)*2 + {0: dy, 1: dx}, raw_mask channel g*K2 + k and the f32 flow
// (dx, dy),
//
//   dy = clip(mag * tanh(raw_off[.., 0]) + flow[1], -D, +D)
//   dx = clip(mag * tanh(raw_off[.., 1]) + flow[0], -D, +D)
//   m  = sigmoid(raw_mask)
//   out[o, p] = bias[o] + sum_{g, k, c in g} W[o, c, k] * m *
//               bilinear(x[c], p + p_k + (dy, dx))        (zeros outside)
//
// in one launch, f32 arithmetic and accumulation, written in x's type. The
// plain version is crfp_torch/ops/dcn_windowed.py::deform_conv2d_fusedprep_ref.
// The TPU kernel builds its query geometry block by block in fast memory
// because its matrix unit does the gathers; none of that carries over:
// Hopper gathers natively, so this is kernel A's loop (common.cuh: corner
// sampling, clamp, weight tile) with the prologue computed per (pixel,
// group, tap) in registers instead of read from f32 offset and mask
// tensors that ~14 elementwise launches would have written first.
//
// Precision: heads are upcast to f32 before tanhf/expf (the unfused path's
// .float()), the product and the sum of mag * tanh + flow are rounded
// separately (__fmul_rn, __fadd_rn: no fused multiply-add) as two PyTorch
// launches round them, and the clamp is applied once, after the flow is
// added, by the same clamp_window as kernel A. The build has no
// --use_fast_math.
//
// Design: one thread per output pixel (and batch image); the thread loops
// over groups, taps and the group's channels with the O output sums in
// registers. Neighbouring threads sit on neighbouring pixels, so each of
// the 3*G*K2 head channels and the two flow channels is read once,
// coalesced.
//
// Bound on the H100 (bf16 x and heads): at the gate shape (1, 32, 180, 320)
// x 3.7 MB + offset head (1, 144, ...) 16.6 MB + mask head (1, 72, ...)
// 8.3 MB + flow 0.5 MB + out 3.7 MB = 32.8 MB, ~9.8 us at 3.35 TB/s, against
// 1.1 GFLOP of contraction and sampling, ~1.1 us at the bf16 tensor rate:
// bytes bound it. At the serving shape (1, 32, 180, 180) 18.4 MB, ~5.5 us.
// Against kernel A after the PyTorch prologue the function reads the heads
// in their own type (half the bytes in bf16) and never writes or re-reads
// the f32 offsets and masks. The contraction stays on the CUDA cores in
// f32, as in kernel A.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;

template <typename T, int O>
__global__ void __launch_bounds__(kThreads)
dcn_fused_kernel(const T* __restrict__ x, const T* __restrict__ raw_off,
                 const T* __restrict__ raw_mask, const float* __restrict__ flow,
                 const float* __restrict__ weight, const float* __restrict__ bias,
                 T* __restrict__ out, int C, int H, int W, int G, int KH, int KW,
                 float D, float mag) {
  extern __shared__ float ws[];
  const int K2 = KH * KW;
  crfp::stage_weight<O>(ws, weight, C, K2);

  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int n = blockIdx.y;
  const int py = (int)(p / W);
  const int px = (int)(p % W);
  const int cpg = C / G;
  const T* xn = x + (long long)n * C * HW;
  const T* offn = raw_off + (long long)n * G * K2 * 2 * HW + p;
  const T* mn = raw_mask + (long long)n * G * K2 * HW + p;
  // flow channels are (dx, dy); offsets are (dy, dx)
  const float flow_x = flow[(long long)n * 2 * HW + p];
  const float flow_y = flow[(long long)n * 2 * HW + HW + p];

  float acc[O];
#pragma unroll
  for (int o = 0; o < O; ++o) acc[o] = 0.f;

  for (int g = 0; g < G; ++g) {
    // per-group partial sums, added group by group: kernel A's order, so
    // that E and "prologue, then A" round alike
    float gacc[O];
#pragma unroll
    for (int o = 0; o < O; ++o) gacc[o] = 0.f;
    for (int k = 0; k < K2; ++k) {
      const long long gk = (long long)(g * K2 + k);
      const float ry = crfp::load_f(offn + (gk * 2 + 0) * HW);
      const float rx = crfp::load_f(offn + (gk * 2 + 1) * HW);
      const float dy = crfp::clamp_window(
          __fadd_rn(__fmul_rn(mag, tanhf(ry)), flow_y), D);
      const float dx = crfp::clamp_window(
          __fadd_rn(__fmul_rn(mag, tanhf(rx)), flow_x), D);
      const float m = 1.f / (1.f + expf(-crfp::load_f(mn + gk * HW)));
      const crfp::Corners cn = crfp::corners_at(
          (float)(py + k / KW - (KH - 1) / 2) + dy,
          (float)(px + k % KW - (KW - 1) / 2) + dx, H, W);
      for (int ci = 0; ci < cpg; ++ci) {
        const int c = g * cpg + ci;
        const float v = crfp::sample_at(xn + (long long)c * HW, cn, W) * m;
        const float* wk = ws + (k * C + c) * O;
#pragma unroll
        for (int o = 0; o < O; ++o) gacc[o] = fmaf(v, wk[o], gacc[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < O; ++o) acc[o] += gacc[o];
  }

  T* outn = out + (long long)n * O * HW + p;
#pragma unroll
  for (int o = 0; o < O; ++o) {
    const float b = bias != nullptr ? bias[o] : 0.f;
    outn[(long long)o * HW] = crfp::store_f<T>(acc[o] + b);
  }
}

template <typename T, int O>
cudaError_t launch(const void* x, const void* raw_off, const void* raw_mask,
                   const float* flow, const float* weight, const float* bias,
                   void* out, int N, int C, int H, int W, int G, int KH, int KW,
                   float D, float mag, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)O * C * KH * KW;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dcn_fused_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long HW = (long long)H * W;
  dim3 grid((unsigned)((HW + kThreads - 1) / kThreads), (unsigned)N);
  dcn_fused_kernel<T, O><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(raw_off),
      static_cast<const T*>(raw_mask), flow, weight, bias, static_cast<T*>(out),
      C, H, W, G, KH, KW, D, mag);
  return cudaGetLastError();
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// x: (N, C, H, W), raw_off (N, G*K2*2, H, W) and raw_mask (N, G*K2, H, W),
// all f32 or all bf16 (x_bf16); flow (N, 2, H, W) f32, channels (dx, dy);
// weight (O, C, KH, KW) f32; bias (O,) f32 or NULL; out (N, O, H, W) in x's
// type. All contiguous. D < 0: no clamp. O = 32 (dcn_0/1/2 at mid 32).
extern "C" int crfp_dcn_fused(const void* x, const void* raw_off,
                              const void* raw_mask, const void* flow,
                              const void* weight, const void* bias, void* out,
                              int N, int C, int H, int W, int O, int G, int KH,
                              int KW, float D, float mag, int x_bf16,
                              void* stream) {
  if (O != 32) return (int)cudaErrorInvalidValue;
  const float* fl = static_cast<const float*>(flow);
  const float* wt = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      x_bf16 ? launch<__nv_bfloat16, 32>(x, raw_off, raw_mask, fl, wt, b, out, N,
                                         C, H, W, G, KH, KW, D, mag, s)
             : launch<float, 32>(x, raw_off, raw_mask, fl, wt, b, out, N, C, H,
                                 W, G, KH, KW, D, mag, s);
  return (int)e;
}
