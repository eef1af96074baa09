// Kernel A: windowed modulated deformable conv (DCNv2) forward, NCHW.
//
// Replaces crfp_tpu/ops/pallas/dcn.py::_dcn_kernel (:59, pallas_call in
// _fwd_call :493). Semantics of the plain version
// crfp_torch/ops/dcn_windowed.py::deform_conv2d_windowed_ref: every offset
// component is clamped to +-D (D < 0: no clamp), each tap takes an exact
// bilinear sample of x at p + p_k + offset (zeros outside the frame), is
// scaled by its mask and contracted with the (O, C, kh, kw) weight inside
// the kernel; the bias is added last. shared_taps: one (dy, dx) per pixel
// and group for every tap. shared_mask: one mask per pixel and group,
// applied once to the group's sum (crfp_tpu/ops/pallas/dcn.py:196-200).
//
// Design: one thread per output pixel (and batch image). The thread loops
// over groups, taps and the group's channels; each sample is four corner
// loads, and the O output sums stay in registers. The weight is staged
// once per block in shared memory as ws[(k*C + c)*O + o], so the inner
// loop over o reads one broadcast address per step. The corner sampling,
// the clamp and the weight tile live in common.cuh, shared with kernel E
// (dcn_fused.cu).
//
// Bound on the H100 at the main-path shapes (1080p, warp 720^2, mid 32):
// per-tap (dcn_0/1/2): x (1,32,180,180) bf16 2.1 MB + offset (1,144,180,180)
// f32 18.7 MB + mask (1,72,...) f32 9.3 MB + out 2.1 MB = 32 MB, i.e.
// ~9.6 us at 3.35 TB/s; 0.6 GFLOP of contraction is ~0.6 us at the bf16
// tensor rate: bytes bound it. shared (dcn_3): x (1,4,720,720) bf16 4.1 MB
// + offset 4.1 MB + mask 2.1 MB + out 4.1 MB = 14.5 MB, ~4.3 us: bytes
// again. The design reads offsets, masks and outputs once and coalesced
// (neighbouring threads on neighbouring pixels); the corner loads of x
// hit L1/L2 because neighbouring pixels sample neighbouring positions.
// It leaves the contraction on the CUDA cores in f32, which is not the
// bound at these widths.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;

template <typename T, int O>
__global__ void __launch_bounds__(kThreads)
dcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ off,
               const float* __restrict__ mask, const float* __restrict__ weight,
               const float* __restrict__ bias, T* __restrict__ out, int C,
               int H, int W, int G, int KH, int KW, float D, int shared_taps,
               int shared_mask) {
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
  const int taps = shared_taps ? 1 : K2;
  const int mtaps = shared_mask ? 1 : K2;
  const T* xn = x + (long long)n * C * HW;
  const float* offn = off + (long long)n * G * taps * 2 * HW + p;
  const float* mn = mask + (long long)n * G * mtaps * HW + p;

  float acc[O];
#pragma unroll
  for (int o = 0; o < O; ++o) acc[o] = 0.f;

  for (int g = 0; g < G; ++g) {
    float gacc[O];
#pragma unroll
    for (int o = 0; o < O; ++o) gacc[o] = 0.f;
    for (int k = 0; k < K2; ++k) {
      const int t = shared_taps ? 0 : k;
      const float dy = crfp::clamp_window(
          offn[(long long)((g * taps + t) * 2 + 0) * HW], D);
      const float dx = crfp::clamp_window(
          offn[(long long)((g * taps + t) * 2 + 1) * HW], D);
      const crfp::Corners cn = crfp::corners_at(
          (float)(py + k / KW - (KH - 1) / 2) + dy,
          (float)(px + k % KW - (KW - 1) / 2) + dx, H, W);
      const float m = shared_mask ? 1.f : mn[(long long)(g * K2 + k) * HW];
      for (int ci = 0; ci < cpg; ++ci) {
        const int c = g * cpg + ci;
        float v = crfp::sample_at(xn + (long long)c * HW, cn, W);
        v *= m;
        const float* wk = ws + (k * C + c) * O;
#pragma unroll
        for (int o = 0; o < O; ++o) gacc[o] = fmaf(v, wk[o], gacc[o]);
      }
    }
    const float gm = shared_mask ? mn[(long long)g * HW] : 1.f;
#pragma unroll
    for (int o = 0; o < O; ++o) acc[o] = fmaf(gm, gacc[o], acc[o]);
  }

  T* outn = out + (long long)n * O * HW + p;
#pragma unroll
  for (int o = 0; o < O; ++o) {
    const float b = bias != nullptr ? bias[o] : 0.f;
    outn[(long long)o * HW] = crfp::store_f<T>(acc[o] + b);
  }
}

template <typename T, int O>
cudaError_t launch(const void* x, const float* off, const float* mask,
                   const float* weight, const float* bias, void* out, int N,
                   int C, int H, int W, int G, int KH, int KW, float D,
                   int shared_taps, int shared_mask, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)O * C * KH * KW;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dcn_fwd_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long HW = (long long)H * W;
  dim3 grid((unsigned)((HW + kThreads - 1) / kThreads), (unsigned)N);
  dcn_fwd_kernel<T, O><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), off, mask, weight, bias, static_cast<T*>(out),
      C, H, W, G, KH, KW, D, shared_taps, shared_mask);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int O, const void* x, const float* off, const float* mask,
                     const float* weight, const float* bias, void* out, int N,
                     int C, int H, int W, int G, int KH, int KW, float D,
                     int shared_taps, int shared_mask, cudaStream_t s) {
#define CRFP_DCN_CASE(OO)                                                   \
  case OO:                                                                  \
    return launch<T, OO>(x, off, mask, weight, bias, out, N, C, H, W, G,    \
                         KH, KW, D, shared_taps, shared_mask, s);
  switch (O) {
    CRFP_DCN_CASE(4)   // dcn_3 at mid 32
    CRFP_DCN_CASE(32)  // dcn_0/1/2 at mid 32
    default:
      return cudaErrorInvalidValue;
  }
#undef CRFP_DCN_CASE
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// x: (N, C, H, W) f32 or bf16 (x_bf16); offset (N, G*T*2, H, W) f32;
// mask (N, G*M, H, W) f32; weight (O, C, KH, KW) f32; bias (O,) f32 or
// NULL; out (N, O, H, W) in x's type. All contiguous. O in {4, 32}.
extern "C" int crfp_dcn_fwd(const void* x, const void* offset,
                            const void* mask, const void* weight,
                            const void* bias, void* out, int N, int C, int H,
                            int W, int O, int G, int KH, int KW, float D,
                            int shared_taps, int shared_mask, int x_bf16,
                            void* stream) {
  const float* off = static_cast<const float*>(offset);
  const float* mk = static_cast<const float*>(mask);
  const float* wt = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      x_bf16 ? dispatch<__nv_bfloat16>(O, x, off, mk, wt, b, out, N, C, H, W,
                                       G, KH, KW, D, shared_taps, shared_mask, s)
             : dispatch<float>(O, x, off, mk, wt, b, out, N, C, H, W, G, KH,
                               KW, D, shared_taps, shared_mask, s);
  return (int)e;
}
