// Kernel D (DCN stages): windowed modulated deformable conv (DCNv2)
// backward, NCHW.
//
// Replaces crfp_tpu/ops/pallas/dcn.py::_dcn_bwd_kernel (:219, pallas_call in
// _bwd_call :593) for the DCN stages (the warp is csrc/flow_warp_bwd.cu).
// The forward is kernel A (csrc/dcn_fwd.cu):
//   out[o,p] = sum_g gm_g(p) sum_k sum_{c in g} W[o,c,k] m_gk(p) v_ck(p) + b[o]
// with v_ck the bilinear sample of x at p + p_k + clamp(off_gk(p), +-D)
// (zeros outside the frame), m_gk the per-tap mask (1 in shared_mask mode)
// and gm_g the shared mask (1 otherwise). For s_ck = sum_o W[o,c,k] g[o,p]:
//   d mask        = sum_c v_ck s_ck        (summed over k in shared_mask mode)
//   d v_ck        = m_gk gm_g s_ck         -> dx by atomicAdd at the corners
//   d offset      = sum_c d v_ck dv_ck/ds  (summed over k in shared_taps
//                   mode), times torch's clamp derivative: 1 where
//                   |off| <= D, else 0
//   dW[o,c,k]     = sum_p g[o,p] m_gk gm_g v_ck
// The bias gradient is a reduction of grad_out outside the kernel, as on the
// TPU (crfp_tpu/ops/pallas/dcn.py:1139).
//
// Design: one thread per output pixel (over N*H*W) and one group per
// blockIdx.y, so every lane of a warp works on the same (group, tap,
// channel) at once. The thread keeps its O output gradients in registers;
// the group's weight slice sits in shared memory. The window cotangents
// that the TPU kernel overlap-adds (_overlap_add :604) are scattered here
// with atomicAdd into an f32 dx, which the wrapper casts to x's type. dW
// is summed across the warp with shuffles, into a per-block partial in
// shared memory, and added to the global dW with one atomicAdd per
// element per block.
//
// Bound on the H100 at the training shapes (B 2, T 7, GT 192, mid 32, bf16
// activations): per-tap (dcn_0/1/2) x (2,32,48,48) bf16 0.29 MB + offset
// (2,144,48,48) f32 2.65 MB + mask 1.33 MB + grad_out 0.29 MB in, dx 0.29 MB
// + d-offset 2.65 MB + d-mask 1.33 MB out = 8.8 MB, ~2.6 us at 3.35 TB/s;
// shared (dcn_3) x (2,4,192,192) with one offset pair and mask per pixel
// moves 3.5 MB, ~1.1 us. The work is ~4*O flops per (pixel, tap, channel)
// on the CUDA cores in f32; the contraction with the weight is not moved
// to tensor cores in this version.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

template <typename T, int O>
__global__ void __launch_bounds__(kThreads)
dcn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ off,
               const float* __restrict__ mask, const float* __restrict__ weight,
               const T* __restrict__ gout, float* __restrict__ dx,
               float* __restrict__ doff, float* __restrict__ dmask,
               float* __restrict__ dw, int N, int C, int H, int W, int G,
               int KH, int KW, float D, int shared_taps, int shared_mask) {
  extern __shared__ float smem[];
  const int K2 = KH * KW;
  const int cpg = C / G;
  const int g = blockIdx.y;
  const int nws = K2 * cpg * O;
  float* ws = smem;         // ws[(k*cpg + ci)*O + o] = W[o, g*cpg + ci, k]
  float* dws = smem + nws;  // the block's partial dW, same layout
  for (int i = threadIdx.x; i < nws; i += blockDim.x) {
    const int o = i % O;
    const int ci = (i / O) % cpg;
    const int k = i / (O * cpg);
    ws[i] = weight[((long long)o * C + g * cpg + ci) * K2 + k];
    dws[i] = 0.f;
  }
  __syncthreads();

  // Threads past the last pixel stay to the end with zero gradients: every
  // lane takes part in the warp sums of dW.
  const long long HW = (long long)H * W;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = q < (long long)N * HW;
  const int n = valid ? (int)(q / HW) : 0;
  const long long p = valid ? q % HW : 0;
  const int py = (int)(p / W);
  const int px = (int)(p % W);
  const int lane = threadIdx.x & 31;
  const int taps = shared_taps ? 1 : K2;
  const int mtaps = shared_mask ? 1 : K2;
  const T* xn = x + (long long)n * C * HW;
  float* dxn = dx + (long long)n * C * HW;
  const long long off_base = (long long)n * G * taps * 2 * HW + p;
  const long long mask_base = (long long)n * G * mtaps * HW + p;

  float go[O];
#pragma unroll
  for (int o = 0; o < O; ++o)
    go[o] = valid ? crfp::load_f(gout + ((long long)n * O + o) * HW + p) : 0.f;
  const float gm = (valid && shared_mask) ? mask[mask_base + (long long)g * HW] : 1.f;
  float dgm = 0.f;             // shared_mask: d mask summed over taps
  float sdy = 0.f, sdx = 0.f;  // shared_taps: d sample position over taps
  float oy = 0.f, ox = 0.f;

  for (int k = 0; k < K2; ++k) {
    const int t = shared_taps ? 0 : k;
    const long long oi = off_base + (long long)((g * taps + t) * 2) * HW;
    oy = valid ? off[oi] : 0.f;
    ox = valid ? off[oi + HW] : 0.f;
    float cy = oy, cx = ox;
    if (D >= 0.f) {
      cy = fminf(fmaxf(cy, -D), D);
      cx = fminf(fmaxf(cx, -D), D);
    }
    const float sy = (float)(py + k / KW - (KH - 1) / 2) + cy;
    const float sx = (float)(px + k % KW - (KW - 1) / 2) + cx;
    const float y0f = floorf(sy);
    const float x0f = floorf(sx);
    const float fy = sy - y0f;
    const float fx = sx - x0f;
    const int y0 = (int)y0f;
    const int x0 = (int)x0f;
    const bool vy0 = valid && y0 >= 0 && y0 < H, vy1 = valid && y0 + 1 >= 0 && y0 + 1 < H;
    const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
    const bool b00 = vy0 && vx0, b01 = vy0 && vx1, b10 = vy1 && vx0, b11 = vy1 && vx1;
    const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
    const float w10 = fy * (1.f - fx), w11 = fy * fx;
    const float m = shared_mask ? 1.f
                                : (valid ? mask[mask_base + (long long)(g * K2 + k) * HW] : 0.f);
    const float mult = m * gm;
    const long long i00 = (long long)y0 * W + x0;
    float dm = 0.f, dsy = 0.f, dsx = 0.f;
    for (int ci = 0; ci < cpg; ++ci) {
      const long long cHW = (long long)(g * cpg + ci) * HW;
      const T* xc = xn + cHW;
      const float v00 = b00 ? crfp::load_f(xc + i00) : 0.f;
      const float v01 = b01 ? crfp::load_f(xc + i00 + 1) : 0.f;
      const float v10 = b10 ? crfp::load_f(xc + i00 + W) : 0.f;
      const float v11 = b11 ? crfp::load_f(xc + i00 + W + 1) : 0.f;
      const float v = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
      const float* wk = ws + (k * cpg + ci) * O;
      float s = 0.f;
#pragma unroll
      for (int o = 0; o < O; ++o) s = fmaf(wk[o], go[o], s);
      dm = fmaf(v, s, dm);
      const float dv = mult * s;
      dsy = fmaf(dv, (1.f - fx) * (v10 - v00) + fx * (v11 - v01), dsy);
      dsx = fmaf(dv, (1.f - fy) * (v01 - v00) + fy * (v11 - v10), dsx);
      if (dv != 0.f) {
        float* dxc = dxn + cHW;
        if (b00) atomicAdd(dxc + i00, dv * w00);
        if (b01) atomicAdd(dxc + i00 + 1, dv * w01);
        if (b10) atomicAdd(dxc + i00 + W, dv * w10);
        if (b11) atomicAdd(dxc + i00 + W + 1, dv * w11);
      }
      const float u = mult * v;
      float* dwk = dws + (k * cpg + ci) * O;
#pragma unroll
      for (int o = 0; o < O; ++o) {
        const float r = warp_sum(go[o] * u);
        if (lane == 0) atomicAdd(dwk + o, r);
      }
    }
    if (shared_mask) {
      dgm += dm;
    } else if (valid) {
      dmask[mask_base + (long long)(g * K2 + k) * HW] = dm;
    }
    if (shared_taps) {
      sdy += dsy;
      sdx += dsx;
    } else if (valid) {
      const long long di = off_base + (long long)((g * K2 + k) * 2) * HW;
      doff[di] = crfp::clamp_pass(oy, D) * dsy;
      doff[di + HW] = crfp::clamp_pass(ox, D) * dsx;
    }
  }
  if (valid) {
    if (shared_mask) dmask[mask_base + (long long)g * HW] = dgm;
    if (shared_taps) {  // oy, ox: the one offset pair every tap read
      const long long di = off_base + (long long)(g * 2) * HW;
      doff[di] = crfp::clamp_pass(oy, D) * sdy;
      doff[di + HW] = crfp::clamp_pass(ox, D) * sdx;
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < nws; i += blockDim.x) {
    const int o = i % O;
    const int ci = (i / O) % cpg;
    const int k = i / (O * cpg);
    atomicAdd(dw + ((long long)o * C + g * cpg + ci) * K2 + k, dws[i]);
  }
}

template <typename T, int O>
cudaError_t launch(const void* x, const float* off, const float* mask,
                   const float* weight, const void* gout, float* dx,
                   float* doff, float* dmask, float* dw, int N, int C, int H,
                   int W, int G, int KH, int KW, float D, int shared_taps,
                   int shared_mask, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)KH * KW * (C / G) * O;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dcn_bwd_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long NHW = (long long)N * H * W;
  dim3 grid((unsigned)((NHW + kThreads - 1) / kThreads), (unsigned)G);
  dcn_bwd_kernel<T, O><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), off, mask, weight, static_cast<const T*>(gout),
      dx, doff, dmask, dw, N, C, H, W, G, KH, KW, D, shared_taps, shared_mask);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int O, const void* x, const float* off, const float* mask,
                     const float* weight, const void* gout, float* dx,
                     float* doff, float* dmask, float* dw, int N, int C, int H,
                     int W, int G, int KH, int KW, float D, int shared_taps,
                     int shared_mask, cudaStream_t s) {
#define CRFP_DCN_BWD_CASE(OO)                                                \
  case OO:                                                                   \
    return launch<T, OO>(x, off, mask, weight, gout, dx, doff, dmask, dw, N, \
                         C, H, W, G, KH, KW, D, shared_taps, shared_mask, s);
  switch (O) {
    CRFP_DCN_BWD_CASE(4)   // dcn_3 at mid 32
    CRFP_DCN_BWD_CASE(32)  // dcn_0/1/2 at mid 32
    default:
      return cudaErrorInvalidValue;
  }
#undef CRFP_DCN_BWD_CASE
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// x: (N, C, H, W) f32 or bf16 (x_bf16); offset (N, G*T*2, H, W) f32; mask
// (N, G*M, H, W) f32; weight (O, C, KH, KW) f32; grad_out (N, O, H, W) in
// x's type. Outputs, all f32: dx (N, C, H, W) and dw (O, C, KH, KW), both
// zeroed by the caller (accumulated with atomics); d_offset and d_mask in
// the layouts of offset and mask (every element written). All contiguous.
// O in {4, 32}.
extern "C" int crfp_dcn_bwd(const void* x, const void* offset,
                            const void* mask, const void* weight,
                            const void* grad_out, void* dx, void* d_offset,
                            void* d_mask, void* dw, int N, int C, int H, int W,
                            int O, int G, int KH, int KW, float D,
                            int shared_taps, int shared_mask, int x_bf16,
                            void* stream) {
  const float* off = static_cast<const float*>(offset);
  const float* mk = static_cast<const float*>(mask);
  const float* wt = static_cast<const float*>(weight);
  float* gx = static_cast<float*>(dx);
  float* goff = static_cast<float*>(d_offset);
  float* gmk = static_cast<float*>(d_mask);
  float* gw = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      x_bf16 ? dispatch<__nv_bfloat16>(O, x, off, mk, wt, grad_out, gx, goff,
                                       gmk, gw, N, C, H, W, G, KH, KW, D,
                                       shared_taps, shared_mask, s)
             : dispatch<float>(O, x, off, mk, wt, grad_out, gx, goff, gmk, gw,
                               N, C, H, W, G, KH, KW, D, shared_taps,
                               shared_mask, s);
  return (int)e;
}
