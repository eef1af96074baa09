// Kernel D at k=1 (the warp): windowed backward flow warp, backward pass,
// NCHW.
//
// Replaces crfp_tpu/ops/pallas/dcn.py::_dcn_bwd_kernel (:219, pallas_call in
// _bwd_call :593, anchored :581) where
// crfp_tpu/ops/pallas/warp.py::flow_warp_windowed_pallas (:29) and its s2d
// form (:55) run it at k=1 with an identity weight and no mask. The forward
// is kernel B (csrc/flow_warp.cu): out[c,p] = bilinear sample of x[c] at
// p + clamp(flow(p), +-D), zeros outside the frame. Backward:
//   dx        : grad_out[c,p] times each corner weight, scattered into the
//               four corners;
//   d flow_x  = sum_c grad_out[c,p] dv_c/dsx, and d flow_y likewise, times
//               torch's clamp derivative (1 where |flow| <= D, else 0).
// Anchored (the HR state warp trained under ModelConfig.dcn_anchor_vjp):
// the forward sampled at F + clip(flow - F, +-dl) per component, F the
// anchor of the pixel's cell in the table that B's pre-pass wrote; this
// kernel reads that table, samples at the same points (frame-checked, as
// the clamped mode) and multiplies each component's d-flow by the residual
// clip's derivative, 1 where |flow - F| <= dl, else 0 (torch.clamp's). The
// table holds (dy, dx), the flow (dx, dy).
//
// What bounds it on the H100: bytes, and very few of them. At the training
// shapes (bf16 activations) the HR state (2,4,192,192) moves 2.9 MB (0.9 us
// at 3.35 TB/s), lv3_state (2,32,48,48) 1.0 MB (0.3 us), the lv states
// (2,24,48,48) 0.8 MB. So a launch is as long as its slowest thread, and
// the design is about how many SMs work and how short each thread's chain
// of dependent memory operations is.
//
// Design.
// - A block is a strip of kThreads / CG consecutive pixels times CG channel
//   groups (CG = 8 from 8 channels up, 4 for the 4-channel HR state);
//   blockIdx.y is the batch. (2,32,48,48) gives 144 blocks of 32 pixels x 8
//   groups on the card's 132 SMs, where one thread per pixel walking all 32
//   channels gave 18 blocks. A thread reads its pixel's flow and builds the
//   corner weights once, then walks channels c = group, group + CG, ...:
//   4 at C = 32, with no dependence between them but the two running sums.
// - d-flow: every thread leaves its partial sums in shared memory and the
//   first group's threads add the CG partials in order and write d-flow
//   once per pixel. No atomics on d-flow, no zeroing, and a fixed
//   summation order: the same inputs give the same bits.
// - dx: scattered with atomicAdd (red.global.add.f32) into an f32 buffer.
//   It stays f32 because up to four corner terms of many source pixels
//   meet in one element, and a bf16 sum would round after each; the TPU
//   kernel overlap-adds its windows in f32 too. The zeroing of that buffer
//   (cudaMemsetAsync), the scatter and, for bf16 x, the cast into the
//   result are one C entry on one stream, so the host makes one call.
// - No 16-byte accesses here: with 1-3 MB per launch a thread per (pixel,
//   channel group) and 4-byte loads coalesced along the row already ask
//   for every byte in the first few hundred cycles, and wider threads
//   would leave SMs idle at the 48x48 shapes (36 blocks of 4-pixel threads).
// - A shared-memory tile for dx (a 16x16 tile with its +-(D+1) halo, 34x34
//   f32 per channel at D = 8) was not built, so there is no time for it:
//   its flush into global memory still needs atomics, because the halos of
//   neighbouring tiles overlap, and a full flush writes 1156 elements per
//   channel where the direct scatter of the tile's 256 pixels makes 1024.
//   It pays only if the flush is cut to the box the tile's samples really
//   reach, which is the next step if the atomics' rate is to come down.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 5, bf16;
// device time of memset + scatter + cast: 20 calls replayed from one CUDA
// graph; before -> after, in turns in one run; before: one thread per
// pixel walking all channels, 18 blocks at 48x48, with PyTorch's fill and
// cast around it): (2,4,192,192) 17.5 -> 15.4 us, (2,32,48,48) 24.4 -> 8.7,
// (2,24,48,48) 20.1 -> 7.5; grid_sampler_2d_backward 22.8, 53.5, 38.6; bounds
// 0.9, 0.3, 0.2. What is left is the memset and the cast (two more
// operations of 1-2 us each) and the rate of the atomics: 1.2 M of them at
// (2,4,192,192), which the channel groups do not reduce. 48 registers for
// bf16 (54 at CG = 1), 98-99 for f32 (the unrolled loop keeps four
// channels' corners), no spills.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The anchored form's table and cell grid (Anchor::table NULL: the clamp).
struct Anchor {
  const float* table;  // [N][nb][nt][2], (dy, dx)
  int band, xtile, nb, nt;
  float dl_r, dl_c;
};

template <typename T, int CG, bool ANCHORED>
__global__ void __launch_bounds__(kThreads)
flow_warp_bwd_kernel(const T* __restrict__ x, const float* __restrict__ flow,
                     const T* __restrict__ gout, float* __restrict__ dx,
                     float* __restrict__ dflow, int C, int H, int W, float D, Anchor an) {
  constexpr int kPix = kThreads / CG;
  __shared__ float part[2][CG][kPix];
  const int HW = H * W;
  const int tp = threadIdx.x % kPix;  // pixel of the strip: fastest, so a
  const int cg = threadIdx.x / kPix;  // warp reads along the row
  const int p = blockIdx.x * kPix + tp;
  const int n = blockIdx.y;
  const bool live = p < HW;
  float gsx = 0.f, gsy = 0.f, pass_x = 0.f, pass_y = 0.f;
  if (live) {
    const int py = p / W;
    const int px = p - py * W;
    const float fx_raw = __ldg(flow + (long long)n * 2 * HW + p);
    const float fy_raw = __ldg(flow + (long long)n * 2 * HW + HW + p);
    float sx, sy;
    if constexpr (ANCHORED) {  // as kernel B's anchored form computes it
      const float* f =
          an.table + (((long long)n * an.nb + py / an.band) * an.nt + px / an.xtile) * 2;
      const float ay = __ldg(f), ax = __ldg(f + 1);
      const float rx = fx_raw - ax, ry = fy_raw - ay;
      sx = (float)px + (ax + fminf(fmaxf(rx, -an.dl_c), an.dl_c));
      sy = (float)py + (ay + fminf(fmaxf(ry, -an.dl_r), an.dl_r));
      pass_x = rx >= -an.dl_c && rx <= an.dl_c ? 1.f : 0.f;
      pass_y = ry >= -an.dl_r && ry <= an.dl_r ? 1.f : 0.f;
    } else {
      sx = (float)px + crfp::clamp_window(fx_raw, D);
      sy = (float)py + crfp::clamp_window(fy_raw, D);
      pass_x = crfp::clamp_pass(fx_raw, D);
      pass_y = crfp::clamp_pass(fy_raw, D);
    }
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
    // only touched where a corner is inside, so it may lie outside
    const int i00 = y0 * W + x0;
#pragma unroll 4
    for (int c = cg; c < C; c += CG) {
      const long long plane = ((long long)n * C + c) * HW;
      const float g = crfp::load_f(gout + plane + p);
      const T* xc = x + plane + i00;
      const float v00 = b00 ? crfp::load_f(xc) : 0.f;
      const float v01 = b01 ? crfp::load_f(xc + 1) : 0.f;
      const float v10 = b10 ? crfp::load_f(xc + W) : 0.f;
      const float v11 = b11 ? crfp::load_f(xc + W + 1) : 0.f;
      gsx = fmaf(g, (1.f - fy) * (v01 - v00) + fy * (v11 - v10), gsx);
      gsy = fmaf(g, (1.f - fx) * (v10 - v00) + fx * (v11 - v01), gsy);
      float* dxc = dx + plane + i00;
      if (b00) atomicAdd(dxc, g * w00);
      if (b01) atomicAdd(dxc + 1, g * w01);
      if (b10) atomicAdd(dxc + W, g * w10);
      if (b11) atomicAdd(dxc + W + 1, g * w11);
    }
  }
  if constexpr (CG > 1) {
    part[0][cg][tp] = gsx;
    part[1][cg][tp] = gsy;
    __syncthreads();
    if (cg != 0) return;
#pragma unroll
    for (int k = 1; k < CG; ++k) {
      gsx += part[0][k][tp];
      gsy += part[1][k][tp];
    }
  }
  if (live) {
    dflow[(long long)n * 2 * HW + p] = pass_x * gsx;
    dflow[(long long)n * 2 * HW + HW + p] = pass_y * gsy;
  }
}

// the f32 accumulator into bf16, four elements per thread (both pointers
// 16-byte aligned, as PyTorch's allocations are)
__global__ void __launch_bounds__(kThreads)
cast_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                 long long count) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i + 4 <= count) {
    const float4 f = *reinterpret_cast<const float4*>(src + i);
    __nv_bfloat162 a = __floats2bfloat162_rn(f.x, f.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(f.z, f.w);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&a);
    u.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(dst + i) = u;
  } else {
    for (long long j = i; j < count; ++j) dst[j] = __float2bfloat16(src[j]);
  }
}

template <typename T, int CG>
cudaError_t launch(const void* x, const float* flow, const void* gout,
                   float* dx, float* dflow, int N, int C, int H, int W,
                   float D, const Anchor& an, cudaStream_t s) {
  constexpr int kPix = kThreads / CG;
  dim3 grid((unsigned)(((long long)H * W + kPix - 1) / kPix), (unsigned)N);
  if (an.table != nullptr)
    flow_warp_bwd_kernel<T, CG, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), flow, static_cast<const T*>(gout), dx, dflow,
        C, H, W, D, an);
  else
    flow_warp_bwd_kernel<T, CG, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), flow, static_cast<const T*>(gout), dx, dflow,
        C, H, W, D, an);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* flow, const void* gout,
                     float* dx, float* dflow, int N, int C, int H, int W,
                     float D, const Anchor& an, cudaStream_t s) {
  if (C >= 8) return launch<T, 8>(x, flow, gout, dx, dflow, N, C, H, W, D, an, s);
  if (C >= 4) return launch<T, 4>(x, flow, gout, dx, dflow, N, C, H, W, D, an, s);
  return launch<T, 1>(x, flow, gout, dx, dflow, N, C, H, W, D, an, s);
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// x: (N, C, H, W) f32 or bf16 (x_bf16); flow (N, 2, H, W) f32, channels
// (dx, dy); grad_out (N, C, H, W) in x's type. dx_acc: (N, C, H, W) f32
// scratch, zeroed here; for f32 x it is the result and dx_out is not read.
// dx_out: (N, C, H, W) bf16, the result for bf16 x; both 16-byte aligned. d_flow (N, 2, H, W) f32,
// every element written. All contiguous; a plane holds fewer than 2^31
// pixels, N at most 65535. Three operations on the stream: memset,
// scatter, cast (bf16 only). anchor: NULL (the clamp to +-D) or the table
// that the forward's pre-pass wrote (crfp_flow_warp's `anchor`), f32
// [N][ceil(H / band)][ceil(W / xtile)][2] as (dy, dx); the geometry
// arguments are crfp_flow_warp's, of which this entry reads the cells and
// the residual margins dl_r (rows) and dl_c (columns).
extern "C" int crfp_flow_warp_bwd(const void* x, const void* flow,
                                  const void* grad_out, void* dx_acc,
                                  void* dx_out, void* d_flow, int N, int C,
                                  int H, int W, float D, int x_bf16,
                                  const void* anchor, int band, int xtile, int sub_tile,
                                  int lane_q, int a_y, int a_x, float dl_r, float dl_c,
                                  void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if ((long long)H * W > 0x7fff0000LL || N > 65535) return (int)cudaErrorInvalidValue;
  if (anchor != nullptr && (band < 1 || xtile < 1)) return (int)cudaErrorInvalidValue;
  const Anchor an{static_cast<const float*>(anchor), band, xtile,
                  anchor != nullptr ? (H + band - 1) / band : 0,
                  anchor != nullptr ? (W + xtile - 1) / xtile : 0, dl_r, dl_c};
  if (x_bf16 &&
      ((reinterpret_cast<uintptr_t>(dx_acc) | reinterpret_cast<uintptr_t>(dx_out)) & 15u))
    return (int)cudaErrorMisalignedAddress;
  const float* f = static_cast<const float*>(flow);
  float* acc = static_cast<float*>(dx_acc);
  float* gf = static_cast<float*>(d_flow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long count = (long long)N * C * H * W;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)count * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  e = x_bf16 ? dispatch<__nv_bfloat16>(x, f, grad_out, acc, gf, N, C, H, W, D, an, s)
             : dispatch<float>(x, f, grad_out, acc, gf, N, C, H, W, D, an, s);
  if (e != cudaSuccess || !x_bf16) return (int)e;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dx_out);
  const long long threads = (count + 3) / 4;
  cast_bf16_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      acc, out, count);
  return (int)cudaGetLastError();
}
