// Kernel F: SSIM map, planes (P, H, W) f32.
//
// Replaces crfp_tpu/ops/pallas/ssim.py::_ssim_kernel (:55, pallas_call in
// ssim_map_pallas :142). Semantics of the plain version
// crfp_torch/ops/cuda/ssim.py::ssim_map_ref: the five moments of x and y
// (mean x, mean y, x^2, y^2, xy) under an 11x11 Gaussian window, sigma 1.5,
// with zero 'same' padding; then
//   ((2 mu1 mu2 + C1)(2 s12 + C2)) / ((mu1^2 + mu2^2 + C1)(s11 + s22 + C2))
// with s11 = <x^2> - mu1^2 (and likewise), C1 = 1e-4, C2 = 9e-4. The window
// is the outer product of the f32-normalised 1-D taps, which the caller
// passes.
//
// Design: each block owns a kTH x kTW output tile of one plane. It loads
// the tile plus a 5-pixel halo of x and y into shared memory (zeros outside
// the plane: the 'same' padding), runs the vertical 11-tap pass for the
// five moments over the tile's rows and every halo column, then the
// horizontal 11-tap pass, evaluates the formula in registers and writes
// the map. The TPU kernel DMAs row tiles with an 8-row halo and rolls lanes
// for the horizontal taps; here a 2-D tile keeps a 1080p row out of shared
// memory, and the horizontal taps read shifted shared-memory columns.
//
// Bound on the H100: x, y in and the map out, 12 bytes per pixel and plane
// (at (42, 192, 192) 18.6 MB, ~5.6 us at 3.35 TB/s), against ~250 f32
// flops per pixel and plane (the two 11-tap passes over five moments), ~5.8
// us at 67 TFLOP/s: the two are close. The halo loads are re-reads of
// neighbouring tiles that L2 serves.
#include "common.cuh"

namespace {

constexpr int kWin = 11;
constexpr int kHalf = kWin / 2;
constexpr int kTW = 32;  // output tile width
constexpr int kTH = 32;  // output tile height
constexpr int kSW = kTW + 2 * kHalf;
constexpr int kSH = kTH + 2 * kHalf;
constexpr int kThreads = 256;

struct Taps {
  float g[kWin];
};

__global__ void __launch_bounds__(kThreads)
ssim_kernel(const float* __restrict__ x, const float* __restrict__ y,
            float* __restrict__ out, int H, int W, Taps taps) {
  __shared__ float sx[kSH][kSW];
  __shared__ float sy[kSH][kSW];
  __shared__ float vm[5][kTH][kSW];  // vertical pass: mu1, mu2, x2, y2, xy

  const long long HW = (long long)H * W;
  const float* xp = x + (long long)blockIdx.z * HW;
  const float* yp = y + (long long)blockIdx.z * HW;
  const int r0 = blockIdx.y * kTH - kHalf;
  const int c0 = blockIdx.x * kTW - kHalf;
  for (int i = threadIdx.x; i < kSH * kSW; i += kThreads) {
    const int r = i / kSW, c = i % kSW;
    const int gy = r0 + r, gx = c0 + c;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const long long gi = (long long)gy * W + gx;
    sx[r][c] = in ? __ldg(xp + gi) : 0.f;
    sy[r][c] = in ? __ldg(yp + gi) : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTH * kSW; i += kThreads) {
    const int r = i / kSW, c = i % kSW;
    float a = 0.f, b = 0.f, aa = 0.f, bb = 0.f, ab = 0.f;
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const float g = taps.g[k];
      const float xv = sx[r + k][c], yv = sy[r + k][c];
      a = fmaf(g, xv, a);
      b = fmaf(g, yv, b);
      aa = fmaf(g, xv * xv, aa);
      bb = fmaf(g, yv * yv, bb);
      ab = fmaf(g, xv * yv, ab);
    }
    vm[0][r][c] = a;
    vm[1][r][c] = b;
    vm[2][r][c] = aa;
    vm[3][r][c] = bb;
    vm[4][r][c] = ab;
  }
  __syncthreads();

  const float c1 = 1e-4f, c2 = 9e-4f;
  for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
    const int r = i / kTW, c = i % kTW;
    const int gy = r0 + kHalf + r, gx = c0 + kHalf + c;
    if (gy >= H || gx >= W) continue;
    float mu1 = 0.f, mu2 = 0.f, m11 = 0.f, m22 = 0.f, m12 = 0.f;
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const float g = taps.g[k];
      mu1 = fmaf(g, vm[0][r][c + k], mu1);
      mu2 = fmaf(g, vm[1][r][c + k], mu2);
      m11 = fmaf(g, vm[2][r][c + k], m11);
      m22 = fmaf(g, vm[3][r][c + k], m22);
      m12 = fmaf(g, vm[4][r][c + k], m12);
    }
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
    const float s11 = m11 - mu1_sq, s22 = m22 - mu2_sq, s12 = m12 - mu1_mu2;
    out[(long long)blockIdx.z * HW + (long long)gy * W + gx] =
        ((2.f * mu1_mu2 + c1) * (2.f * s12 + c2)) /
        ((mu1_sq + mu2_sq + c1) * (s11 + s22 + c2));
  }
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// x, y: (P, H, W) f32 planes; out (P, H, W) f32. All contiguous. taps: the
// 11 f32 taps of the 1-D Gaussian, read on the host.
extern "C" int crfp_ssim(const void* x, const void* y, void* out, int P,
                         int H, int W, const float* taps, void* stream) {
  Taps t;
  for (int k = 0; k < kWin; ++k) t.g[k] = taps[k];
  dim3 grid((unsigned)((W + kTW - 1) / kTW), (unsigned)((H + kTH - 1) / kTH),
            (unsigned)P);
  ssim_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), H, W, t);
  return (int)cudaGetLastError();
}
