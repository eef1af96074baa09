// Kernel F: SSIM map of (N, C, H, W) f32 images, each read through its own
// element strides (any layout: NCHW-contiguous, an NCHW view of NHWC memory,
// one of each).
//
// Replaces crfp_tpu/ops/pallas/ssim.py::_ssim_kernel (:55, pallas_call in
// ssim_map_pallas :142). Semantics of the plain version
// crfp_torch/ops/cuda/ssim.py::ssim_map_ref: the five moments of x and y
// (mean x, mean y, x^2, y^2, xy) under an 11x11 Gaussian window, sigma 1.5,
// with zero 'same' padding; then
//   ((2 mu1 mu2 + C1)(2 s12 + C2)) / ((mu1^2 + mu2^2 + C1)(s11 + s22 + C2))
// with s11 = <x^2> - mu1^2 (and likewise), C1 = 1e-4, C2 = 9e-4. The window
// is the outer product of the f32-normalised 1-D taps, which the caller
// passes. The map is written (N, C, H, W) contiguous.
//
// Bound on the H100: x, y in and the map out, 12 bytes per pixel and plane
// (the training step's (14, 3, 192, 192) + (14, 1, 192, 192) calls: 24.8 MB,
// 7.4 us at 3.35 TB/s), against ~119 FMAs per pixel and plane (the 11 column
// taps of five moments on 74 columns per 64 outputs, then the 11 row taps)
// and ~60 other instructions (copies, loads, the three products, the
// formula): 7.3 us of FMAs at 67 TFLOP/s, ~11 us of issue. The design keeps
// the FMAs fed and everything else off their path.
//
// Design (ops/cuda/ssim.py::ssim_plan mirrors the geometry): a block owns a
// kTW x kTH output tile of one image and walks its C channels, so that an
// NHWC image's interleaved rows are read once into L1 and serve every
// channel. Per channel:
//  0. the tile's x and y with a 5-pixel halo (zeros outside the image: the
//     'same' padding) arrive in shared memory by cp.async, issued by every
//     thread at once: one memory latency a channel, not one a row. A warp
//     copies whole rows, each lane the same three columns of every row, so
//     the addresses are one 32-bit add a value. The next channel's copies
//     are issued as soon as the vertical pass has read this one's, and land
//     while the horizontal pass runs.
//  1. vertical pass: a thread takes one of the tile's kTW + 10 halo columns
//     and a strip of kR output rows; it reads each of the strip's kR + 10
//     input rows of x and y once, forms x^2, y^2 and xy once, and adds each
//     into the kR outputs whose window holds that row (5 kR sums in
//     registers); the sums go to shared memory.
//  2. horizontal pass: a thread takes a run of kRun consecutive outputs of
//     one row, reads the run's kRun + 10 values of each moment from shared
//     memory once (four float4 and a float2), forms the 11-tap sums and the
//     formula, and stores the run as two float4 (one 32-byte sector). A
//     warp takes 8 rows x 4 runs; a row pitch of 76 floats puts the 8 rows
//     of a quarter warp's float4 loads on distinct banks.
// Each output's sums are formed in the plain version's order (column taps
// k = 0..10, then row taps k = 0..10, each a chain of fmaf from 0), so the
// map's bits do not depend on the operands' layout. The TPU kernel DMAs row
// tiles with an 8-row halo and rolls lanes for the horizontal taps; an SM
// has no such lanes, and shared memory's bandwidth would bind a pass that
// reads 11 values per tap.
#include "common.cuh"

namespace {

constexpr int kWin = 11;
constexpr int kHalf = kWin / 2;
constexpr int kTW = 64;                // output tile width
constexpr int kTH = 16;                // output tile height
constexpr int kR = 8;                  // output rows per vertical-pass strip
constexpr int kRun = 8;                // outputs per thread in the horizontal pass
constexpr int kCols = kTW + 2 * kHalf;  // halo columns of the vertical pass
constexpr int kRows = kTH + 2 * kHalf;  // halo rows of the input tile
constexpr int kPitch = kCols + 2;      // shared row of moments: 16-byte aligned
constexpr int kMoments = 5;
// Items of the vertical pass (a halo column and a strip each, 148) and runs
// of the horizontal pass (128); a block has a thread for each of the more
// numerous, so that the vertical pass, which costs the most, keeps every
// thread busy. The last warp is partial.
constexpr int kItems = kCols * (kTH / kR);
constexpr int kRuns = kTH * kTW / kRun;
constexpr int kThreads = kItems > kRuns ? kItems : kRuns;
constexpr int kWarps = kThreads / 32;  // full warps
// the moments [5][kTH][kPitch] and the input tile of x and y, [2][kRows][kCols]:
// 39,712 bytes, under the 48 KB a launch may take without opting in
constexpr int kSmem = (kMoments * kTH * kPitch + 2 * kRows * kCols) * (int)sizeof(float);
static_assert(kSmem <= 48 * 1024, "the tile must fit the default shared memory");
static_assert(kTH % 8 == 0 && kTH % kR == 0, "a warp takes 8 rows; strips tile kTH");

struct Taps {
  float g[kWin];
};

// 4 bytes global -> shared, asynchronous; zero-filled where !valid
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// Where a lane's columns of the input tile lie: slot k holds tile column
// lane + 32 k (used where < kCols), its element offset in a row of x and of
// y, and whether it lies inside the image.
struct Columns {
  int offx[3], offy[3];
  bool in[3];
};

// Issues the copies of one channel's input tile (rows ty0 - 5 .., columns
// as `cols`) into sx, sy and commits them as one group. xc, yc: the
// channel's plane of x and y, rows sxh and syh elements apart; offsets
// inside an image fit 32 bits (the C entry checks).
__device__ __forceinline__ void stage(float* sx, float* sy, const float* xc,
                                      const float* yc, const Columns& cols, int ty0,
                                      int H, int sxh, int syh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a block's last, partial warp copies nothing
  for (int r = warp < kWarps ? warp : kRows; r < kRows; r += kWarps) {
    const int gy = ty0 - kHalf + r;
    const bool row_in = gy >= 0 && gy < H;
    const int rowx = row_in ? gy * sxh : 0, rowy = row_in ? gy * syh : 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int col = lane + 32 * k;
      if (col < kCols) {
        const bool in = row_in && cols.in[k];
        copy4(sx + r * kCols + col, xc + (in ? rowx + cols.offx[k] : 0), in);
        copy4(sy + r * kCols + col, yc + (in ? rowy + cols.offy[k] : 0), in);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// x's element strides (sxn, sxc, sxh, sxw), y's (syn, ...); out contiguous
__global__ void __launch_bounds__(kThreads)
ssim_kernel(const float* __restrict__ x, const float* __restrict__ y,
            float* __restrict__ out, int C, int H, int W, long long sxn, int sxc,
            int sxh, int sxw, long long syn, int syc, int syh, int syw, Taps taps) {
  __shared__ __align__(16) float smem[kSmem / sizeof(float)];
  float(*vm)[kTH][kPitch] = reinterpret_cast<float(*)[kTH][kPitch]>(smem);
  float* sx = smem + kMoments * kTH * kPitch;  // [kRows][kCols]
  float* sy = sx + kRows * kCols;

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
  // horizontal pass: warp w takes rows (w / 2) * 8 .. + 8 and runs
  // (w % 2) * 4 .. + 4 of the tile; lane l row l % 8, run l / 8
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hrow = (warp >> 1) * 8 + (lane & 7);
  const int hcol = ((warp & 1) * 4 + (lane >> 3)) * kRun;
  const int oy = ty0 + hrow, ox = tx0 + hcol;
  const bool vec_out = (W & 3) == 0 && ox + kRun <= W;
  const float* xn = x + n * sxn;
  const float* yn = y + n * syn;
  Columns cols;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int gx = tx0 - kHalf + lane + 32 * k;
    cols.in[k] = gx >= 0 && gx < W;
    cols.offx[k] = gx * sxw;
    cols.offy[k] = gx * syw;
  }

  stage(sx, sy, xn, yn, cols, ty0, H, sxh, syh);
  for (int c = 0; c < C; ++c) {
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    if (threadIdx.x < kItems) {
      const int col = threadIdx.x % kCols, strip = threadIdx.x / kCols;
      float acc[kMoments][kR];
#pragma unroll
      for (int m = 0; m < kMoments; ++m)
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[m][i] = 0.f;
#pragma unroll
      for (int j = 0; j < kR + 2 * kHalf; ++j) {
        const float xv = sx[(strip * kR + j) * kCols + col];
        const float yv = sy[(strip * kR + j) * kCols + col];
        const float xx = xv * xv, yy = yv * yv, xy = xv * yv;
        // input row j is tap k = j - i of output row i
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int k = j - i;
          if (k >= 0 && k < kWin) {
            const float g = taps.g[k];
            acc[0][i] = fmaf(g, xv, acc[0][i]);
            acc[1][i] = fmaf(g, yv, acc[1][i]);
            acc[2][i] = fmaf(g, xx, acc[2][i]);
            acc[3][i] = fmaf(g, yy, acc[3][i]);
            acc[4][i] = fmaf(g, xy, acc[4][i]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMoments; ++m)
#pragma unroll
        for (int i = 0; i < kR; ++i) vm[m][strip * kR + i][col] = acc[m][i];
    }
    __syncthreads();
    // the input tile is read: the next channel's copies land meanwhile
    if (c + 1 < C)
      stage(sx, sy, xn + (c + 1) * sxc, yn + (c + 1) * syc, cols, ty0, H, sxh, syh);

    if (threadIdx.x >= kRuns) continue;
    float mom[kMoments][kRun];
#pragma unroll
    for (int m = 0; m < kMoments; ++m) {
      float v[kRun + 2 * kHalf];
      const float4* row4 = reinterpret_cast<const float4*>(&vm[m][hrow][hcol]);
#pragma unroll
      for (int q = 0; q < kRun / 2; ++q) {
        const float4 f = row4[q];
        v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
      }
      const float2 tail = reinterpret_cast<const float2*>(row4 + kRun / 2)[0];
      v[2 * kRun] = tail.x, v[2 * kRun + 1] = tail.y;
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kWin; ++k) s = fmaf(taps.g[k], v[o + k], s);
        mom[m][o] = s;
      }
    }
    if (oy < H) {
      const float c1 = 1e-4f, c2 = 9e-4f;
      float res[kRun];
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        const float mu1 = mom[0][o], mu2 = mom[1][o];
        const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
        const float s11 = mom[2][o] - mu1_sq, s22 = mom[3][o] - mu2_sq;
        const float s12 = mom[4][o] - mu1_mu2;
        res[o] = ((2.f * mu1_mu2 + c1) * (2.f * s12 + c2)) /
                 ((mu1_sq + mu2_sq + c1) * (s11 + s22 + c2));
      }
      float* orow = out + (((long long)n * C + c) * H + oy) * W + ox;
      if (vec_out) {
        reinterpret_cast<float4*>(orow)[0] = make_float4(res[0], res[1], res[2], res[3]);
        reinterpret_cast<float4*>(orow)[1] = make_float4(res[4], res[5], res[6], res[7]);
      } else {
#pragma unroll
        for (int o = 0; o < kRun; ++o)
          if (ox + o < W) orow[o] = res[o];
      }
    }
    // the next channel's vertical pass rewrites vm after its own barrier
  }
}

// the largest element offset inside one image
long long span(int C, int H, int W, long long sc, long long sh, long long sw) {
  return (C - 1) * sc + (H - 1) * sh + (W - 1) * sw;
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// x, y: (N, C, H, W) f32, x read at element strides (sxn, sxc, sxh, sxw), y
// at (syn, syc, syh, syw), each non-negative with every offset inside an
// image below 2^31; out: (N, C, H, W) f32 contiguous. taps: the 11 f32 taps
// of the 1-D Gaussian, read on the host.
extern "C" int crfp_ssim(const void* x, const void* y, void* out, int N, int C,
                         int H, int W, long long sxn, long long sxc, long long sxh,
                         long long sxw, long long syn, long long syc, long long syh,
                         long long syw, const float* taps, void* stream) {
  if (sxc < 0 || sxh < 0 || sxw < 0 || syc < 0 || syh < 0 || syw < 0 ||
      span(C, H, W, sxc, sxh, sxw) > INT32_MAX || span(C, H, W, syc, syh, syw) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int k = 0; k < kWin; ++k) t.g[k] = taps[k];
  dim3 grid((unsigned)((W + kTW - 1) / kTW), (unsigned)((H + kTH - 1) / kTH), (unsigned)N);
  ssim_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(out),
      C, H, W, sxn, (int)sxc, (int)sxh, (int)sxw, syn, (int)syc, (int)syh, (int)syw, t);
  return (int)cudaGetLastError();
}
