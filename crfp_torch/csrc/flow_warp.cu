// Kernel B: windowed backward flow warp, NCHW.
//
// Replaces crfp_tpu/ops/pallas/warp.py::flow_warp_windowed_pallas (:29) and
// flow_warp_windowed_pallas_s2d (:55), which run the DCN kernel
// crfp_tpu/ops/pallas/dcn.py::_dcn_kernel (:59) at k=1 with an identity
// weight. Semantics of crfp_torch/ops/warp.py::flow_warp_windowed_ref: the
// flow (dx, dy) is clamped to +-D (D < 0: no clamp) and x is sampled
// bilinearly at (y + dy, x + dx), zeros outside the frame.
//
// Anchored (crfp_tpu/ops/pallas/warp.py's anchor=True): the flow is
// clipped around the anchor of the TPU kernel's cell that holds the pixel
// instead, F + clip(flow - F, +-dl), and sampled exactly there, zeros
// outside the frame. A pre-pass (common.cuh::anchor_table_kernel, plain
// version crfp_torch/ops/anchor.py::anchor_table) writes one (dy, dx)
// anchor per cell of band x xtile pixels. The corners are checked against
// the frame, so the anchored reach (up to ~2 D) needs no padding; the
// table costs one 8-byte load a pixel, from L1 (a warp's 32 pixels span
// one or two cells).
//
// What bounds it on the H100: bytes. HR state (1,4,720,720) bf16 4.1 MB +
// flow (1,2,720,720) f32 4.1 MB + out 4.1 MB = 12.4 MB, 3.7 us at 3.35 TB/s;
// the gate's (1,4,720,1280) 22 MB, 6.6 us; lv states (1,24,180,180) 3.4 MB,
// 1.0 us. A launch lasts microseconds: what it costs is the latency of a
// thread's chain of dependent memory operations times the number of waves
// of threads, so every thread has to keep many loads in flight.
//
// Design: one thread per (pixel, block of kCBlock = 4 channels); a block
// is a tile of 32 x 8 pixels. A warp is 32 pixels of one row, so its flow
// loads, corner gathers and stores each fall into one or two 128-byte
// lines; the eight rows of a tile share their corner rows (row y + 1 of one
// warp is row y of the next), so the tile fetches 9 rows of x for 8 rows of
// output where a 256-pixel row strip fetched 2 for 1. That halving of the
// requests to L2 is what the kernel answered to. The thread reads its
// flow, builds the four corner weights once and starts all 16 corner loads
// of its four channels before the first store. A channel block that C
// cuts short takes the same path one channel at a time.
//
// Tried and not kept (H100 80GB HBM3, 700 W, chip_smoke.py phase 2, bf16):
// a thread owning 8 consecutive pixels with 16-byte flow loads and 16-byte
// output stores. Its corner gathers are then 16 bytes apart within a warp
// (four lines per load instead of one) and it needs 80 registers:
// 15.9 us at (1,4,720,720) and 27.5 at (1,4,720,1280), against 13.2 and 21.8
// for one pixel per thread. Issuing the 16 loads before the first store,
// on row strips, changed nothing (13.5 and 23.2); the tile did.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 2, bf16;
// device time: 20 calls replayed from one CUDA graph; before -> after, in
// turns in one run): (1,4,720,720) 13.4 -> 10.9 us, bound 3.7, a device
// copy of as many bytes 5.0, F.grid_sample 13.7; (1,4,720,1280) 22.4 -> 17.5,
// bound 6.6, copy 4.9, grid_sample 21.3; (1,24,180,180) 4.4 -> 4.3, bound 1.0,
// grid_sample 7.5; (1,32,180,320) 7.3 -> 6.8; (1,24,180,320) 6.0 -> 5.3. So
// 2.7-2.9x the bound at the HR shapes and 2.2-3.5x a plain copy: not the
// bytes but the requests bound it (some 200 instructions and 22 memory
// instructions per pixel for 24 bytes). 40 registers, no spills.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCBlock = 4;
constexpr int kTileW = 32, kTileH = kThreads / kTileW;  // a block's tile of pixels

// The anchored form's table and cell grid (Anchor::table NULL: the clamp).
struct Anchor {
  const float* table;  // [N][nb][nt][2], (dy, dx)
  int band, xtile, nb, nt;
  float dl_r, dl_c;
};

template <typename T, bool ANCHORED>
__global__ void __launch_bounds__(kThreads)
flow_warp_kernel(const T* __restrict__ x, const float* __restrict__ flow,
                 T* __restrict__ out, int C, int H, int W, float D, Anchor an) {
  const int HW = H * W;
  const int px = blockIdx.x * kTileW + threadIdx.x % kTileW;
  const int py = blockIdx.y * kTileH + threadIdx.x / kTileW;
  if (px >= W || py >= H) return;
  const int p = py * W + px;
  const int cblocks = (C + kCBlock - 1) / kCBlock;
  const int c0 = (blockIdx.z % cblocks) * kCBlock;
  const int n = blockIdx.z / cblocks;
  const float flow_x = __ldg(flow + (long long)n * 2 * HW + p);
  const float flow_y = __ldg(flow + (long long)n * 2 * HW + HW + p);
  float sx, sy;
  if constexpr (ANCHORED) {
    const float* f =
        an.table + (((long long)n * an.nb + py / an.band) * an.nt + px / an.xtile) * 2;
    const float ay = __ldg(f), ax = __ldg(f + 1);
    sx = (float)px + (ax + fminf(fmaxf(flow_x - ax, -an.dl_c), an.dl_c));
    sy = (float)py + (ay + fminf(fmaxf(flow_y - ay, -an.dl_r), an.dl_r));
  } else {
    sx = (float)px + crfp::clamp_window(flow_x, D);
    sy = (float)py + crfp::clamp_window(flow_y, D);
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
  // only read where a corner is inside, so the index may lie outside
  const int i00 = y0 * W + x0;
  const long long plane0 = ((long long)n * C + c0) * HW;
  const T* xc = x + plane0 + i00;
  T* oc = out + plane0 + p;
  if (c0 + kCBlock <= C) {
    float v00[kCBlock], v01[kCBlock], v10[kCBlock], v11[kCBlock];
#pragma unroll
    for (int k = 0; k < kCBlock; ++k) {
      const T* q = xc + (long long)k * HW;
      v00[k] = b00 ? crfp::load_f(q) : 0.f;
      v01[k] = b01 ? crfp::load_f(q + 1) : 0.f;
      v10[k] = b10 ? crfp::load_f(q + W) : 0.f;
      v11[k] = b11 ? crfp::load_f(q + W + 1) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kCBlock; ++k)
      oc[(long long)k * HW] =
          crfp::store_f<T>(v00[k] * w00 + v01[k] * w01 + v10[k] * w10 + v11[k] * w11);
  } else {
    for (int k = 0; c0 + k < C; ++k) {
      const T* q = xc + (long long)k * HW;
      const float v00 = b00 ? crfp::load_f(q) : 0.f;
      const float v01 = b01 ? crfp::load_f(q + 1) : 0.f;
      const float v10 = b10 ? crfp::load_f(q + W) : 0.f;
      const float v11 = b11 ? crfp::load_f(q + W + 1) : 0.f;
      oc[(long long)k * HW] =
          crfp::store_f<T>(v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* flow, void* out, int N, int C,
                   int H, int W, float D, const Anchor& an, cudaStream_t s) {
  dim3 grid((unsigned)((W + kTileW - 1) / kTileW), (unsigned)((H + kTileH - 1) / kTileH),
            (unsigned)(N * ((C + kCBlock - 1) / kCBlock)));
  if (an.table != nullptr)
    flow_warp_kernel<T, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), flow, static_cast<T*>(out), C, H, W, D, an);
  else
    flow_warp_kernel<T, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), flow, static_cast<T*>(out), C, H, W, D, an);
  return cudaGetLastError();
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// x: (N, C, H, W) f32 or bf16 (x_bf16); flow (N, 2, H, W) f32, channels
// (dx, dy); out (N, C, H, W) in x's type. All contiguous; a plane holds
// fewer than 2^31 pixels, N at most 65535. anchor: NULL (the clamp to +-D)
// or f32 scratch of N * ceil(H / band) * ceil(W / xtile) * 2 for the
// anchored form's table, whose anchors are quantized to sub_tile rows and
// lane_q columns within +-a_y / +-a_x, with residual margins dl_r (rows)
// and dl_c (columns).
extern "C" int crfp_flow_warp(const void* x, const void* flow, void* out,
                              int N, int C, int H, int W, float D, int x_bf16,
                              void* anchor, int band, int xtile, int sub_tile, int lane_q,
                              int a_y, int a_x, float dl_r, float dl_c, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if ((long long)H * W > 0x7fff0000LL || H > 8 * 65535 ||
      (long long)N * ((C + 3) / 4) > 65535)
    return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(flow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Anchor an{nullptr, 0, 0, 0, 0, 0.f, 0.f};
  if (anchor != nullptr) {
    if (band < 1 || xtile < 1) return (int)cudaErrorInvalidValue;
    const crfp::AnchorGrid g{band, xtile, (H + band - 1) / band, (W + xtile - 1) / xtile,
                             sub_tile, lane_q, a_y, a_x, dl_r, dl_c};
    // the flow's dy is its channel 1, dx its channel 0
    const cudaError_t e = crfp::launch_anchor_table(f, static_cast<float*>(anchor), N, 1, 1,
                                                    1, 0, H, W, g, s);
    if (e != cudaSuccess) return (int)e;
    an = Anchor{static_cast<const float*>(anchor), band, xtile, g.nb, g.nt, dl_r, dl_c};
  }
  cudaError_t e = x_bf16
                      ? launch<__nv_bfloat16>(x, f, out, N, C, H, W, D, an, s)
                      : launch<float>(x, f, out, N, C, H, W, D, an, s);
  return (int)e;
}
