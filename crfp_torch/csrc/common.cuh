// Shared helpers of the crfp_torch kernels: float <-> storage type
// conversion, the window clamp and its derivative, the error-string export
// every kernel library carries, and the one tiled device routine of kernels
// A (dcn_fwd.cu) and E (dcn_fused.cu): x packed per group, pixel-major, by
// a pre-pass; tiles of pixels per block on a persistent grid; the weight
// staged once per block; the bf16 contraction on the tensor cores
// (mma.sync). The two kernels differ only in their prologue. Beside the
// tuned routes, the general route of A, E and D (dcn_tiles_general, gen_*),
// which takes every width. Also the anchor-table pre-pass of the anchored
// calls of A and B (flow_warp.cu).
#pragma once

#include <cstdint>
#include <type_traits>

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

// Anchored windows (crfp_tpu/ops/pallas/dcn.py:1006-1007), the one copy of
// their arithmetic for kernels A and D: the anchor F of the cell that holds
// pixel (py, px) of image-group ng, in a table f32 [N*G][nb][nt][2] as (dy,
// dx) of cells of band x xtile pixels (ops/anchor.py::anchor_table's) ...
__device__ __forceinline__ float2 cell_anchor(const float* table, long long ng, int py, int px,
                                              int band, int xtile, int nb, int nt) {
  const float* f = table + ((ng * nb + py / band) * nt + px / xtile) * 2;
  return make_float2(__ldg(f), __ldg(f + 1));
}

// ... where an offset (oy, ox) samples around it, F + clip(off - F, +-dl),
// as (dy, dx) ...
__device__ __forceinline__ float2 anchored_offset(float2 f, float oy, float ox, float dl_r,
                                                  float dl_c) {
  return make_float2(f.x + fminf(fmaxf(oy - f.x, -dl_r), dl_r),
                     f.y + fminf(fmaxf(ox - f.y, -dl_c), dl_c));
}

// ... and that clip's derivative, torch.clamp's: 1 where |off - F| <= dl
// (the margins are never negative)
__device__ __forceinline__ float2 anchored_pass(float2 f, float oy, float ox, float dl_r,
                                                float dl_c) {
  const float ry = oy - f.x, rx = ox - f.y;
  return make_float2(ry >= -dl_r && ry <= dl_r ? 1.f : 0.f, rx >= -dl_c && rx <= dl_c ? 1.f : 0.f);
}

// ---------------------------------------------------------------------------
// Kernels A (dcn_fwd.cu) and E (dcn_fused.cu): one tiled device routine in
// two contractions, parametrised on where each tap's (dy, dx, m) come from
// (the prologue: ProA reads the f32 offset and mask tensors, ProE computes
// them from the raw heads and the flow). Each call launches two kernels:
//  1. pack_x, a pre-pass that packs x per group, pixel-major with the CPG
//     channels contiguous ([N][G][H'][W'][CPG], scratch from the wrapper),
//     so that a corner of a sample is one 4-16 byte load of all the group's
//     channels (NCHW took one 2-byte load per channel and corner). A
//     clamped call's planes carry a zero border of pad = ceil(D) + 1 pixels
//     below and pad + 1 above the frame (H' = H + 2 pad + 1), which holds
//     every corner it can sample, so its corners need no frame check; an
//     unclamped call's planes have no border and its corners are checked.
//  2. the tiled kernel. A block owns tiles of output pixels of one image
//     with all O outputs; the grid is persistent (as many blocks as fit on
//     the card, each walking tiles blockIdx.x, + gridDim.x, ...); the
//     weight is staged once per block in the layout its contraction reads.
//     Every (pixel, group) takes its 9 taps' (dy, dx, m) from the prologue
//     and samples the group's channels bilinearly at p + p_k + (dy, dx).
//      - dcn_tiles_mma (bf16 x, O = 32, per-tap mask): 32 pixels a block of
//        8 warps, a warp per group, the modulated samples rounded to bf16 as
//        the TPU kernel rounds them (crfp_tpu/ops/pallas/dcn.py:169), the
//        contraction over K = 9*C on the tensor cores (mma.sync m16n8k16).
//      - dcn_tiles (f32 x, O < 32, a shared mask): a thread per pixel walks
//        the groups with the pixel's O sums in registers, f32 FMAs on the
//        CUDA cores; a shared mask scales each group's sum once
//        (crfp_tpu/ops/pallas/dcn.py:196-200).
//      - dcn_tiles_wide_mma (bf16 x, O = 64, C = 64, per-tap): 64 pixels a
//        block of 8 warps, the samples built one tap at a time into U (the
//        corners copied by cp.async, lanes across a wide group's channels,
//        16 bytes each), rounded to bf16 as above, each tap contracted on
//        the tensor cores (mma.sync m16n8k16, ldmatrix) while the next
//        tap's corners are in flight.
//      - dcn_tiles_wide (f32 x, O = 64, per-tap): a thread per pixel, the
//        64 sums in registers, f32 FMAs on the CUDA cores with the group's
//        channels walked in 16-byte chunks.
// The corners come from the packed planes through L1 (at O = 64 by
// cp.async). Staging each group's window of x in shared memory (cp.async,
// double-buffered) was built for O <= 32 and measured slower at every shape
// of the main paths (PERF.md).
// Checked and padded planes feed the same arithmetic in the same order; the
// bias is added last; sums are formed in a fixed order with no atomics, so
// two runs are bit-equal.
// ---------------------------------------------------------------------------

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// one packed pixel: the group's CPG channels, contiguous
template <typename T, int CPG>
struct alignas(sizeof(T) * CPG) Pix {
  T v[CPG];
};

constexpr int kTaps = 9;          // 3x3 kernels
constexpr int kMmaO = 32;         // output channels of the tensor-core path
constexpr int kMmaWarps = 8;      // its block: one warp per group (of 8)
constexpr int kOutStride = 36;    // f32 row of its output tile
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // the H100's 227 KB per block

// Resident blocks of 256 threads per SM that __launch_bounds__ asks for: 3
// (at most 85 registers a thread) on the tensor-core path at O = 32 and at
// O < 32; 2 (128 registers) on the tensor-core path at O = 64, as many as
// its 114,688 bytes of shared memory let in; 1 on the f32 path at O >= 32,
// whose 64 sums a pixel would spill with fewer.
__host__ __device__ constexpr int min_blocks(bool mma, int o) {
  return mma ? (o == 64 ? 2 : 3) : (o < 32 ? 3 : 1);
}

// Rows (columns) of a packed plane of n rows (columns) with a zero border of
// `pad`: a clamped call's corners lie at most pad below and pad + 1 above
// the frame (a corner at exactly +D has weight 0 but is still read).
__host__ __device__ inline int padded(int n, int pad) { return pad > 0 ? n + 2 * pad + 1 : n; }

// Where the corners come from: the packed planes with frame checks (an
// unclamped call), or the packed planes zero-padded by `pad` pixels (a
// clamped call: every corner lies inside, no checks).
enum Source { kChecked = 0, kPadded = 1 };

// bf16 elements per U / weight row of the tensor-core path: K = 9*C padded
// to 16, plus 8 so that the fragment loads of 8 rows x 4 words hit 32
// distinct banks
__host__ __device__ constexpr int mma_kstride(int c) {
  return (kTaps * c + 15) / 16 * 16 + 8;
}

// The tensor-core path at O = 64 (dcn_tiles_wide_mma): tiles of kWidePix
// pixels, C = kWideC input channels.
constexpr int kWideO = 64;
constexpr int kWidePix = 64;
constexpr int kWideC = 64;

// Bytes of dynamic shared memory; ops/cuda/dcn.py::tile_plan computes the
// same, and the C entries refuse a plan that differs. Tensor-core path at O
// = 32: the bf16 weight [32][ks], U [32][ks] and the f32 output tile
// [32][kOutStride], in this order; at O = 64: the bf16 weight [64][9C],
// the staging area of the corners [4][kWidePix][C] and U [kWidePix][C],
// all bf16 (114,688 bytes at C = 64: two blocks an SM); CUDA-core path: the
// f32 weight.
__host__ __device__ inline int smem_bytes(bool mma, int C, int O) {
  if (mma && O == kWideO) return O * kTaps * C * 2 + 5 * kWidePix * C * 2;
  return mma ? 2 * 32 * mma_kstride(C) * 2 + 32 * kOutStride * 4 : C * kTaps * O * 4;
}

// What a tap needs from the prologue, for one pixel and group.
struct Taps {
  float dy[kTaps], dx[kTaps], m[kTaps];
  float gm;  // the shared mask (1 otherwise)
};

// Kernel A's prologue: f32 offsets (N, G*T*2, H, W), channel (g*T + k)*2 +
// {dy, dx}, T = 1 under shared_taps; f32 masks (N, G*M, H, W), M = 1 under
// shared_mask. Every component is clamped to +-D; or, anchored (`anchor` not
// NULL), clipped around the anchor F of the TPU kernel's cell that holds the
// pixel: F + clip(off - F, +-dl) (crfp_tpu/ops/pallas/dcn.py:1006-1007), here
// under shared taps, tap by tap in the general route's tap() and in
// ProATap. The anchors, f32 [N][G][nb][nt][2] as (dy, dx), are
// ops/anchor.py::anchor_table's, one per (image, group, cell) of `band` x
// `xtile` pixels, the mean over the cell and the T taps.
struct ProA {
  const float* off;
  const float* mask;
  int shared_taps, shared_mask;
  const float* anchor = nullptr;
  int W = 0, band = 1, xtile = 1, nb = 0, nt = 0;
  float dl_r = 0.f, dl_c = 0.f;

  // crfp::cell_anchor for pixel p of image-group ng, and crfp::anchored_offset
  __device__ __forceinline__ float2 cell_anchor(long long ng, long long p) const {
    const int py = (int)(p / W), px = (int)(p - (long long)py * W);
    return crfp::cell_anchor(anchor, ng, py, px, band, xtile, nb, nt);
  }
  __device__ __forceinline__ float2 anchored(float2 f, float oy, float ox) const {
    return anchored_offset(f, oy, ox, dl_r, dl_c);
  }

  __device__ __forceinline__ void operator()(int n, int g, int G, long long p,
                                             long long HW, float D, Taps& t) const {
    const long long ng = (long long)n * G + g;
    if (shared_taps) {
      const float* o = off + ng * 2 * HW + p;
      float dy, dx;
      if (anchor != nullptr) {
        const float2 e = anchored(cell_anchor(ng, p), __ldg(o), __ldg(o + HW));
        dy = e.x, dx = e.y;
      } else {
        dy = clamp_window(__ldg(o), D), dx = clamp_window(__ldg(o + HW), D);
      }
#pragma unroll
      for (int k = 0; k < kTaps; ++k) t.dy[k] = dy, t.dx[k] = dx;
    } else {
      const float* o = off + ng * kTaps * 2 * HW + p;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        t.dy[k] = clamp_window(__ldg(o + (2 * k) * HW), D);
        t.dx[k] = clamp_window(__ldg(o + (2 * k + 1) * HW), D);
      }
    }
    if (shared_mask) {
      t.gm = __ldg(mask + ng * HW + p);
#pragma unroll
      for (int k = 0; k < kTaps; ++k) t.m[k] = 1.f;
    } else {
      t.gm = 1.f;
      const float* mk = mask + ng * kTaps * HW + p;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) t.m[k] = __ldg(mk + k * HW);
    }
  }

  // The general route's prologue: pixel() what a pixel shares across its
  // taps and groups (ProE: its flow; here nothing), tap() tap k of K2 for
  // one pixel and group, the same arithmetic as operator() at any tap count;
  // m the tap's mask (1 under shared_mask), gm the shared mask (1 otherwise).
  __device__ __forceinline__ float2 pixel(int, long long, long long) const {
    return make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void tap(float2, int n, int g, int G, int k, int K2, long long p,
                                      long long HW, float D, float& dy, float& dx, float& m,
                                      float& gm) const {
    const long long ng = (long long)n * G + g;
    const float* o = off + (shared_taps ? ng * 2 * HW : (ng * K2 + k) * 2 * HW) + p;
    if (anchor != nullptr) {
      const float2 e = anchored(cell_anchor(ng, p), __ldg(o), __ldg(o + HW));
      dy = e.x, dx = e.y;
    } else {
      dy = clamp_window(__ldg(o), D), dx = clamp_window(__ldg(o + HW), D);
    }
    if (shared_mask) {
      m = 1.f, gm = __ldg(mask + ng * HW + p);
    } else {
      m = __ldg(mask + (ng * K2 + k) * HW + p), gm = 1.f;
    }
  }

  // tap()'s m alone: under shared taps a pixel and group take tap() once
  // and each later tap only its mask
  __device__ __forceinline__ float tap_mask(int n, int g, int G, int k, int K2, long long p,
                                            long long HW) const {
    return shared_mask ? 1.f : __ldg(mask + (((long long)n * G + g) * K2 + k) * HW + p);
  }
};

// Kernel A's prologue for a per-tap anchored call on the tuned routes (a
// type of its own, so that the clamped calls keep their code): ProA's
// operands, each tap k sampled at F + clip(off_k - F, +-dl) around the
// anchor F of the pixel's cell; per-tap masks.
struct ProATap {
  ProA a;

  __device__ __forceinline__ void operator()(int n, int g, int G, long long p,
                                             long long HW, float D, Taps& t) const {
    const long long ng = (long long)n * G + g;
    const float2 f = a.cell_anchor(ng, p);
    const float* o = a.off + ng * kTaps * 2 * HW + p;
    const float* mk = a.mask + ng * kTaps * HW + p;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float2 e = a.anchored(f, __ldg(o + (2 * k) * HW), __ldg(o + (2 * k + 1) * HW));
      t.dy[k] = e.x, t.dx[k] = e.y;
      t.m[k] = __ldg(mk + k * HW);
    }
    t.gm = 1.f;
  }
};

// The anchors of the TPU kernel's cells, the pre-pass of an anchored call of
// kernel A (dcn_fwd.cu) or B (flow_warp.cu); its plain version is
// crfp_torch/ops/anchor.py::anchor_table (crfp_tpu/ops/pallas/dcn.py:975-994).
// One block per (image, group, cell) of `band` x `xtile` pixels: each
// component clipped to +-reach (A + dl), averaged over the `taps` offsets of
// a pixel, summed over the cell's pixels inside the frame and divided by the
// full cell size (edge cells average over their zero padding), rounded half
// to even to its quantum, clipped to +-A and written as table[...][2] =
// (dy, dx). The offsets are (N, G*taps*2, H, W) with the y component at
// channel (g*taps + k)*2 + cy and x at + cx: (0, 1) for a DCN's offsets,
// (1, 0) for a warp's (dx, dy) flow (G = taps = 1). The sums run in
// another order than PyTorch's mean, so a cell mean within an ulp of a
// rounding boundary may round the other way; where that could move a
// sample the offset lies more than dl from one of the two anchors.
struct AnchorGrid {
  int band, xtile, nb, nt;
  int sub_tile, lane_q;  // the row and column quanta
  int a_y, a_x;          // the anchors' range, multiples of the quanta
  float dl_r, dl_c;      // the residual margins
};

constexpr int kAnchorThreads = 256;

static __global__ void __launch_bounds__(kAnchorThreads)
anchor_table_kernel(const float* __restrict__ off, float* __restrict__ table, int taps,
                    int cy, int cx, int H, int W, AnchorGrid g) {
  const int cell = blockIdx.x;  // (n * G + group) * nb * nt + bi * nt + tj
  const int tj = cell % g.nt, bi = (cell / g.nt) % g.nb;
  const long long ng = cell / (g.nt * g.nb);
  const long long HW = (long long)H * W;
  const float* base = off + ng * taps * 2 * HW;
  const float ry = (float)g.a_y + g.dl_r, rx = (float)g.a_x + g.dl_c;
  float sy = 0.f, sx = 0.f;
  for (int i = threadIdx.x; i < g.band * g.xtile; i += blockDim.x) {
    const int y = bi * g.band + i / g.xtile, x = tj * g.xtile + i % g.xtile;
    if (y >= H || x >= W) continue;
    const long long p = (long long)y * W + x;
    float vy = 0.f, vx = 0.f;
    for (int k = 0; k < taps; ++k) {
      vy += fminf(fmaxf(__ldg(base + (2 * k + cy) * HW + p), -ry), ry);
      vx += fminf(fmaxf(__ldg(base + (2 * k + cx) * HW + p), -rx), rx);
    }
    sy += vy / (float)taps;
    sx += vx / (float)taps;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    sy += __shfl_xor_sync(0xffffffffu, sy, s);
    sx += __shfl_xor_sync(0xffffffffu, sx, s);
  }
  __shared__ float part[2][kAnchorThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[0][warp] = sy, part[1][warp] = sx;
  __syncthreads();
  if (threadIdx.x != 0) return;
  sy = sx = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) sy += part[0][w], sx += part[1][w];
  const float n = (float)(g.band * g.xtile);
  const float qy = (float)g.sub_tile, qx = (float)g.lane_q;
  const float ky = (float)(g.a_y / g.sub_tile), kx = (float)(g.a_x / g.lane_q);
  table[cell * 2] = fminf(fmaxf(rintf(sy / n / qy), -ky), ky) * qy;
  table[cell * 2 + 1] = fminf(fmaxf(rintf(sx / n / qx), -kx), kx) * qx;
}

// Launch the table pre-pass over N * G * nb * nt cells.
inline cudaError_t launch_anchor_table(const float* off, float* table, int N, int G, int taps,
                                       int cy, int cx, int H, int W, const AnchorGrid& g,
                                       cudaStream_t stream) {
  if (g.band < 1 || g.xtile < 1 || g.sub_tile < 1 || g.lane_q < 1 || taps < 1 ||
      g.nb != (H + g.band - 1) / g.band || g.nt != (W + g.xtile - 1) / g.xtile)
    return cudaErrorInvalidValue;
  anchor_table_kernel<<<(unsigned)((long long)N * G * g.nb * g.nt), kAnchorThreads, 0,
                        stream>>>(off, table, taps, cy, cx, H, W, g);
  return cudaGetLastError();
}

// Kernel E's prologue: raw heads in x's type, offset channel (g*9 + k)*2 +
// {dy, dx}, mask channel g*9 + k; f32 flow (N, 2, H, W) as (dx, dy):
//   dy = clip(mag * tanh(raw_dy) + flow_dy, +-D), m = sigmoid(raw_m)
// with the product and the sum rounded apart (__fmul_rn, __fadd_rn), as
// the two PyTorch launches of the unfused path round them.
template <typename T>
struct ProE {
  const T* raw_off;
  const T* raw_mask;
  const float* flow;
  float mag;

  __device__ __forceinline__ void operator()(int n, int g, int G, long long p,
                                             long long HW, float D, Taps& t) const {
    const float fx = __ldg(flow + (long long)n * 2 * HW + p);
    const float fy = __ldg(flow + ((long long)n * 2 + 1) * HW + p);
    const long long ng = (long long)n * G + g;
    const T* ro = raw_off + ng * kTaps * 2 * HW + p;
    const T* rm = raw_mask + ng * kTaps * HW + p;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float ry = load_f(ro + (2 * k) * HW), rx = load_f(ro + (2 * k + 1) * HW);
      t.dy[k] = clamp_window(__fadd_rn(__fmul_rn(mag, tanhf(ry)), fy), D);
      t.dx[k] = clamp_window(__fadd_rn(__fmul_rn(mag, tanhf(rx)), fx), D);
      t.m[k] = 1.f / (1.f + expf(-load_f(rm + k * HW)));
    }
    t.gm = 1.f;
  }

  // The general route's prologue (ProA's interface): pixel() the pixel's
  // flow (dx, dy), read once for all its taps and groups, tap() tap k of K2,
  // operator()'s arithmetic.
  __device__ __forceinline__ float2 pixel(int n, long long p, long long HW) const {
    return make_float2(__ldg(flow + (long long)n * 2 * HW + p),
                       __ldg(flow + ((long long)n * 2 + 1) * HW + p));
  }
  __device__ __forceinline__ void tap(float2 f, int n, int g, int G, int k, int K2, long long p,
                                      long long HW, float D, float& dy, float& dx, float& m,
                                      float& gm) const {
    const long long ngk = ((long long)n * G + g) * K2 + k;
    const T* ro = raw_off + ngk * 2 * HW + p;
    dy = clamp_window(__fadd_rn(__fmul_rn(mag, tanhf(load_f(ro))), f.y), D);
    dx = clamp_window(__fadd_rn(__fmul_rn(mag, tanhf(load_f(ro + HW))), f.x), D);
    m = 1.f / (1.f + expf(-load_f(raw_mask + ngk * HW + p)));
    gm = 1.f;
  }

  // per-tap only (the general route asks, as it asks ProA)
  static constexpr int shared_taps = 0;
  __device__ __forceinline__ float tap_mask(int n, int g, int G, int k, int K2, long long p,
                                            long long HW) const {
    return 1.f / (1.f + expf(-load_f(raw_mask + (((long long)n * G + g) * K2 + k) * HW + p)));
  }
};

template <typename T>
struct TileArgs {
  const T* x;            // (N, C, H, W)
  T* xp;                 // scratch: x packed per group, [N][G][padded(H)][padded(W)][CPG]
  const float* weight;   // (O, C, 3, 3)
  const float* bias;     // (O,) or NULL
  T* out;                // (N, O, H, W)
  int N, C, H, W, G;
  float D;               // clamp; < 0: none
  int tile_h, tile_w;    // pixels of a tile
  int pad;               // zero border of the packed planes (clamped calls)
  int tiles_y, tiles_x;
};

// The bilinear geometry of a sample at (sy, sx): its top-left corner and
// the corners' four weights.
struct Bilinear {
  int y0, x0;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Bilinear bilinear(float sy, float sx) {
  const float y0f = floorf(sy), x0f = floorf(sx);
  const float fy = sy - y0f, fx = sx - x0f;
  return {(int)y0f, (int)x0f, (1.f - fy) * (1.f - fx), (1.f - fy) * fx, fy * (1.f - fx),
          fy * fx};
}

// Frame pixel (y, x) of the group's packed plane, one load of its CPG
// channels. CHECKED: src holds the frame (W pixels a row), zeros outside
// it; else src is a zero-padded plane whose pixel (0, 0) is frame pixel
// (oy, ox), `stride` pixels a row, that holds every corner.
template <typename T, int CPG, bool CHECKED>
__device__ __forceinline__ Pix<T, CPG> pixel(const Pix<T, CPG>* src, int y, int x, int oy,
                                             int ox, int stride, int H, int W) {
  if constexpr (!CHECKED) {
    return src[(long long)(y - oy) * stride + (x - ox)];
  } else {
    Pix<T, CPG> z;
#pragma unroll
    for (int c = 0; c < CPG; ++c) z.v[c] = store_f<T>(0.f);
    return y >= 0 && y < H && x >= 0 && x < W ? src[(long long)y * W + x] : z;
  }
}

template <typename T, int CPG>
__device__ __forceinline__ void blend(float (&v)[CPG], const Bilinear& b,
                                      const Pix<T, CPG>& p00, const Pix<T, CPG>& p01,
                                      const Pix<T, CPG>& p10, const Pix<T, CPG>& p11) {
#pragma unroll
  for (int c = 0; c < CPG; ++c) {
    const float c00 = to_f(p00.v[c]), c01 = to_f(p01.v[c]);
    const float c10 = to_f(p10.v[c]), c11 = to_f(p11.v[c]);
    v[c] = fmaf(b.w11, c11, fmaf(b.w10, c10, fmaf(b.w01, c01, b.w00 * c00)));
  }
}

// The bilinear sample of CPG channels at (sy, sx) from the group's packed
// plane (see pixel()): four loads.
template <typename T, int CPG, bool CHECKED>
__device__ __forceinline__ void sample(float (&v)[CPG], float sy, float sx,
                                       const Pix<T, CPG>* src, int oy, int ox,
                                       int stride, int H, int W) {
  const Bilinear b = bilinear(sy, sx);
  blend<T, CPG>(v, b, pixel<T, CPG, CHECKED>(src, b.y0, b.x0, oy, ox, stride, H, W),
                pixel<T, CPG, CHECKED>(src, b.y0, b.x0 + 1, oy, ox, stride, H, W),
                pixel<T, CPG, CHECKED>(src, b.y0 + 1, b.x0, oy, ox, stride, H, W),
                pixel<T, CPG, CHECKED>(src, b.y0 + 1, b.x0 + 1, oy, ox, stride, H, W));
}

// Programmatic dependent launch (sm_90): the tiled kernel is launched while
// the pre-pass still runs (the pre-pass lets it go once every one of its
// blocks has started), stages its weight and issues its first offset loads,
// and waits here before its first read of the packed x.
__device__ __forceinline__ void wait_for_packed_x() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// Channels of one packed load: the group's CPG channels in at most 16 bytes
// (CPG 2 and 4 fit whole; at 8, 16 and 64 channels a pixel is read and
// written in 16-byte chunks).
template <typename T, int CPG>
__host__ __device__ constexpr int chunk_of() {
  return CPG * (int)sizeof(T) <= 16 ? CPG : 16 / (int)sizeof(T);
}

// The pre-pass of every call: x (N, C, H, W) -> xp [N][G][padded(H, pad)]
// [padded(W, pad)][CPG], zeros in the border, so that a corner of a sample
// is one load of the group's CPG channels (a chunk of them at CPG > 4).
// Blocks of 32 x 8 threads over (column, row) of the padded plane;
// blockIdx.z: image x group. A thread packs a pixel; in bf16 at 16 or 64
// channels a group a warp packs its row's 32 pixels together: channel pairs
// read with a lane a pixel, transposed through shared memory, written as
// one contiguous run of 32 x CPG channels (a thread a pixel, its 16-byte
// chunks 32-128 bytes apart across the warp, took 2.6x as long at 64
// channels a group: PERF.md).
template <typename T, int CPG>
__device__ __forceinline__ void pack_x(const T* __restrict__ x, T* __restrict__ xp, int H,
                                       int W, int pad) {
  constexpr int CH = chunk_of<T, CPG>();
  allow_dependent_launch();
  const int Hp = padded(H, pad), Wp = padded(W, pad);
  const int xq = blockIdx.x * blockDim.x + threadIdx.x;
  const int yq = blockIdx.y * blockDim.y + threadIdx.y;
  const long long ng = blockIdx.z, HW = (long long)H * W;
  const int y = yq - pad, xx = xq - pad;
  const bool inside = xq < Wp && y >= 0 && y < H && xx >= 0 && xx < W;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && CPG / CH > 1) {
    constexpr int RW = CPG / 2 + 1;  // words a pixel's row, padded: no bank conflicts
    __shared__ uint32_t rows[8][32 * RW];
    if (yq >= Hp) return;  // the whole warp: blockDim is (32, 8)
    uint32_t* t = rows[threadIdx.y];
    const int lane = threadIdx.x;
    const T* src = x + ng * CPG * HW + (inside ? (long long)y * W + xx : 0);
#pragma unroll 8
    for (int c = 0; c < CPG; c += 2) {
      __nv_bfloat162 v;
      v.x = inside ? __ldg(src + c * HW) : store_f<T>(0.f);
      v.y = inside ? __ldg(src + (c + 1) * HW) : store_f<T>(0.f);
      t[lane * RW + c / 2] = *reinterpret_cast<const uint32_t*>(&v);
    }
    __syncwarp();
    const int x0 = blockIdx.x * blockDim.x, n = min(32, Wp - x0) * (CPG / 8);
    uint4* dst = reinterpret_cast<uint4*>(xp + ((ng * Hp + yq) * Wp + x0) * CPG);
    for (int i = lane; i < n; i += 32) {
      const uint32_t* w = t + (i / (CPG / 8)) * RW + (i % (CPG / 8)) * 4;
      dst[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    if (xq >= Wp || yq >= Hp) return;
    const T* src = x + ng * CPG * HW + (long long)(inside ? y : 0) * W + (inside ? xx : 0);
    Pix<T, CH>* dst =
        reinterpret_cast<Pix<T, CH>*>(xp) + ((ng * Hp + yq) * Wp + xq) * (CPG / CH);
#pragma unroll
    for (int j = 0; j < CPG / CH; ++j) {
      Pix<T, CH> v;
      if (inside) {
#pragma unroll
        for (int c = 0; c < CH; ++c) v.v[c] = __ldg(src + (j * CH + c) * HW);
      } else {
#pragma unroll
        for (int c = 0; c < CH; ++c) v.v[c] = store_f<T>(0.f);
      }
      dst[j] = v;
    }
  }
}

// D += A x B, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The CUDA-core path. SHARED_TAPS (dcn_3 in bf16 on padded planes: one
// (dy, dx) a pixel and group for all 9 taps): the taps' corners are
// integer shifts of one another and lie in the 4 x 4 pixels from the
// top-left tap's top-left corner, as the TPU kernel uses
// (crfp_tpu/ops/pallas/dcn.py:181-195). Where every tap's rounded position
// keeps that shift (the f32 sum (py + ky) + dy can round across an
// integer), the 16 loads are issued together, where the per-tap loop
// waits for each tap's 4 in turn; each tap still forms its own weights, so
// the sums are bit for bit the per-tap loop's, which takes the other
// pixels.
template <int O, int CPG, int SRC, bool SHARED_TAPS, typename T, typename Prologue>
__device__ __forceinline__ void dcn_tiles(const TileArgs<T>& a, const Prologue& pro) {
  static_assert(!SHARED_TAPS || SRC == kPadded, "the patch reads padded planes");
  constexpr bool kChk = SRC == kChecked;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int C = a.C, G = a.G, H = a.H, W = a.W;
  const long long HW = (long long)H * W;
  const int pad = a.pad, Wp = padded(W, pad);
  const long long HWp = (long long)padded(H, pad) * Wp;  // a packed plane

  // the weight, once per block, as wf[g][k][ci][o] in f32
  float* wf = reinterpret_cast<float*>(smem);
#pragma unroll 4
  for (int o = warp; o < O; o += nwarps) {
    for (int c = lane; c < C; c += 32) {
      const int g = c / CPG, ci = c % CPG;
      const float* src = a.weight + ((long long)o * C + c) * kTaps;
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
        wf[((g * kTaps + k) * CPG + ci) * O + o] = __ldg(src + k);
    }
  }
  __syncthreads();

  const Pix<T, CPG>* xp = reinterpret_cast<const Pix<T, CPG>*>(a.xp);
  const int qy = tid / a.tile_w, qx = tid - qy * a.tile_w;
  const int tiles = a.N * a.tiles_y * a.tiles_x;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % a.tiles_x, r = tile / a.tiles_x;
    const int n = r / a.tiles_y, py = (r % a.tiles_y) * a.tile_h + qy;
    const int px = tx * a.tile_w + qx;
    if (py >= H || px >= W) continue;
    const long long p = (long long)py * W + px;
    float acc[O];  // the pixel's output sums, group by group
#pragma unroll
    for (int o = 0; o < O; ++o) acc[o] = 0.f;
    for (int g = 0; g < G; ++g) {
      Taps t;
      pro(n, g, G, p, HW, a.D, t);
      wait_for_packed_x();
      const Pix<T, CPG>* src = xp + ((long long)n * G + g) * HWp;
      float gacc[O];
#pragma unroll
      for (int o = 0; o < O; ++o) gacc[o] = 0.f;
      // tap k's modulated sample v into the group's sums
      auto contract = [&](int k, const float (&v)[CPG]) {
        const float* wk = wf + (g * kTaps + k) * CPG * O;
#pragma unroll
        for (int c = 0; c < CPG; ++c) {
          const float vm = v[c] * t.m[k];
#pragma unroll
          for (int o = 0; o < O; ++o) gacc[o] = fmaf(vm, wk[c * O + o], gacc[o]);
        }
      };
      // tap (ky, kx)'s top-left corner; the top-left tap's is the patch's
      auto corner = [&](int ky, int kx, int& y, int& x) {
        y = (int)floorf((float)(py + ky - 1) + t.dy[ky * 3 + kx]);
        x = (int)floorf((float)(px + kx - 1) + t.dx[ky * 3 + kx]);
      };
      bool patch = SHARED_TAPS;
      int y0 = 0, x0 = 0;
      if constexpr (SHARED_TAPS) {
        corner(0, 0, y0, x0);
#pragma unroll
        for (int k = 1; k < kTaps; ++k) {
          int y, x;
          corner(k / 3, k % 3, y, x);
          patch = patch && y == y0 + k / 3 && x == x0 + k % 3;
        }
      }
      if (patch) {
        Pix<T, CPG> q[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            q[i][j] = pixel<T, CPG, kChk>(src, y0 + i, x0 + j, -pad, -pad, Wp, H, W);
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const int ky = k / 3, kx = k % 3;
          float v[CPG];
          const Bilinear bl =
              bilinear((float)(py + ky - 1) + t.dy[k], (float)(px + kx - 1) + t.dx[k]);
          blend<T, CPG>(v, bl, q[ky][kx], q[ky][kx + 1], q[ky + 1][kx], q[ky + 1][kx + 1]);
          contract(k, v);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          float v[CPG];
          sample<T, CPG, kChk>(v, (float)(py + k / 3 - 1) + t.dy[k],
                               (float)(px + k % 3 - 1) + t.dx[k], src, -pad, -pad, Wp, H, W);
          contract(k, v);
        }
      }
#pragma unroll
      for (int o = 0; o < O; ++o) acc[o] = fmaf(t.gm, gacc[o], acc[o]);
    }
    T* op = a.out + (long long)n * O * HW + p;
#pragma unroll
    for (int o = 0; o < O; ++o) {
      const float b = a.bias != nullptr ? __ldg(a.bias + o) : 0.f;
      op[o * HW] = store_f<T>(acc[o] + b);
    }
  }
}

// The CUDA-core path at O = 64 (kWideO: the pyramids' and PCD's per-tap
// DCNs, 4, 8, 16 or 64 channels a group; kernel A's prologue only): a
// thread per pixel keeps the pixel's 64 sums in registers, reads each tap's
// (dy, dx, m) and forms its bilinear geometry once, and walks the group's
// channels in chunks of 16 bytes (4 f32 or 8 bf16 channels, chunk_of): a
// chunk's four corners are blended, scaled by the tap's mask and
// contracted into the 64 sums (the weight row read from shared memory as
// float4, the same address in every lane) while the next chunk's corners
// load. dcn_tiles' float v[CPG] per tap and its per-group sums would hold
// 128 + CPG live floats a thread here. Where a group is more than one chunk
// the taps are a loop, not unrolled, so that the body stays in the
// instruction cache; at one chunk (4 channels) the 9 taps are unrolled, so
// that their loads overlap. The weight, f32
// [g][k][ci][o] as dcn_tiles stages it, is C x 9 x 64 x 4 bytes (147,456 at
// C = 64): one block of 256 threads an SM. bf16 x takes dcn_tiles_wide_mma.

// ANCHORED: a per-tap anchored call, each tap's offsets taken as ProATap
// takes them.
template <int CPG, int SRC, bool ANCHORED, typename T>
__device__ __forceinline__ void dcn_tiles_wide(const TileArgs<T>& a, const ProA& pro) {
  constexpr int O = kWideO, CH = chunk_of<T, CPG>(), NCH = CPG / CH;
  constexpr bool kChk = SRC == kChecked;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int C = a.C, G = a.G, H = a.H, W = a.W;
  const long long HW = (long long)H * W;
  const int pad = a.pad, Hp = padded(H, pad), Wp = padded(W, pad);
  const long long HWp = (long long)Hp * Wp;  // a packed plane, in pixels

  float* wf = reinterpret_cast<float*>(smem);
  for (int o = warp; o < O; o += nwarps) {
    for (int c = lane; c < C; c += 32) {
      const int g = c / CPG, ci = c % CPG;
      const float* src = a.weight + ((long long)o * C + c) * kTaps;
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
        wf[((g * kTaps + k) * CPG + ci) * O + o] = __ldg(src + k);
    }
  }
  __syncthreads();

  const Pix<T, CH>* xp = reinterpret_cast<const Pix<T, CH>*>(a.xp);
  const int qy = tid / a.tile_w, qx = tid - qy * a.tile_w;
  const int tiles = a.N * a.tiles_y * a.tiles_x;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % a.tiles_x, r = tile / a.tiles_x;
    const int n = r / a.tiles_y, py = (r % a.tiles_y) * a.tile_h + qy;
    const int px = tx * a.tile_w + qx;
    if (py >= H || px >= W) continue;
    const long long p = (long long)py * W + px;
    float acc[O];
#pragma unroll
    for (int o = 0; o < O; ++o) acc[o] = 0.f;
    for (int g = 0; g < G; ++g) {
      const long long ng = (long long)n * G + g;
      const float* off = pro.off + ng * kTaps * 2 * HW + p;
      const float* mk = pro.mask + ng * kTaps * HW + p;
      float2 f = make_float2(0.f, 0.f);
      if constexpr (ANCHORED) f = pro.cell_anchor(ng, p);
      wait_for_packed_x();
      const Pix<T, CH>* src = xp + ng * HWp * NCH;
#pragma unroll(NCH == 1 ? kTaps : 1)
      for (int k = 0; k < kTaps; ++k) {
        float dy, dx;
        if constexpr (ANCHORED) {  // ProATap's arithmetic
          const float2 e = pro.anchored(f, __ldg(off + (2 * k) * HW),
                                        __ldg(off + (2 * k + 1) * HW));
          dy = e.x, dx = e.y;
        } else {
          dy = clamp_window(__ldg(off + (2 * k) * HW), a.D);
          dx = clamp_window(__ldg(off + (2 * k + 1) * HW), a.D);
        }
        const float m = __ldg(mk + k * HW);
        const Bilinear b = bilinear((float)(py + k / 3 - 1) + dy, (float)(px + k % 3 - 1) + dx);
        // the corners' chunk indices in the packed plane and their weights
        // (a checked corner outside the frame: weight 0, pixel 0 read)
        long long q[4];
        float wq[4] = {b.w00, b.w01, b.w10, b.w11};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int y = b.y0 + i / 2, x = b.x0 + i % 2;
          if constexpr (kChk) {
            const bool in = y >= 0 && y < H && x >= 0 && x < W;
            q[i] = in ? ((long long)y * W + x) * NCH : 0;
            wq[i] = in ? wq[i] : 0.f;
          } else {
            q[i] = ((long long)(y + pad) * Wp + (x + pad)) * NCH;
          }
        }
        const float* wk = wf + (g * kTaps + k) * CPG * O;
        Pix<T, CH> c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = src[q[i]];
#pragma unroll 1
        for (int j = 0; j < NCH; ++j) {
          const Pix<T, CH> p00 = c[0], p01 = c[1], p10 = c[2], p11 = c[3];
          if (j + 1 < NCH) {  // the next chunk loads while this one is contracted
#pragma unroll
            for (int i = 0; i < 4; ++i) c[i] = src[q[i] + j + 1];
          }
#pragma unroll
          for (int cc = 0; cc < CH; ++cc) {
            const float v = fmaf(wq[3], to_f(p11.v[cc]),
                                 fmaf(wq[2], to_f(p10.v[cc]),
                                      fmaf(wq[1], to_f(p01.v[cc]), wq[0] * to_f(p00.v[cc]))));
            const float vm = v * m;
            const float4* w4 = reinterpret_cast<const float4*>(wk + (j * CH + cc) * O);
#pragma unroll
            for (int o4 = 0; o4 < O / 4; ++o4) {
              const float4 w = w4[o4];
              acc[4 * o4] = fmaf(vm, w.x, acc[4 * o4]);
              acc[4 * o4 + 1] = fmaf(vm, w.y, acc[4 * o4 + 1]);
              acc[4 * o4 + 2] = fmaf(vm, w.z, acc[4 * o4 + 2]);
              acc[4 * o4 + 3] = fmaf(vm, w.w, acc[4 * o4 + 3]);
            }
          }
        }
      }
    }
    T* op = a.out + (long long)n * O * HW + p;
#pragma unroll
    for (int o = 0; o < O; ++o) {
      const float b = a.bias != nullptr ? __ldg(a.bias + o) : 0.f;
      op[o * HW] = store_f<T>(acc[o] + b);
    }
  }
}

// The tensor-core path (bf16 x, O = 32, per-tap mask): a block of
// kMmaWarps warps owns a tile of 32 pixels (lane = pixel), and warp w
// samples groups w, w + kMmaWarps, ... for them, so that the 8 groups of a
// pixel are sampled by 8 warps at once. The modulated sample, rounded to
// bf16 as the TPU kernel rounds its modulated column
// (crfp_tpu/ops/pallas/dcn.py:169), goes to U[pixel][k*C + c] in shared
// memory; after a barrier warp w computes the outputs nt = w % 4 (8 of the
// 32) of the pixels mt = w / 4 (16 of the 32) as U x W over all
// K = 9*C in f32 with mma.sync m16n8k16 bf16 (K/16 steps: 18 at C = 32), W
// the block's bf16 copy of the weight, [o][k*C + c]. The sums leave through
// an f32 tile, so that the block writes each output plane coalesced. The
// x samples come from the packed planes in global memory (through L1).
// SRC: kPadded or kChecked.
template <int CPG, int SRC, typename T, typename Prologue>
__device__ __forceinline__ void dcn_tiles_mma(const TileArgs<T>& a, const Prologue& pro) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, G = a.G, H = a.H, W = a.W;
  const long long HW = (long long)H * W;
  const int KS = mma_kstride(C), KP = KS - 8, RW = KS / 2;  // RW: words a row
  const int pad = a.pad, Wp = padded(W, pad);
  const long long HWp = (long long)padded(H, pad) * Wp;  // a packed plane
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* U = wb + 32 * KS;
  float* S = reinterpret_cast<float*>(U + 32 * KS);

  // the weight, once per block: wb[o][k*C + c] in bf16; the K padding of
  // the weight and of U is zero and stays so
#pragma unroll 4
  for (int o = warp; o < kMmaO; o += kMmaWarps) {
    for (int c = lane; c < C; c += 32) {
      const float* src = a.weight + ((long long)o * C + c) * kTaps;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) wb[o * KS + k * C + c] = __float2bfloat16(__ldg(src + k));
    }
  }
  for (int r = warp; r < 32; r += kMmaWarps) {
    for (int kk = kTaps * C + lane; kk < KS; kk += 32) {
      wb[r * KS + kk] = __float2bfloat16(0.f);
      U[r * KS + kk] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  const Pix<T, CPG>* xp = reinterpret_cast<const Pix<T, CPG>*>(a.xp);
  const int qy = lane / a.tile_w, qx = lane - qy * a.tile_w;
  const int tiles = a.N * a.tiles_y * a.tiles_x;
  const int gid = lane >> 2, tq = lane & 3, mt = warp >> 2, nt = warp & 3;
  const uint32_t* U32 = reinterpret_cast<const uint32_t*>(U);
  const uint32_t* W32 = reinterpret_cast<const uint32_t*>(wb);
  Pix<__nv_bfloat16, CPG> zero;
#pragma unroll
  for (int c = 0; c < CPG; ++c) zero.v[c] = __float2bfloat16(0.f);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % a.tiles_x, r = tile / a.tiles_x;
    const int n = r / a.tiles_y, py = (r % a.tiles_y) * a.tile_h + qy;
    const int px = tx * a.tile_w + qx;
    const bool valid = py < H && px < W;
    const long long p = (long long)py * W + px;
    __nv_bfloat16* urow = U + lane * KS;

    for (int g = warp; g < G; g += kMmaWarps) {
      const Pix<T, CPG>* src = xp + ((long long)n * G + g) * HWp;
      if (valid) {
        Taps t;
        pro(n, g, G, p, HW, a.D, t);
        wait_for_packed_x();
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          float v[CPG];
          sample<T, CPG, SRC == kChecked>(v, (float)(py + k / 3 - 1) + t.dy[k],
                                          (float)(px + k % 3 - 1) + t.dx[k], src, -pad,
                                          -pad, Wp, H, W);
          Pix<__nv_bfloat16, CPG> u;
#pragma unroll
          for (int c = 0; c < CPG; ++c) u.v[c] = __float2bfloat16(v[c] * t.m[k]);
          *reinterpret_cast<Pix<__nv_bfloat16, CPG>*>(urow + k * C + g * CPG) = u;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kTaps; ++k)
          *reinterpret_cast<Pix<__nv_bfloat16, CPG>*>(urow + k * C + g * CPG) = zero;
      }
    }
    __syncthreads();  // U complete

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int s = 0; s < KP / 16; ++s) {
      uint32_t af[4], bf[2];
      const int ra = (mt * 16 + gid) * RW + s * 8 + tq;
      af[0] = U32[ra];
      af[1] = U32[ra + 8 * RW];
      af[2] = U32[ra + 4];
      af[3] = U32[ra + 8 * RW + 4];
      const int rb = (nt * 8 + gid) * RW + s * 8 + tq;
      bf[0] = W32[rb];
      bf[1] = W32[rb + 4];
      mma_bf16(acc, af, bf);
    }
    const int o0 = nt * 8 + 2 * tq, r0 = mt * 16 + gid;
    S[o0 * kOutStride + r0] = acc[0];
    S[(o0 + 1) * kOutStride + r0] = acc[1];
    S[o0 * kOutStride + r0 + 8] = acc[2];
    S[(o0 + 1) * kOutStride + r0 + 8] = acc[3];
    __syncthreads();  // S complete; U free for the next tile

    if (valid) {
      T* op = a.out + (long long)n * kMmaO * HW + p;
#pragma unroll
      for (int j = 0; j < kMmaO / kMmaWarps; ++j) {
        const int o = warp * (kMmaO / kMmaWarps) + j;
        const float b = a.bias != nullptr ? __ldg(a.bias + o) : 0.f;
        op[o * HW] = store_f<T>(S[o * kOutStride + lane] + b);
      }
    }
  }
}

// ldmatrix .x4: four 8 x 8 matrices of b16 from shared memory, lane l
// giving the address of row l % 8 of matrix l / 8; r[i] is matrix i's
// fragment (row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// cp.async of BYTES (8 or 16) from global to shared memory, through L1;
// `bytes` = 0 writes zeros and reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(BYTES), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Element (row r, column c) of a bf16 tile of `cols` columns in shared
// memory whose 16-byte chunks are XOR-swizzled by the row: chunk c / 8 of
// row r sits at chunk (c / 8) ^ (r % 8). The 8 rows an ldmatrix reads, or
// 8 lanes store, at one logical chunk fall in 8 distinct bank groups, with
// no padding.
__host__ __device__ constexpr int swz(int r, int c, int cols) {
  return r * cols + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7);
}

// The tensor-core path at O = 64 (bf16 x, C = 64, per-tap; the pyramids'
// and PCD's DCNs at 4, 8, 16 or 64 channels a group; kernel A's prologue).
// A block of kMmaWarps warps owns a tile of kWidePix = 64 pixels with all
// 64 outputs and walks its tiles' taps as one sequence of steps (tile,
// tap). A step's U is the tile's modulated samples of one tap, [pixel][c]
// in bf16 (a K-chunk of 64 of K = 9 * 64), rounded as the TPU kernel rounds
// its modulated column (crfp_tpu/ops/pallas/dcn.py:169).
//  - Sampling: a thread takes (pixel, chunk) items of 16 bytes of a group's
//    channels (8 bytes at CPG 4: the whole group), ITEMS of them a tap; the
//    CPG / CH lanes of one (pixel, group) are neighbours, so a corner of a
//    wide group is one coalesced 32-128 byte request, and the lanes of a
//    warp lie on neighbouring pixels of a tile row otherwise (their offset
//    and mask loads coalesce). The four corners of each item go from the
//    packed planes to the thread's own slots of a staging area in shared
//    memory by cp.async (zeros for a corner outside the frame), so that
//    the loads in flight hold no registers; the thread then blends its own
//    slots into U.
//  - Step s: wait for step s's corners; barrier (U free); blend them into
//    U; barrier (U complete); issue step s + 1's corner copies and step s +
//    2's offset and mask loads; contract U while they fly.
//  - Contraction: warp w computes pixels 16 (w % 4) .. + 15 x outputs
//    32 (w / 4) .. + 31 as four m16n8k16 tiles, its A fragment (ldmatrix
//    from U) reused over the four, B from the block's bf16 weight
//    [o][k * 64 + c] (ldmatrix); 4 K-steps a tap, 36 a tile, in order.
//    U and the weight are swizzled (swz), not padded.
//  - After a tile's ninth tap each lane writes its sums, bias added last,
//    straight from its fragments (8 consecutive pixels of a row a store).
// Shared memory: the weight 73,728 bytes, the staging area 32,768, U
// 8,192 (kWideSmem): two blocks of 256 threads an SM. ANCHORED: a per-tap
// anchored call, each tap's offsets taken as ProATap takes them.
template <int CPG, int SRC, bool ANCHORED>
__device__ __forceinline__ void dcn_tiles_wide_mma(const TileArgs<__nv_bfloat16>& a,
                                                   const ProA& pro) {
  using T = __nv_bfloat16;
  constexpr int C = kWideC, O = kWideO, P = kWidePix, K = kTaps * C;
  constexpr int CH = chunk_of<T, CPG>(), NCH = CPG / CH;  // channels, lanes a (pixel, group)
  constexpr int THREADS = kMmaWarps * 32;
  constexpr int ITEMS = P * C / CH / THREADS;  // (pixel, chunk) items a thread and tap
  constexpr int BYTES = CH * (int)sizeof(T);   // of a corner
  constexpr bool kChk = SRC == kChecked;
  static_assert(ITEMS * THREADS * CH == P * C && (NCH * P) % 32 == 0, "items");
  static_assert(C % 16 == 0 && C % 8 == 0, "K-steps of 16, chunks of 8");
  // warps on the contraction: MT m-tiles of 16 pixels, each computed by
  // kMmaWarps / MT warps of NT n-tiles of 8 outputs
  constexpr int MT = P / 16, NT = O / 8 / (kMmaWarps / MT);
  static_assert(kMmaWarps % MT == 0 && NT % 2 == 0, "warps on the contraction");
  extern __shared__ __align__(16) unsigned char smem[];
  T* wb = reinterpret_cast<T*>(smem);                         // [O][K], swizzled
  Pix<T, CH>* stage = reinterpret_cast<Pix<T, CH>*>(wb + O * K);  // [ITEMS][4][THREADS]
  T* U = reinterpret_cast<T*>(stage + ITEMS * 4 * THREADS);   // [P][C], swizzled
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G, H = a.H, W = a.W;
  const long long HW = (long long)H * W;
  const int pad = a.pad, Wp = padded(W, pad);
  const long long HWp = (long long)padded(H, pad) * Wp;  // a packed plane, in pixels

  // the weight, once per block: wb[o][k*C + c] in bf16
  for (int o = warp; o < O; o += kMmaWarps) {
    for (int c = lane; c < C; c += 32) {
      const float* src = a.weight + ((long long)o * C + c) * kTaps;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) wb[swz(o, k * C + c, K)] = __float2bfloat16(__ldg(src + k));
    }
  }
  // the contraction: warp w's 16 pixels x 32 outputs, four n-tiles of 8
  const int mt = warp % MT, nh = warp / MT, gid = lane >> 2, tq = lane & 3;
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int o0 = 8 * NT * nh + 8 * j + 2 * tq;
    bias[j][0] = a.bias != nullptr ? __ldg(a.bias + o0) : 0.f;
    bias[j][1] = a.bias != nullptr ? __ldg(a.bias + o0 + 1) : 0.f;
  }

  // the thread's items: item i = tid + THREADS r is chunk i % NCH of pixel
  // (i / NCH) % P of group i / (NCH P); (qy, qx) its place in the tile
  int qy[ITEMS], qx[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int q = ((tid + THREADS * r) / NCH) % P;
    qy[r] = q / a.tile_w;
    qx[r] = q - qy[r] * a.tile_w;
  }
  auto item_group = [&](int r) { return (tid + THREADS * r) / (NCH * P); };
  auto item_chunk = [&](int r) { return (tid + THREADS * r) % NCH; };
  auto item_pixel = [&](int r) { return ((tid + THREADS * r) / NCH) % P; };

  // a tile's image and top-left pixel
  auto origin = [&](int tile, int& n, int& y0, int& x0) {
    const int tx = tile % a.tiles_x, r = tile / a.tiles_x;
    n = r / a.tiles_y;
    y0 = (r % a.tiles_y) * a.tile_h;
    x0 = tx * a.tile_w;
  };
  // a step's raw offsets and mask for each item (clamped where used, a
  // step later, so that nothing waits for these loads; an anchored call
  // waits, and takes its anchored offsets here)
  float ody[ITEMS], odx[ITEMS], om[ITEMS];
  auto load_taps = [&](int n, int y0, int x0, int k) {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int py = y0 + qy[r], px = x0 + qx[r];
      ody[r] = odx[r] = om[r] = 0.f;
      if (py < H && px < W) {
        const long long ngk = ((long long)n * G + item_group(r)) * kTaps + k;
        const long long p = (long long)py * W + px;
        ody[r] = __ldg(pro.off + ngk * 2 * HW + p);
        odx[r] = __ldg(pro.off + (ngk * 2 + 1) * HW + p);
        om[r] = __ldg(pro.mask + ngk * HW + p);
        if constexpr (ANCHORED) {  // where ProATap's arithmetic samples, within the
          const float2 e =         // reach D, which the clamp then keeps
              pro.anchored(pro.cell_anchor(ngk / kTaps, p), ody[r], odx[r]);
          ody[r] = e.x, odx[r] = e.y;
        }
      }
    }
  };
  // a step's corners, copied into the thread's staging slots, and the
  // sample's fractions and mask (m = 0, zero corners past the frame)
  float cfy[ITEMS], cfx[ITEMS], cm[ITEMS];
  const Pix<T, CH>* xp = reinterpret_cast<const Pix<T, CH>*>(a.xp);
  auto gather = [&](int n, int y0, int x0, int k) {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int py = y0 + qy[r], px = x0 + qx[r];
      const bool valid = py < H && px < W;
      const float sy = (float)(py + k / 3 - 1) + clamp_window(ody[r], a.D);
      const float sx = (float)(px + k % 3 - 1) + clamp_window(odx[r], a.D);
      const float y0f = floorf(sy), x0f = floorf(sx);
      cfy[r] = sy - y0f;
      cfx[r] = sx - x0f;
      cm[r] = valid ? om[r] : 0.f;
      const int yc = (int)y0f, xc = (int)x0f;
      const Pix<T, CH>* src =
          xp + ((long long)n * G + item_group(r)) * HWp * NCH + item_chunk(r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = yc + i / 2, x = xc + i % 2;
        bool in = valid;
        long long at = 0;
        if constexpr (kChk) {
          in = in && y >= 0 && y < H && x >= 0 && x < W;
          at = in ? ((long long)y * W + x) * NCH : 0;
        } else {
          at = in ? ((long long)(y + pad) * Wp + (x + pad)) * NCH : 0;
        }
        cp_async<BYTES>(stage + (r * 4 + i) * THREADS + tid, src + at, in ? BYTES : 0);
      }
    }
    cp_async_commit();
  };
  // the thread's staged corners, blended as bilinear() weighs them,
  // modulated and rounded into U
  auto put = [&]() {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const float fy = cfy[r], fx = cfx[r];
      const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
      const float w10 = fy * (1.f - fx), w11 = fy * fx;
      Pix<T, CH> cn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cn[i] = stage[(r * 4 + i) * THREADS + tid];
      Pix<T, CH> u;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float v = fmaf(w11, to_f(cn[3].v[c]),
                             fmaf(w10, to_f(cn[2].v[c]),
                                  fmaf(w01, to_f(cn[1].v[c]), w00 * to_f(cn[0].v[c]))));
        u.v[c] = __float2bfloat16(v * cm[r]);
      }
      *reinterpret_cast<Pix<T, CH>*>(
          U + swz(item_pixel(r), item_group(r) * CPG + item_chunk(r) * CH, C)) = u;
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // the lane's ldmatrix rows: A (U) row 16 mt + lane % 16, chunk 2 s +
  // lane / 16; B (weight) row 32 nh + 16 pr + lane % 8 + 8 (lane / 16),
  // chunk 8 k + 2 s + (lane / 8) % 2
  const int a_row = 16 * mt + (lane & 15), a_half = lane >> 4;
  const int b_row = 8 * NT * nh + (lane & 7) + ((lane >> 4) << 3), b_half = (lane >> 3) & 1;
  auto contract = [&](int k) {
#pragma unroll
    for (int s = 0; s < C / 16; ++s) {
      uint32_t af[4];
      ldsm_x4(af, U + swz(a_row, 16 * s + 8 * a_half, C));
#pragma unroll
      for (int pr = 0; pr < NT / 2; ++pr) {
        uint32_t bq[4];
        ldsm_x4(bq, wb + swz(b_row + 16 * pr, k * C + 16 * s + 8 * b_half, K));
        const uint32_t b0[2] = {bq[0], bq[1]}, b1[2] = {bq[2], bq[3]};
        mma_bf16(acc[2 * pr], af, b0);
        mma_bf16(acc[2 * pr + 1], af, b1);
      }
    }
  };
  // the tile's sums, bias added, to the output planes; the sums reset.
  // Fragment rows gid and gid + 8 are the tile's pixels 16 mt + gid (+ 8).
  const int e0 = 16 * mt + gid, e1 = e0 + 8;
  const int ey0 = e0 / a.tile_w, ex0 = e0 - ey0 * a.tile_w;
  const int ey1 = e1 / a.tile_w, ex1 = e1 - ey1 * a.tile_w;
  auto epilogue = [&](int n, int y0, int x0) {
    T* on = a.out + (long long)n * O * HW;
    const bool v0 = y0 + ey0 < H && x0 + ex0 < W, v1 = y0 + ey1 < H && x0 + ex1 < W;
    const long long p0 = (long long)(y0 + ey0) * W + x0 + ex0;
    const long long p1 = (long long)(y0 + ey1) * W + x0 + ex1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o0 = 8 * NT * nh + 8 * j + 2 * tq;
      if (v0) {
        on[o0 * HW + p0] = store_f<T>(acc[j][0] + bias[j][0]);
        on[(o0 + 1) * HW + p0] = store_f<T>(acc[j][1] + bias[j][1]);
      }
      if (v1) {
        on[o0 * HW + p1] = store_f<T>(acc[j][2] + bias[j][0]);
        on[(o0 + 1) * HW + p1] = store_f<T>(acc[j][3] + bias[j][1]);
      }
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
  };

  const int tiles = a.N * a.tiles_y * a.tiles_x;
  if ((int)blockIdx.x >= tiles) return;
  const int steps = ((tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * kTaps;
  // step s's tile (n, y0, x0) and the next tile's
  int tile = blockIdx.x, n0, y00, x00, n1, y01, x01;
  origin(tile, n0, y00, x00);
  origin(tile + gridDim.x, n1, y01, x01);
  load_taps(n0, y00, x00, 0);
  wait_for_packed_x();
  gather(n0, y00, x00, 0);
  load_taps(n0, y00, x00, 1);
  int k = 0;  // step s's tap
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // every warp is done with U (and the weight is staged)
    put();
    __syncthreads();  // U complete
    const bool same1 = k + 1 < kTaps, same2 = k + 2 < kTaps;
    if (s + 1 < steps)
      gather(same1 ? n0 : n1, same1 ? y00 : y01, same1 ? x00 : x01, same1 ? k + 1 : k + 1 - kTaps);
    if (s + 2 < steps)
      load_taps(same2 ? n0 : n1, same2 ? y00 : y01, same2 ? x00 : x01,
                same2 ? k + 2 : k + 2 - kTaps);
    contract(k);
    if (k == kTaps - 1) {
      epilogue(n0, y00, x00);
      tile += gridDim.x;
      n0 = n1, y00 = y01, x00 = x01;
      origin(tile + gridDim.x, n1, y01, x01);
    }
    k = k + 1 < kTaps ? k + 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// The general route of kernels A, E and D (dcn_bwd.cu): every width the TPU
// kernels take (crfp_tpu/ops/pallas/dcn.py:796-817, :1700-1706): any C with
// C % G == 0, any O, any kh x kw weight, each a runtime value, as are the
// taps' places p_k = (k / kw - (kh - 1) / 2, k % kw - (kw - 1) / 2). The
// tuned routes above keep the widths they were written for; the plans
// (ops/cuda/dcn.py::tile_plan, bwd_plan) send every other width here, and
// pick one of its branches (GenBranch), which the C entries check.
//  - gen_pack, the pre-pass: x packed per group, pixel-major, no border,
//    [N][G][H][W][cpgp], the group's cpg channels padded with zeros to
//    cpgp (gen_cpgp: 2, 4 or a multiple of 8) so that a pixel's channels
//    are whole loads of 4, 8 or 16 bytes (gen_vec_bytes; 3 bf16 channels
//    take 8 bytes, 6 take 16): a corner is one vector load a chunk of CH
//    channels, checked against the frame once.
//  - general/pixel (A, E; O <= kGenPixO, every dcn_3 outside the tuned
//    table): a thread per pixel of a tile of up to 256 pixels walks the
//    groups, taps and channels with the pixel's O sums in registers (the
//    tuned dcn_tiles' shape): three taps at a time, their prologues, then
//    their corners (a vector load a chunk), then their sums; the weight
//    staged once per block as f32 [C K2][8] and read as 16-byte broadcasts,
//    the taps' places from a table (no division by a runtime kernel
//    width). Under shared taps the prologue runs once a (pixel, group),
//    each later tap reads only its mask.
//  - general/mma (A, E; bf16 x, O > 8, no shared mask): a block of 8
//    warps on tiles of kGenPix = 32 pixels on a persistent grid; the
//    weight staged once per block in bf16 as [OP][KS] (columns (group, tap,
//    channel) over the padded channels, K padded to 16 and 8 more so that
//    the fragment loads hit 32 banks), read from the weight in its own
//    order; per tile the modulated samples, lane = pixel and a warp's sample
//    rows (group, tap, chunk) three at a time from a table, rounded to bf16
//    as the TPU kernel rounds its modulated column
//    (crfp_tpu/ops/pallas/dcn.py:169) and stored to U [32][KS] as one
//    vector store; then each warp computes 16 x 8 output tiles with
//    mma.sync m16n8k16 over K and writes them straight from its fragments.
//    Two barriers a tile. The staging's runtime divisions a weight element
//    and a sample's once cost more than the samples (PERF.md).
//  - general/chunked (A, E, D: every width the others do not take: f32 x
//    at O > 8, a shared mask at O > 8, or a weight too large for shared
//    memory): K = C kh kw walked in chunks of at most kGenRows rows
//    (GenChunks): rows ordered (group, tap, channel), a chunk kGenRows /
//    CPG whole (group, tap) pairs, or a run of kGenRows channels of one
//    pair where CPG > kGenRows. A: per chunk the modulated samples go to U
//    [rows][32] in f32, a corner's channels read as the pixel branch reads
//    them (a vector load a chunk; rounded to bf16 first for bf16 x; a
//    shared mask scales after the rounding, as the TPU scales the group's
//    sum, :196-200)
//    and the weight, once a block where it fits beside U in half the
//    shared memory (gen_chunked_whole), else the chunk's rows for up to
//    kGenOuts = 128 outputs once a tile, to Ws [rows][opw]; thread (pixel
//    q, slot s) keeps 4 x 4 sums of outputs 4 (s + 8 j) .. + 3, f32 FMAs on
//    the CUDA cores. 40 KB of shared memory where the weight is staged a
//    chunk at a time, whatever C, O and kh x kw.
// The route's first design was the chunked branch alone, with x packed one
// scalar a channel and every channel's corner checked: 5-13x the tuned
// routes at mid 32 (PERF.md).
// ---------------------------------------------------------------------------

constexpr int kGenPix = 32;      // pixels of a tile (mma and chunked branches, D's pixel at G >= 8)
constexpr int kGenRows = 64;     // chunked: rows of K in a chunk
constexpr int kGenOuts = 128;    // chunked: outputs of one pass of the forward
constexpr int kGenThreads = 256;
constexpr int kGenPixO = 8;      // pixel branch of A and E: O <= 8, the sums in registers
// resident blocks an SM that the general kernels of A, E and D ask for
// (__launch_bounds__): 2, at most 128 registers a thread (with 1, the mma
// and pixel branches at 16-byte corners took 170-210 and read 20-85 %
// slower, one block an SM); 3 (85 registers) for the mma branch at 4-8
// byte corners, whose sampling waits on memory (9-21 % faster than 2 at
// mid 24 and 32; PERF.md)
constexpr int kGenMinBlocks = 2;

// The branches of the general route (ops/cuda/dcn.py::GEN_BRANCHES, in this
// order); the plan names one, the C entries check it.
enum GenBranch { kGenChunked = 0, kGenPixel = 1, kGenMma = 2 };

// __launch_bounds__' blocks an SM of a general kernel of A and E (see
// kGenMinBlocks)
__host__ __device__ constexpr int gen_min_blocks(int branch, int vb) {
  return branch == kGenMma && vb <= 8 ? 3 : kGenMinBlocks;
}

// The padded channel count cpgp of a packed pixel, the same for f32 and
// bf16 x (ops/cuda/dcn.py::gen_cpgp): 2 up to 2 channels, 4 up to 4, then a
// multiple of 8; and the bytes of one vector load of its channels, at most
// 16 (a chunk: f32 8 or 16, bf16 4, 8 or 16).
__host__ __device__ inline int gen_cpgp(int cpg) {
  return cpg <= 2 ? 2 : cpg <= 4 ? 4 : (cpg + 7) / 8 * 8;
}
__host__ __device__ inline int gen_vec_bytes(int cpg, int esize) {
  const int b = gen_cpgp(cpg) * esize;
  return b < 16 ? b : 16;
}

// Output columns of the chunked forward's staged weight: O rounded up to 4,
// at most kGenOuts.
__host__ __device__ inline int gen_opw(int O) {
  const int o4 = (O + 3) / 4 * 4;
  return o4 < kGenOuts ? o4 : kGenOuts;
}

// The chunked forward stages the whole weight once a block, Ws [C K2][opw]
// in the chunks' row order, where O <= kGenOuts and it fits beside U in half
// the card's shared memory (two blocks an SM); else each chunk's rows, Ws
// [kGenRows][opw], once a tile. Its bytes of dynamic shared memory
// (ops/cuda/dcn.py::_gen_smem_bytes): U [kGenRows][kGenPix] and Ws, f32.
constexpr int kGenWholeSmem = kMaxSmem / 2 - 1024;
__host__ __device__ inline bool gen_chunked_whole(int C, int K2, int O) {
  return O <= kGenOuts &&
         4LL * (kGenRows * kGenPix + (long long)C * K2 * gen_opw(O)) <= kGenWholeSmem;
}
__host__ __device__ inline int gen_smem_bytes(int C, int K2, int O) {
  return 4 * (kGenRows * kGenPix +
              (gen_chunked_whole(C, K2, O) ? C * K2 : kGenRows) * gen_opw(O));
}

// The pixel forward: the f32 weight [C K2][kGenPixO] and the taps' places
// int2 [K2].
__host__ __device__ inline long long gen_pixel_smem_bytes(int C, int K2) {
  return 4LL * C * K2 * kGenPixO + 8LL * K2;
}

// The mma forward: bf16 columns a row of U and of the weight, K = G K2 cpgp
// padded to 16, plus 8 (conflict-free fragment loads, as mma_kstride); its
// sample rows (group, tap, chunk), G K2 cpgp / CH of them, CH the channels
// of a chunk; and the bytes: the weight [OP][KS], U [kGenPix][KS] (OP = O
// rounded up to 8), the rows' table int4 [rows].
__host__ __device__ inline int gen_mma_kstride(int G, int K2, int cpgp) {
  return (G * K2 * cpgp + 15) / 16 * 16 + 8;
}
__host__ __device__ inline int gen_mma_rows(int G, int K2, int cpgp) {
  return G * K2 * (cpgp > 8 ? cpgp / 8 : 1);
}
__host__ __device__ inline long long gen_mma_smem_bytes(int G, int K2, int cpgp, int O) {
  return 2LL * ((O + 7) / 8 * 8 + kGenPix) * gen_mma_kstride(G, K2, cpgp) +
         16LL * gen_mma_rows(G, K2, cpgp);
}

// The chunks of K, rows ordered (group, tap, channel): row ((g K2 + k) CPG +
// ci) is channel g CPG + ci at tap k.
struct GenChunks {
  int cpg, pairs;  // channels a group; (group, tap) pairs, G * K2
  int per;         // pairs a chunk (1 where a pair is split)
  int split;       // chunks a pair (1 unless CPG > kGenRows)

  __host__ __device__ GenChunks(int cpg_, int G, int K2) : cpg(cpg_), pairs(G * K2) {
    split = cpg_ > kGenRows ? (cpg_ + kGenRows - 1) / kGenRows : 1;
    per = split > 1 ? 1 : kGenRows / cpg_;
  }
  __host__ __device__ int count() const {
    return split > 1 ? pairs * split : (pairs + per - 1) / per;
  }
  // chunk j: pairs [t0, t0 + nt), channels [c0, c0 + nc) of each
  __device__ __forceinline__ void at(int j, int& t0, int& nt, int& c0, int& nc) const {
    if (split > 1) {
      t0 = j / split, nt = 1, c0 = (j % split) * kGenRows;
      nc = min(kGenRows, cpg - c0);
    } else {
      t0 = j * per, nt = min(per, pairs - t0), c0 = 0, nc = cpg;
    }
  }
};

template <typename T>
struct GenArgs {
  const T* x;            // (N, C, H, W)
  T* xp;                 // scratch: x packed per group, [N][G][H][W][cpgp]
  const float* weight;   // (O, C, KH, KW)
  const float* bias;     // (O,) or NULL
  T* out;                // (N, O, H, W)
  int N, C, H, W, G, O, KH, KW;
  float D;               // clamp; < 0: none
  int tile_h, tile_w;    // pixels of a tile
  int tiles_y, tiles_x;
  int cpgp;              // padded channels a packed pixel (gen_cpgp)
};

// The pre-pass of the general route: x (N, C, H, W) -> xp [N][G][H][W][cpgp]
// (zeros in the padded channels), blocks of 32 x 8 threads over (column,
// row), blockIdx.z image x group, a thread a pixel; dxp, where not NULL
// (kernel D), gets zeros in the same layout.
template <typename T>
__device__ __forceinline__ void gen_pack(const T* __restrict__ x, T* __restrict__ xp,
                                         float* __restrict__ dxp, int H, int W, int cpg) {
  allow_dependent_launch();
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= W || py >= H) return;
  const int cpgp = gen_cpgp(cpg);
  const long long ng = blockIdx.z, HW = (long long)H * W, p = (long long)py * W + px;
  const T* src = x + ng * cpg * HW + p;
  const long long d = (ng * HW + p) * cpgp;
  for (int c = 0; c < cpgp; ++c) {
    xp[d + c] = c < cpg ? src[c * HW] : store_f<T>(0.f);
    if (dxp != nullptr) dxp[d + c] = 0.f;
  }
}

// A sample of D's chunked branch: its four corners' element offsets in a
// packed plane ([H][W][cpgp], 0 for a corner outside the frame), whether each lies
// inside, and bilinear()'s weights.
struct GenCorners {
  long long at[4];
  bool in[4];
  Bilinear b;
};

__device__ __forceinline__ GenCorners gen_corners(float sy, float sx, int H, int W, int cpgp) {
  GenCorners q;
  q.b = bilinear(sy, sx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = q.b.y0 + i / 2, x = q.b.x0 + i % 2;
    q.in[i] = y >= 0 && y < H && x >= 0 && x < W;
    q.at[i] = q.in[i] ? ((long long)y * W + x) * cpgp : 0;
  }
  return q;
}

// One channel's four corners (zeros outside the frame), at src + at[i].
template <typename T>
__device__ __forceinline__ void gen_corner_values(const GenCorners& q, const T* src,
                                                  float (&c)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = q.in[i] ? load_f(src + q.at[i]) : 0.f;
}

// blend()'s arithmetic on one channel
__device__ __forceinline__ float gen_blend(const Bilinear& b, const float (&c)[4]) {
  return fmaf(b.w11, c[3], fmaf(b.w10, c[2], fmaf(b.w01, c[1], b.w00 * c[0])));
}

// A sample's four corners in the packed planes of the pixel and mma
// branches: chunk indices (pixel x chunks a pixel, 0 outside the frame) and
// bilinear()'s weights, 0 for a corner outside the frame (which then reads
// pixel 0 and adds nothing: one frame check a corner, not a channel).
struct GenTap {
  int at[4];
  float w[4];
};

__device__ __forceinline__ GenTap gen_tap(float sy, float sx, int H, int W, int nch) {
  const Bilinear b = bilinear(sy, sx);
  GenTap t{{0, 0, 0, 0}, {b.w00, b.w01, b.w10, b.w11}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = b.y0 + i / 2, x = b.x0 + i % 2;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    t.at[i] = in ? (y * W + x) * nch : 0;
    t.w[i] = in ? t.w[i] : 0.f;
  }
  return t;
}

// channel cc of a chunk's four corners, blended as blend() blends them
template <typename T, int CH>
__device__ __forceinline__ float gen_mix(const GenTap& t, const Pix<T, CH> (&c)[4], int cc) {
  return fmaf(t.w[3], to_f(c[3].v[cc]),
              fmaf(t.w[2], to_f(c[2].v[cc]), fmaf(t.w[1], to_f(c[1].v[cc]),
                                                  t.w[0] * to_f(c[0].v[cc]))));
}

// Sample rows a warp of the mma branch has in flight, and taps a thread of
// the pixel branch: their prologue loads issued together, then their corner
// loads, then the arithmetic (one at a time, each waited for two round
// trips to memory). 3: a 3x3 kernel's 72 rows at 8 groups are 9 a warp, and
// its taps 3 rows of 3.
constexpr int kGenBatch = 3;

// general/pixel (see the note above). Threads: the tile's pixels. The taps
// are walked kGenBatch at a time.
template <typename T, int VB, typename Prologue>
__device__ __forceinline__ void gen_fwd_pixel(const GenArgs<T>& a, const Prologue& pro) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int CH = VB / (int)sizeof(T), B = kGenBatch;  // channels a chunk; taps
  using V = Pix<T, CH>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wf = reinterpret_cast<float*>(smem);  // [C K2][kGenPixO]: row c K2 + k
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int C = a.C, G = a.G, H = a.H, W = a.W, O = a.O, KW = a.KW, K2 = a.KH * a.KW;
  const int cpg = C / G, nch = a.cpgp / CH, ky0 = (a.KH - 1) / 2, kx0 = (KW - 1) / 2;
  const long long HW = (long long)H * W;

  int2* taps = reinterpret_cast<int2*>(wf + C * K2 * kGenPixO);  // [K2]: tap k's place
  // the weight, once per block, zeros past O (rounded to bf16 for bf16 x,
  // as the tensor-core routes round it), and the taps' places
  for (int i = tid; i < C * K2 * kGenPixO; i += nthreads) {
    const int o = i % kGenPixO, r = i / kGenPixO;
    float w = o < O ? __ldg(a.weight + (long long)o * C * K2 + r) : 0.f;
    if constexpr (kBf16) w = __bfloat162float(__float2bfloat16(w));
    wf[i] = w;
  }
  for (int k = tid; k < K2; k += nthreads) taps[k] = make_int2(k / KW - ky0, k % KW - kx0);
  float bias[kGenPixO];
#pragma unroll
  for (int o = 0; o < kGenPixO; ++o)
    bias[o] = a.bias != nullptr && o < O ? __ldg(a.bias + o) : 0.f;
  __syncthreads();

  const V* xp = reinterpret_cast<const V*>(a.xp);
  const int qy = tid / a.tile_w, qx = tid - qy * a.tile_w;
  const int tiles = a.N * a.tiles_y * a.tiles_x;
  wait_for_packed_x();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % a.tiles_x, r0 = tile / a.tiles_x;
    const int n = r0 / a.tiles_y, py = (r0 % a.tiles_y) * a.tile_h + qy;
    const int px = tx * a.tile_w + qx;
    if (py >= H || px >= W) continue;
    const long long p = (long long)py * W + px;
    const float2 ps = pro.pixel(n, p, HW);
    float acc[kGenPixO];
#pragma unroll
    for (int o = 0; o < kGenPixO; ++o) acc[o] = 0.f;
    for (int g = 0; g < G; ++g) {
      const V* src = xp + ((long long)n * G + g) * HW * nch;
      float dy0, dx0, m0, gm;
      pro.tap(ps, n, g, G, 0, K2, p, HW, a.D, dy0, dx0, m0, gm);
      float gacc[kGenPixO];  // the group's sums, scaled by a shared mask last
#pragma unroll
      for (int o = 0; o < kGenPixO; ++o) gacc[o] = 0.f;
      for (int j = 0; j < nch; ++j) {
        for (int k0 = 0; k0 < K2; k0 += B) {
          // the batch's taps: their offsets and masks (under shared taps the
          // first tap's prologue, each later tap its mask alone) ...
          float dy[B], dx[B], m[B];
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const int k = k0 + b;
            dy[b] = dy0, dx[b] = dx0, m[b] = m0;
            if (k > 0 && k < K2) {
              if (!pro.shared_taps) {
                float gm_;
                pro.tap(ps, n, g, G, k, K2, p, HW, a.D, dy[b], dx[b], m[b], gm_);
              } else {
                m[b] = pro.tap_mask(n, g, G, k, K2, p, HW);
              }
            }
          }
          // ... their corners ...
          GenTap t[B];
          V c[B][4];
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const int2 at = taps[k0 + b < K2 ? k0 + b : K2 - 1];
            t[b] = gen_tap((float)(py + at.x) + dy[b], (float)(px + at.y) + dx[b], H, W, nch);
#pragma unroll
            for (int i = 0; i < 4; ++i) c[b][i] = src[t[b].at[i] + j];
          }
          // ... and their sums, in tap order
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const int k = k0 + b;
            if (k >= K2) break;
#pragma unroll
            for (int cc = 0; cc < CH; ++cc) {
              const int ci = j * CH + cc;
              if (ci < cpg) {
                float u = gen_mix<T, CH>(t[b], c[b], cc) * m[b];
                if constexpr (kBf16) u = __bfloat162float(__float2bfloat16(u));
                const float4* w4 =
                    reinterpret_cast<const float4*>(wf + ((g * cpg + ci) * K2 + k) * kGenPixO);
                const float4 w0 = w4[0];
                gacc[0] = fmaf(u, w0.x, gacc[0]);
                gacc[1] = fmaf(u, w0.y, gacc[1]);
                gacc[2] = fmaf(u, w0.z, gacc[2]);
                gacc[3] = fmaf(u, w0.w, gacc[3]);
                if (O > 4) {  // outputs 4-7 (dcn_3 up to mid 32 has O <= 4)
                  const float4 w1 = w4[1];
                  gacc[4] = fmaf(u, w1.x, gacc[4]);
                  gacc[5] = fmaf(u, w1.y, gacc[5]);
                  gacc[6] = fmaf(u, w1.z, gacc[6]);
                  gacc[7] = fmaf(u, w1.w, gacc[7]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kGenPixO; ++o) acc[o] = fmaf(gm, gacc[o], acc[o]);
    }
    T* op = a.out + (long long)n * O * HW + p;
#pragma unroll
    for (int o = 0; o < kGenPixO; ++o)
      if (o < O) op[o * HW] = store_f<T>(acc[o] + bias[o]);
  }
}

// general/mma (see the note above). bf16 x, kGenThreads threads, tiles of
// kGenPix pixels; no shared mask (its scale follows the rounding). A warp
// samples kGenBatch rows at a time.
template <int VB, typename Prologue>
__device__ __forceinline__ void gen_fwd_mma(const GenArgs<__nv_bfloat16>& a,
                                            const Prologue& pro) {
  using T = __nv_bfloat16;
  constexpr int CH = VB / 2, P = kGenPix, MT = P / 16, B = kGenBatch;
  using V = Pix<T, CH>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, G = a.G, H = a.H, W = a.W, O = a.O, KW = a.KW, K2 = a.KH * a.KW;
  const int cpg = C / G, cpgp = a.cpgp, nch = cpgp / CH;
  const int ky0 = (a.KH - 1) / 2, kx0 = (KW - 1) / 2;
  const int KR = G * K2 * cpgp, KS = gen_mma_kstride(G, K2, cpgp), RW = KS / 2;
  const int OP = (O + 7) / 8 * 8, nrows = gen_mma_rows(G, K2, cpgp);
  const long long HW = (long long)H * W;
  T* wb = reinterpret_cast<T*>(smem);  // [OP][KS]: column (g K2 + k) cpgp + ci
  T* U = wb + OP * KS;                 // [P][KS]
  // sample row t = (g K2 + k) nch + j: (g, k, j, the tap's place dy 65536 +
  // dx); its samples are U's columns [t CH, t CH + CH)
  int4* rows = reinterpret_cast<int4*>(U + P * KS);

  // zeros in the weight (the padded channels, columns and outputs) and in
  // U's columns past KR (never written); the rows' table
  {
    uint4* z = reinterpret_cast<uint4*>(wb);
    for (int i = tid; i < OP * KS / 8; i += kGenThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < P * (KS - KR); i += kGenThreads) {
    const int r = i / (KS - KR);
    U[r * KS + KR + (i - r * (KS - KR))] = __float2bfloat16(0.f);
  }
  for (int t = tid; t < nrows; t += kGenThreads) {
    const int pair = t / nch, g = pair / K2, k = pair - g * K2;
    rows[t] = make_int4(g, k, t - pair * nch, (k / KW - ky0) * 65536 + (k % KW - kx0));
  }
  __syncthreads();
  // the weight, once per block, in bf16: a thread per (o, c), its K2 taps
  // read contiguously
  for (int r = tid; r < O * C; r += kGenThreads) {
    const int o = r / C, c = r - o * C, g = c / cpg, ci = c - g * cpg;
    const float* src = a.weight + (long long)r * K2;
    T* dst = wb + o * KS + g * K2 * cpgp + ci;
#pragma unroll 9
    for (int k = 0; k < K2; ++k) dst[k * cpgp] = __float2bfloat16(__ldg(src + k));
  }
  __syncthreads();

  const V* xp = reinterpret_cast<const V*>(a.xp);
  const uint32_t* U32 = reinterpret_cast<const uint32_t*>(U);
  const uint32_t* W32 = reinterpret_cast<const uint32_t*>(wb);
  const int gid = lane >> 2, tq = lane & 3;
  const int units = MT * (OP / 8), ksteps = (KR + 15) / 16;
  const int qy = lane / a.tile_w, qx = lane - qy * a.tile_w;  // the lane's pixel of a tile
  const int tiles = a.N * a.tiles_y * a.tiles_x;
  wait_for_packed_x();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % a.tiles_x, r0 = tile / a.tiles_x;
    const int n = r0 / a.tiles_y, y0 = (r0 % a.tiles_y) * a.tile_h, x0 = tx * a.tile_w;
    const int py = y0 + qy, px = x0 + qx;
    const bool inside = py < H && px < W;
    const long long p = (long long)py * W + px;
    const float2 ps = inside ? pro.pixel(n, p, HW) : make_float2(0.f, 0.f);
    // the modulated samples: lane = pixel, warp w takes the rows w, w + 8,
    // ..., B at a time: their prologues, then their corners, then their
    // rounding and stores
    for (int t0 = warp; t0 < nrows; t0 += B * (kGenThreads / 32)) {
      int4 d[B];
      bool ok[B];
      float dy[B], dx[B], m[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int t = t0 + b * (kGenThreads / 32);
        d[b] = rows[t < nrows ? t : 0];
        ok[b] = t < nrows && inside;
        dy[b] = dx[b] = m[b] = 0.f;
        if (ok[b]) {
          float gm;
          pro.tap(ps, n, d[b].x, G, d[b].y, K2, p, HW, a.D, dy[b], dx[b], m[b], gm);
        }
      }
      GenTap tp[B];
      V c[B][4];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int ox = (short)(d[b].w & 0xffff), oy = (d[b].w - ox) / 65536;
        tp[b] = gen_tap((float)(py + oy) + dy[b], (float)(px + ox) + dx[b], H, W, nch);
        const V* src = xp + ((long long)n * G + d[b].x) * HW * nch + d[b].z;
#pragma unroll
        for (int e = 0; e < 4; ++e) c[b][e] = src[ok[b] ? tp[b].at[e] : 0];
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int t = t0 + b * (kGenThreads / 32);
        if (t >= nrows) break;
        V u;
#pragma unroll
        for (int cc = 0; cc < CH; ++cc)
          u.v[cc] = __float2bfloat16(ok[b] ? gen_mix<T, CH>(tp[b], c[b], cc) * m[b] : 0.f);
        *reinterpret_cast<V*>(U + lane * KS + t * CH) = u;
      }
    }
    __syncthreads();  // U complete
    for (int un = warp; un < units; un += kGenThreads / 32) {
      const int mt = un % MT, nt = un / MT;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < ksteps; ++s) {
        uint32_t af[4], bf[2];
        const int ra = (mt * 16 + gid) * RW + s * 8 + tq;
        af[0] = U32[ra];
        af[1] = U32[ra + 8 * RW];
        af[2] = U32[ra + 4];
        af[3] = U32[ra + 8 * RW + 4];
        const int rb = (nt * 8 + gid) * RW + s * 8 + tq;
        bf[0] = W32[rb];
        bf[1] = W32[rb + 4];
        mma_bf16(acc, af, bf);
      }
      // fragment rows gid and gid + 8 are pixels, columns 2 tq, + 1 outputs
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mt * 16 + gid + 8 * h;
        const int py = y0 + q / a.tile_w, px = x0 + q % a.tile_w;
        if (py >= H || px >= W) continue;
        T* op = a.out + (long long)n * O * HW + (long long)py * W + px;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = nt * 8 + 2 * tq + e;
          if (o < O)
            op[o * HW] =
                store_f<T>(acc[2 * h + e] + (a.bias != nullptr ? __ldg(a.bias + o) : 0.f));
        }
      }
    }
    __syncthreads();  // U read: the next tile may write it
  }
}

// general/chunked (see the note above). kGenThreads threads, tiles of
// kGenPix pixels; corners of VB bytes, as the pixel branch reads them.
template <typename T, int VB, typename Prologue>
__device__ __forceinline__ void gen_fwd_chunked(const GenArgs<T>& a, const Prologue& pro) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int CH = VB / (int)sizeof(T);  // channels a chunk of a corner
  using V = Pix<T, CH>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* U = reinterpret_cast<float*>(smem);  // [kGenRows][kGenPix]
  float* Ws = U + kGenRows * kGenPix;         // [kGenRows][opw]
  const int tid = threadIdx.x;
  const int C = a.C, G = a.G, H = a.H, W = a.W, O = a.O, KW = a.KW, K2 = a.KH * a.KW;
  const int cpg = C / G, nch = a.cpgp / CH, ky0 = (a.KH - 1) / 2, kx0 = (KW - 1) / 2;
  const long long HW = (long long)H * W;
  const int opw = gen_opw(O);
  const V* xp = reinterpret_cast<const V*>(a.xp);
  const GenChunks chunks(cpg, G, K2);
  const int nchunks = chunks.count();
  // the contraction: pixel q of the tile, output slot s (a warp's)
  const int q = tid % kGenPix, slot = tid / kGenPix;
  const int tiles = a.N * a.tiles_y * a.tiles_x;
  // the whole weight, once a block (gen_chunked_whole): row (g K2 + k) cpg
  // + ci; the first chunk's barrier orders these stores before their reads
  const bool whole = gen_chunked_whole(C, K2, O);
  if (whole) {
    for (int i = tid; i < C * K2 * opw; i += kGenThreads) {
      const int r = i / opw, oo = i - r * opw;
      const int pair = r / cpg, ci = r - pair * cpg, g = pair / K2, k = pair - g * K2;
      float w = oo < O ? __ldg(a.weight + ((long long)oo * C + g * cpg + ci) * K2 + k) : 0.f;
      if constexpr (kBf16) w = __bfloat162float(__float2bfloat16(w));
      Ws[i] = w;
    }
  }
  wait_for_packed_x();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % a.tiles_x, r0 = tile / a.tiles_x;
    const int n = r0 / a.tiles_y, y0 = (r0 % a.tiles_y) * a.tile_h, x0 = tx * a.tile_w;
    const int qy = y0 + q / a.tile_w, qx = x0 + q % a.tile_w;
    for (int o0 = 0; o0 < O; o0 += kGenOuts) {
      const int on = min(kGenOuts, O - o0);
      float acc[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
      for (int j = 0; j < nchunks; ++j) {
        int t0, nt, c0, nc;
        chunks.at(j, t0, nt, c0, nc);
        const int rows = nt * nc;
        __syncthreads();  // the last chunk's U and Ws are read
        // the modulated samples: a thread a (pair, pixel)
        for (int i = tid; i < nt * kGenPix; i += kGenThreads) {
          const int tl = i / kGenPix, pq = i - tl * kGenPix;
          const int pair = t0 + tl, g = pair / K2, k = pair - g * K2;
          const int py = y0 + pq / a.tile_w, px = x0 + pq % a.tile_w;
          float* urow = U + tl * nc * kGenPix + pq;
          if (py >= H || px >= W) {
            for (int cc = 0; cc < nc; ++cc) urow[cc * kGenPix] = 0.f;
            continue;
          }
          const long long p = (long long)py * W + px;
          float dy, dx, m, gm;
          pro.tap(pro.pixel(n, p, HW), n, g, G, k, K2, p, HW, a.D, dy, dx, m, gm);
          const GenTap t = gen_tap((float)(py + k / KW - ky0) + dy,
                                   (float)(px + k % KW - kx0) + dx, H, W, nch);
          const V* src = xp + ((long long)n * G + g) * HW * nch;
          // the run's channels [c0, c0 + nc) a chunk of CH at a time (c0 is
          // 0 or a multiple of kGenRows, so of CH)
          for (int j = c0 / CH; j * CH < c0 + nc; ++j) {
            V c[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) c[i] = src[t.at[i] + j];
#pragma unroll
            for (int cc = 0; cc < CH; ++cc) {
              const int r = j * CH + cc - c0;
              if (r < nc) {
                float u = gen_mix<T, CH>(t, c, cc) * m;
                if constexpr (kBf16) u = __bfloat162float(__float2bfloat16(u));
                urow[r * kGenPix] = u * gm;
              }
            }
          }
        }
        // the chunk's weight rows for this pass's outputs (once a block where
        // the whole weight fits)
        for (int i = tid; !whole && i < rows * opw; i += kGenThreads) {
          const int r = i / opw, oo = i - r * opw;
          const int tl = r / nc, pair = t0 + tl, g = pair / K2, k = pair - g * K2;
          const int c = g * cpg + c0 + (r - tl * nc);
          float w = oo < on ? __ldg(a.weight + ((long long)(o0 + oo) * C + c) * K2 + k) : 0.f;
          if constexpr (kBf16) w = __bfloat162float(__float2bfloat16(w));
          Ws[i] = w;
        }
        __syncthreads();  // U and Ws complete
        const float* ws = whole ? Ws + (t0 * cpg + c0) * opw : Ws;
        for (int r = 0; r < rows; ++r) {
          const float u = U[r * kGenPix + q];
          const float* wr = ws + r * opw;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int ob = (slot + 8 * s) * 4;
            if (ob < on) {
              const float4 w = *reinterpret_cast<const float4*>(wr + ob);
              acc[s][0] = fmaf(u, w.x, acc[s][0]);
              acc[s][1] = fmaf(u, w.y, acc[s][1]);
              acc[s][2] = fmaf(u, w.z, acc[s][2]);
              acc[s][3] = fmaf(u, w.w, acc[s][3]);
            }
          }
        }
      }
      if (qy < H && qx < W) {
        T* op = a.out + (long long)n * O * HW + (long long)qy * W + qx;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int o = (slot + 8 * s) * 4 + jj;
            if (o < on) {
              const float b = a.bias != nullptr ? __ldg(a.bias + o0 + o) : 0.f;
              op[(long long)(o0 + o) * HW] = store_f<T>(acc[s][jj] + b);
            }
          }
        }
      }
    }
  }
}

// The general route of A and E: the plan's branch (GenBranch) with corners
// of VB bytes (gen_vec_bytes); a kernel each.
template <int BRANCH, int VB, typename T, typename Prologue>
__device__ __forceinline__ void dcn_tiles_general(const GenArgs<T>& a, const Prologue& pro) {
  if constexpr (BRANCH == kGenPixel) {
    gen_fwd_pixel<T, VB>(a, pro);
  } else if constexpr (BRANCH == kGenMma) {
    static_assert(std::is_same<T, __nv_bfloat16>::value, "the tensor cores take bf16 x");
    gen_fwd_mma<VB>(a, pro);
  } else {
    gen_fwd_chunked<T, VB>(a, pro);
  }
}

// ---- host side --------------------------------------------------------

// The grid of a persistent launch of `fn`: min(tiles, resident blocks per
// SM x SMs). Per instantiation, the first launch raises its dynamic shared
// memory limit to the card's 227 KB (once), and the occupancy of each
// (threads, bytes) is asked once; both hold for every later call.
inline cudaError_t tiled_grid(const void* fn, int threads, int smem, int tiles,
                              int* grid) {
  struct Entry {
    const void* fn;
    int threads, smem, blocks;
  };
  static Entry cache[64];
  static int n_cache = 0;
  static int sms[16] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 16) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  int blocks = -1;
  bool seen = false;
  for (int i = 0; i < n_cache; ++i) {
    if (cache[i].fn != fn) continue;
    seen = true;
    if (cache[i].threads == threads && cache[i].smem == smem) blocks = cache[i].blocks;
  }
  if (blocks < 0) {
    if (!seen) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return e;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, (size_t)smem);
    if (e != cudaSuccess) return e;
    if (blocks < 1) blocks = 1;  // the launch then reports what does not fit
    if (n_cache < 64) cache[n_cache++] = Entry{fn, threads, smem, blocks};
  }
  const long long cap = (long long)blocks * sms[dev];
  *grid = (int)(tiles < cap ? tiles : cap);
  return cudaSuccess;
}

// Launches the pre-pass `pack` on `stream`, then the tiled kernel `fn` on a
// persistent grid as its programmatic dependent (it may start while the
// pre-pass runs and waits in wait_for_packed_x()).
template <typename T, typename Prologue>
inline cudaError_t launch_tiles(void (*pack)(const T*, T*, int, int, int),
                                void (*fn)(TileArgs<T>, Prologue), const TileArgs<T>& a,
                                const Prologue& pro, int threads, int smem, int tiles,
                                cudaStream_t stream) {
  int grid = 0;
  cudaError_t e = tiled_grid(reinterpret_cast<const void*>(fn), threads, smem, tiles, &grid);
  if (e != cudaSuccess) return e;
  const dim3 pack_block(32, 8);
  const dim3 pack_grid((unsigned)((padded(a.W, a.pad) + 31) / 32),
                       (unsigned)((padded(a.H, a.pad) + 7) / 8), (unsigned)(a.N * a.G));
  pack<<<pack_grid, pack_block, 0, stream>>>(a.x, a.xp, a.H, a.W, a.pad);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fn, a, pro);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Checks a tile plan against the shapes and completes the launch
// arguments; cudaErrorInvalidValue for a plan that
// ops/cuda/dcn.py::tile_plan would not make (a border that does not hold
// +-D, a byte count of another layout).
template <typename T>
inline cudaError_t check_plan(TileArgs<T>& a, bool mma, int cpg, int O, int smem,
                              int* threads, int* tiles) {
  const int th = a.tile_h, tw = a.tile_w;
  if (th < 1 || tw < 1 || (th * tw) % 32 || th * tw > kMaxThreads)
    return cudaErrorInvalidValue;
  if (a.G < 1 || a.C != a.G * cpg) return cudaErrorInvalidValue;
  // the tensor-core path: 32-pixel tiles at O = 32, 64-pixel tiles of C =
  // 64 channels at O = 64
  if (mma && !(O == kMmaO && th * tw == 32) &&
      !(O == kWideO && th * tw == kWidePix && a.C == kWideC))
    return cudaErrorInvalidValue;
  if (a.pad < 0 || (a.pad > 0 && (a.D < 0.f || (float)(a.pad - 1) < ceilf(a.D))))
    return cudaErrorInvalidValue;
  *threads = mma ? kMmaWarps * 32 : th * tw;
  if (smem != smem_bytes(mma, a.C, O) || smem > kMaxSmem) return cudaErrorInvalidValue;
  a.tiles_y = (a.H + th - 1) / th;
  a.tiles_x = (a.W + tw - 1) / tw;
  *tiles = a.N * a.tiles_y * a.tiles_x;
  return *tiles > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

// The general route's plan check (ops/cuda/dcn.py::tile_plan with route
// "general"): the branch (GenBranch) a plan names, its tile (the pixel
// branch: a multiple of 32 pixels up to kGenThreads, a thread each; the
// others kGenPix pixels on kGenThreads threads) and shared memory, no
// border (every corner is checked); the mma branch takes bf16 x and no
// shared mask (shared_mask). Completes the packed channels, the tile counts
// and the threads a block.
template <typename T>
inline cudaError_t check_gen_plan(GenArgs<T>& a, int branch, int shared_mask, int pad,
                                  int smem, int* tiles, int* threads) {
  const int px = a.tile_h * a.tile_w;
  if (a.tile_h < 1 || a.tile_w < 1 || pad != 0) return cudaErrorInvalidValue;
  if (a.G < 1 || a.C < 1 || a.C % a.G || a.O < 1 || a.KH < 1 || a.KW < 1)
    return cudaErrorInvalidValue;
  const int K2 = a.KH * a.KW;
  a.cpgp = gen_cpgp(a.C / a.G);
  long long want = -1;
  if (branch == kGenPixel) {
    if (a.O > kGenPixO || px % 32 || px > kGenThreads) return cudaErrorInvalidValue;
    want = gen_pixel_smem_bytes(a.C, K2);
    *threads = px;
  } else if (branch == kGenMma) {
    if (!std::is_same<T, __nv_bfloat16>::value || shared_mask || px != kGenPix)
      return cudaErrorInvalidValue;
    want = gen_mma_smem_bytes(a.G, K2, a.cpgp, a.O);
    *threads = kGenThreads;
  } else if (branch == kGenChunked) {
    if (px != kGenPix) return cudaErrorInvalidValue;
    want = gen_smem_bytes(a.C, K2, a.O);
    *threads = kGenThreads;
  } else {
    return cudaErrorInvalidValue;
  }
  if (smem != want || smem > kMaxSmem) return cudaErrorInvalidValue;
  a.tiles_y = (a.H + a.tile_h - 1) / a.tile_h;
  a.tiles_x = (a.W + a.tile_w - 1) / a.tile_w;
  *tiles = a.N * a.tiles_y * a.tiles_x;
  return *tiles > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches the general route: the pre-pass `pack` over the frame and N * G
// planes, then `fn` (the plan's branch, NULL where none exists) on a
// persistent grid of `threads`-thread blocks as its programmatic dependent.
template <typename T, typename Prologue>
inline cudaError_t launch_general(void (*pack)(const T*, T*, float*, int, int, int),
                                  void (*fn)(GenArgs<T>, Prologue), const GenArgs<T>& a,
                                  const Prologue& pro, int threads, int smem, int tiles,
                                  cudaStream_t stream) {
  if (fn == nullptr) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = tiled_grid(reinterpret_cast<const void*>(fn), threads, smem, tiles, &grid);
  if (e != cudaSuccess) return e;
  pack<<<dim3((unsigned)((a.W + 31) / 32), (unsigned)((a.H + 7) / 8), (unsigned)(a.N * a.G)),
         dim3(32, 8), 0, stream>>>(a.x, a.xp, nullptr, a.H, a.W, a.C / a.G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fn, a, pro);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The kernel of a general plan of A or E: K<BRANCH, VB>::get() for the
// plan's branch and the corners' vector bytes (gen_vec_bytes: 8 or 16 for
// f32 x, 4, 8 or 16 for bf16); NULL for the mma branch on f32 x.
template <typename T, template <int, int> class K>
inline decltype(K<kGenChunked, 16>::get()) gen_kernel(int branch, int cpg) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int vb = gen_vec_bytes(cpg, (int)sizeof(T));
  if (branch == kGenChunked) {
    if constexpr (kBf16) {
      if (vb == 4) return K<kGenChunked, 4>::get();
    }
    return vb == 8 ? K<kGenChunked, 8>::get() : K<kGenChunked, 16>::get();
  }
  if (branch == kGenPixel) {
    if constexpr (kBf16) {
      if (vb == 4) return K<kGenPixel, 4>::get();
    }
    return vb == 8 ? K<kGenPixel, 8>::get() : K<kGenPixel, 16>::get();
  }
  if constexpr (kBf16) {
    if (branch == kGenMma)
      return vb == 4 ? K<kGenMma, 4>::get() : vb == 8 ? K<kGenMma, 8>::get()
                                                     : K<kGenMma, 16>::get();
  }
  return nullptr;
}

// ---------------------------------------------------------------------------
// Few-channel 3x3 convolutions of a tile held in shared memory: kernels G and
// H (hr_conv.cu) and kernel C's conv route (emit.cu), the serving step's
// full-resolution chains of 1-18 channels. A block stages a tile of its
// inputs with the chain's halo (one pixel a convolution) in shared memory as
// f32, then runs each convolution of the chain over the tile as wide as the
// later ones need, into shared memory again; only the chain's last output
// goes to device memory. A stage's thread takes an item of kHcRows
// vertically adjacent output pixels of one column and every output channel:
// neighbouring threads take neighbouring columns (conflict-free loads), a
// loaded input column of kHcRows + 2 values serves all three vertical taps
// of the item's pixels, and the weights, staged once a block as
// [ci][tap][co] f32, are broadcast loads of up to four output channels at
// once. Sums are f32 (fmaf in the order ci, kx, ky), the bias added last.
constexpr int kHcRows = 4;

// rows to allocate for the input buffer of a stage of `oh` output rows: the
// stage reads whole items of kHcRows rows and their 2-row halo
__host__ __device__ constexpr int hc_in_rows(int oh) {
  return (oh + kHcRows - 1) / kHcRows * kHcRows + 2;
}

// weights a tap of a stage of `cout` outputs is padded to: 1, 2 or a multiple of 4
__host__ __device__ constexpr int hc_cpad(int cout) {
  return cout <= 2 ? cout : (cout + 3) / 4 * 4;
}

// f32 words a stage's staged weights and bias take (a multiple of 4, so
// that the next stage's stay 16-byte aligned)
__host__ __device__ constexpr int hc_weight_words(int cin, int cout) {
  return (cin * 9 * hc_cpad(cout) + hc_cpad(cout) + 3) / 4 * 4;
}

// the value stored in the working type T, as f32 (the module path's
// rounding points)
template <typename T> __device__ __forceinline__ float hc_round(float v);
template <> __device__ __forceinline__ float hc_round<float>(float v) { return v; }
template <> __device__ __forceinline__ float hc_round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// F.leaky_relu at the models' slope, on a value of T, stored in T
template <typename T> __device__ __forceinline__ float hc_lrelu(float v) {
  return hc_round<T>(v > 0.f ? v : v * 0.1f);
}

// Stage a convolution's weight (cout, cin, 3, 3) and bias (cout) of type T
// into dst as f32 [cin * 9][cp] + [cp] (cp = hc_cpad of the stage's
// outputs), its output channels at co0 .. co0 + cout - 1 (a stage can
// gather two convolutions of one input: the offset and mask heads). Padded
// channels are never read into a sum.
template <typename T>
__device__ void hc_stage_weights(float* dst, const T* __restrict__ w, const T* __restrict__ b,
                                 int co0, int cout, int cin, int cp) {
  for (int i = threadIdx.x; i < cout * cin * 9; i += blockDim.x) {
    const int co = i / (cin * 9), k = i - co * cin * 9;  // k = ci * 9 + tap
    dst[k * cp + co0 + co] = load_f(w + i);
  }
  for (int i = threadIdx.x; i < cout; i += blockDim.x) dst[cin * 9 * cp + co0 + i] = load_f(b + i);
}

template <int CP>
__device__ __forceinline__ void hc_load_w(float (&wv)[CP], const float* p) {
  if constexpr (CP % 4 == 0) {
#pragma unroll
    for (int j = 0; j < CP / 4; ++j) {
      const float4 q = reinterpret_cast<const float4*>(p)[j];
      wv[4 * j] = q.x;
      wv[4 * j + 1] = q.y;
      wv[4 * j + 2] = q.z;
      wv[4 * j + 3] = q.w;
    }
  } else if constexpr (CP == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    wv[0] = q.x;
    wv[1] = q.y;
  } else {
    wv[0] = p[0];
  }
}

// One 3x3 stage over an output region of oh x ow: output (r, c) reads input
// (r + ky, c + kx), ky, kx in 0..2, of a buffer whose origin is one pixel
// up and left of the output's. Input channels 0 .. CA-1 are planes of `a`
// (plane stride a_plane), CA .. CA+CB-1 planes of `b`; both of row pitch
// `pitch` and at least hc_in_rows(oh) rows (rows past oh + 2 only feed sums
// that are discarded). `w`: hc_stage_weights' layout. For every item, epi(x,
// y0, acc) gets the sums plus bias of output rows y0 .. y0 + kHcRows - 1
// (those < oh are real) of column x.
template <int CA, int CB, int COUT, typename Epi>
__device__ __forceinline__ void hc_conv3x3(const float* a, int a_plane, const float* b,
                                           int b_plane, int pitch, const float* w, int oh,
                                           int ow, Epi epi) {
  constexpr int CP = hc_cpad(COUT);
  const int items = (oh + kHcRows - 1) / kHcRows * ow;
  const float* bias = w + (CA + CB) * 9 * CP;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int g = i / ow, x = i - g * ow, y0 = g * kHcRows;
    float acc[COUT][kHcRows];
#pragma unroll
    for (int co = 0; co < COUT; ++co)
#pragma unroll
      for (int p = 0; p < kHcRows; ++p) acc[co][p] = 0.f;
#pragma unroll 2
    for (int ci = 0; ci < CA + CB; ++ci) {
      const float* src = (ci < CA ? a + ci * a_plane : b + (ci - CA) * b_plane) + y0 * pitch + x;
      const float* wc = w + ci * 9 * CP;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float v[kHcRows + 2];
#pragma unroll
        for (int r = 0; r < kHcRows + 2; ++r) v[r] = src[r * pitch + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          float wv[CP];
          hc_load_w<CP>(wv, wc + (ky * 3 + kx) * CP);
#pragma unroll
          for (int co = 0; co < COUT; ++co)
#pragma unroll
            for (int p = 0; p < kHcRows; ++p) acc[co][p] = fmaf(wv[co], v[p + ky], acc[co][p]);
        }
      }
    }
#pragma unroll
    for (int co = 0; co < COUT; ++co)
#pragma unroll
      for (int p = 0; p < kHcRows; ++p) acc[co][p] += bias[co];
    epi(x, y0, acc);
  }
}

// Fill C planes of R rows x P columns (plane stride `plane`, row pitch P)
// with value(c, r, col). A warp takes kHcFillRows rows at a time and its lanes the
// rows' columns: the reads of a thread are independent and in flight
// together, and whatever value() works out from (c, r) alone is worked out
// once a row (with a flat index, the divisions and the address arithmetic
// of every element were as many instructions as the convolutions').
constexpr int kHcFillRows = 2;

template <int P, typename F>
__device__ __forceinline__ void hc_fill(float* dst, int C, int R, int plane, F value) {
  constexpr int kCols = (P + 31) / 32;
  const int lane = threadIdx.x & 31, step = kHcFillRows * (blockDim.x >> 5), rows = C * R;
  for (int r0 = kHcFillRows * (threadIdx.x >> 5); r0 < rows; r0 += step) {
    float v[kHcFillRows][kCols];
#pragma unroll
    for (int k = 0; k < kHcFillRows; ++k) {
      const int rr = r0 + k, c = rr / R, r = rr - c * R;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = lane + 32 * j;
        v[k][j] = rr < rows && col < P ? value(c, r, col) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kHcFillRows; ++k) {
      const int rr = r0 + k, c = rr / R, r = rr - c * R;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = lane + 32 * j;
        if (rr < rows && col < P) dst[c * plane + r * P + col] = v[k][j];
      }
    }
  }
}

// the depth-to-space (factor 4) read of channel c at pixel (y, x) of a frame
// from one image's conv output un (16 C, hq, wq): F.pixel_shuffle's channel
// c * 16 + (y % 4) * 4 + x % 4 at (y / 4, x / 4); 32-bit offsets within the
// image
template <typename T>
__device__ __forceinline__ float hc_d2s4(const T* __restrict__ un, int c, int y, int x, int hq,
                                         int wq) {
  return load_f(un + ((c * 16 + (y & 3) * 4 + (x & 3)) * hq + (y >> 2)) * wq + (x >> 2));
}

}  // namespace crfp

// cudaGetErrorString for the Python wrapper's message (ctypes has no cudart)
#define CRFP_EXPORT_ERROR_STRING                                   \
  extern "C" const char* crfp_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
