// Shared helpers of the crfp_torch kernels: float <-> storage type
// conversion, the window clamp and its derivative, the error-string export
// every kernel library carries, and the one tiled device routine of kernels
// A (dcn_fwd.cu) and E (dcn_fused.cu): x packed per group, pixel-major, by
// a pre-pass; tiles of pixels per block on a persistent grid; the weight
// staged once per block; the bf16 contraction on the tensor cores
// (mma.sync). The two kernels differ only in their prologue.
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
//      - dcn_tiles_wide (O = 64, per-tap, f32 and bf16 x): the same on the
//        CUDA cores with the group's channels walked in 16-byte chunks.
// The corners come from the packed planes through L1. Staging each group's
// window of x in shared memory (cp.async, double-buffered) was built and
// measured slower at every shape of the main paths (PERF.md).
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
// (at most 85 registers a thread) on the tensor-core path and at O < 32; 1
// on the f32 path at O = 32, whose 64 sums a pixel would spill with fewer.
__host__ __device__ constexpr int min_blocks(bool mma, int o) { return mma || o < 32 ? 3 : 1; }

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

// Bytes of dynamic shared memory; ops/cuda/dcn.py::tile_plan computes the
// same, and the C entries refuse a plan that differs. Tensor-core path: the
// bf16 weight [32][ks], U [32][ks] and the f32 output tile [32][kOutStride],
// in this order; CUDA-core path: the f32 weight.
__host__ __device__ inline int smem_bytes(bool mma, int C, int O) {
  return mma ? 2 * 32 * mma_kstride(C) * 2 + 32 * kOutStride * 4 : C * kTaps * O * 4;
}

// What a tap needs from the prologue, for one pixel and group.
struct Taps {
  float dy[kTaps], dx[kTaps], m[kTaps];
  float gm;  // the shared mask (1 otherwise)
};

// Kernel A's prologue: f32 offsets (N, G*T*2, H, W), channel (g*T + k)*2 +
// {dy, dx}, T = 1 under shared_taps; f32 masks (N, G*M, H, W), M = 1 under
// shared_mask. Every component is clamped to +-D.
struct ProA {
  const float* off;
  const float* mask;
  int shared_taps, shared_mask;

  __device__ __forceinline__ void operator()(int n, int g, int G, long long p,
                                             long long HW, float D, Taps& t) const {
    const long long ng = (long long)n * G + g;
    if (shared_taps) {
      const float* o = off + ng * 2 * HW + p;
      const float dy = clamp_window(__ldg(o), D), dx = clamp_window(__ldg(o + HW), D);
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
};

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
// blockIdx.z: image x group.
template <typename T, int CPG>
__device__ __forceinline__ void pack_x(const T* __restrict__ x, T* __restrict__ xp, int H,
                                       int W, int pad) {
  constexpr int CH = chunk_of<T, CPG>();
  allow_dependent_launch();
  const int Hp = padded(H, pad), Wp = padded(W, pad);
  const int xq = blockIdx.x * blockDim.x + threadIdx.x;
  const int yq = blockIdx.y * blockDim.y + threadIdx.y;
  if (xq >= Wp || yq >= Hp) return;
  const long long ng = blockIdx.z, HW = (long long)H * W;
  const int y = yq - pad, xx = xq - pad;
  const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
  const T* src = x + ng * CPG * HW + (long long)(inside ? y : 0) * W + (inside ? xx : 0);
  Pix<T, CH>* dst = reinterpret_cast<Pix<T, CH>*>(xp) + ((ng * Hp + yq) * Wp + xq) * (CPG / CH);
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
// C = 64): one block of 256 threads an SM.
constexpr int kWideO = 64;

template <int CPG, int SRC, typename T>
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
      wait_for_packed_x();
      const Pix<T, CH>* src = xp + ng * HWp * NCH;
#pragma unroll(NCH == 1 ? kTaps : 1)
      for (int k = 0; k < kTaps; ++k) {
        const float dy = clamp_window(__ldg(off + (2 * k) * HW), a.D);
        const float dx = clamp_window(__ldg(off + (2 * k + 1) * HW), a.D);
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
  if (mma && (O != kMmaO || th * tw != 32)) return cudaErrorInvalidValue;
  if (a.pad < 0 || (a.pad > 0 && (a.D < 0.f || (float)(a.pad - 1) < ceilf(a.D))))
    return cudaErrorInvalidValue;
  *threads = mma ? kMmaWarps * 32 : th * tw;
  if (smem != smem_bytes(mma, a.C, O) || smem > kMaxSmem) return cudaErrorInvalidValue;
  a.tiles_y = (a.H + th - 1) / th;
  a.tiles_x = (a.W + tw - 1) / tw;
  *tiles = a.N * a.tiles_y * a.tiles_x;
  return *tiles > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace crfp

// cudaGetErrorString for the Python wrapper's message (ctypes has no cudart)
#define CRFP_EXPORT_ERROR_STRING                                   \
  extern "C" const char* crfp_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
