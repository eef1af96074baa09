// Kernel C: final-frame emission, depth-to-space + bilinear base, NHWC out.
//
// Replaces crfp_tpu/ops/pallas/emit.py::_emit_kernel (:55, pallas_call in
// depth_to_space_add_chw :172, entry emit_frame_nhwc :185). Computes
//   out[n, Y, X, c] = pixel_shuffle(y, r)[n, c, Y, X]
//                   + bilinear_up(lr)[n, c, Y, X]
// with y (N, C*r*r, H/r, W/r), lr (N, C, h, w) and the align_corners=False
// bilinear weights of crfp_tpu/ops/resize.py::_bilinear_matrix (source
// coordinate (i + 0.5) * in/out - 0.5 clamped to [0, in-1]; rows first,
// then columns). The frame is written NHWC in y's type. The main path
// calls it at r=1 on conv_last's logical output; r=4 takes the s2d frame
// of the TPU layout.
//
// Bound on the H100 at 1080p: y (1,3,1080,1920) bf16 12.4 MB + lr 0.2 MB +
// out 12.4 MB = 25 MB, ~7.5 us at 3.35 TB/s: bytes. The TPU kernel
// interleaves the r^2 phase planes with a 0/1 matrix on its matrix unit;
// at r = 1 there is nothing to interleave, and what the card needs is
// enough bytes in flight.
//
// Two routes, one arithmetic (ops/cuda/emit.py::emit_plan picks one):
//  - emit_kernel (the main path: r = 1, W % 8 == 0, C 1 or 3, y and out
//    16-byte aligned): a block per output row. It works out the row's
//    vertical source (sy, ly, hy, fy) once and stages the LR row
//    interpolated vertically, t[c][x] for x < w, in shared memory. A thread
//    then takes 8 consecutive output columns: one 16-byte load of y per
//    channel (two at f32), the horizontal lerp from shared memory, + y, and
//    its 8 C contiguous NHWC outputs written 16 bytes at a time into the
//    row's output in shared memory, which the block then stores with each
//    warp writing 512 contiguous bytes (a thread storing its own 48 bytes,
//    16 at a time, measured 0.0125 ms against 0.0102 at 1080p bf16, and
//    0.0321 against 0.0214 at f32). 32-bit indices within a row; the row's
//    base is formed once in 64 bits.
//  - emit_kernel_pixels (every other call: r = 4, W % 8 != 0, an offset
//    view): a thread per output pixel, which redoes the vertical step and
//    reads y's phase plane directly.
// Both form the same f32 operations in the same order (vertical lerp, then
// horizontal, then + y), so the two routes give the same bits.
//
// The conv route (emit_kernel_conv; ops/cuda/emit.py::emit_frame_conv)
// replaces no TPU kernel: it takes in the runtime models' frame finish,
// which the JAX package leaves to XLA, so that conv_last's few-channel
// output never goes to device memory. It reads lv3 (N, L, H, W) after the
// fovea blend, applies leaky_relu (stored in T, as the module path stores
// it), writes the ROI of that as the new HR state (N, L, Hr, Wr), and
// emits the frame conv_last(lrelu(lv3)) (L -> C, 3x3, bias; rounded to T)
// plus the bilinear base, with the arithmetic of the other two routes. A
// block is a tile of kConvTH x 64 pixels of one image: lrelu(lv3) with a
// 1-pixel halo staged in shared memory as f32, the 3x3 stage of
// common.cuh's hc_conv3x3 (f32 sums). Bound at 4 x 1080 x 1920, L = 4,
// bf16: lv3 66 MB in, the state 66 MB and the frame 50 MB out, ~55 us at
// 3.35 TB/s; 108 FMA a pixel (0.03 ms at the f32 peak). Measured (H100 80GB
// HBM3, 700 W; CUDA-graph replays): 0.27 ms bf16, 0.32 f32, against 1.72 for
// leaky_relu, cuDNN's conv_last and the row route (512 threads a block:
// 0.31).
#include "common.cuh"

namespace {

constexpr int kPixelThreads = 256;
constexpr int kVec = 8;  // output columns per thread of the row route
constexpr int kMaxRowThreads = 512;  // a row of up to 4096 columns

// The two routes' shared arithmetic, with every fused multiply-add written
// out: left to the compiler, the same expression contracted one way in one
// kernel and the other way in another (measured: the row route's f32
// one-channel frame differed from the pixel route's in the last bit). The
// forms written are the ones the compiler chose for the pixel route, whose
// bits are those of the kernel before the row route existed.

// the bilinear source coordinate of output index i: (i + 0.5) * in / out -
// 0.5 clamped to [0, in - 1]; its low index, high index and weight
struct Src {
  int lo, hi;
  float f;
};

__device__ __forceinline__ Src source(int i, int in, int out) {
  const float s = fminf(fmaxf(fmaf(i + 0.5f, (float)in / (float)out, -0.5f), 0.f),
                        (float)(in - 1));
  const int lo = min((int)floorf(s), in - 1);
  return {lo, min(lo + 1, in - 1), s - (float)lo};
}

// (1 - f) a + f b
__device__ __forceinline__ float lerp(float f, float a, float b) {
  return fmaf(1.f - f, a, f * b);
}

// f32 words of the staged LR row, padded to 16 bytes; the row's output
// follows it in shared memory
__host__ __device__ inline int row_words(int C, int w) { return (C * w + 3) / 4 * 4; }

template <typename T, int C>
__global__ void __launch_bounds__(kMaxRowThreads)
emit_kernel(const T* __restrict__ y, const T* __restrict__ lr,
            T* __restrict__ out, int H, int W, int h, int w) {
  extern __shared__ float t[];  // [C][w]: the LR row, interpolated vertically
  constexpr int kWords = kVec * (int)sizeof(T) / 16;  // 16-byte words of 8 values
  union Vec {
    uint4 q[kWords];
    T v[kVec];
  };
  union Pix {
    uint4 q[kWords * C];
    T v[kVec * C];
  };
  const int Y = blockIdx.x, n = blockIdx.y;
  const int X0 = threadIdx.x * kVec;
  const bool active = X0 < W;

  // y first: its loads need nothing from shared memory
  Vec yin[C];
  if (active) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint4* yp = reinterpret_cast<const uint4*>(
          y + (((long long)n * C + c) * H + Y) * W + X0);
#pragma unroll
      for (int k = 0; k < kWords; ++k) yin[c].q[k] = __ldg(yp + k);
    }
  }

  const Src sy = source(Y, h, H);
  for (int i = threadIdx.x; i < C * w; i += blockDim.x) {
    const int c = i / w, x = i - c * w;
    const T* lc = lr + ((long long)n * C + c) * h * w;
    t[i] = lerp(sy.f, crfp::load_f(lc + sy.lo * w + x), crfp::load_f(lc + sy.hi * w + x));
  }
  __syncthreads();

  Pix o;
  if (active) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const Src sx = source(X0 + k, w, W);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float base = lerp(sx.f, t[c * w + sx.lo], t[c * w + sx.hi]);
        o.v[k * C + c] = crfp::store_f<T>(crfp::to_f(yin[c].v[k]) + base);
      }
    }
  }
  // through shared memory, so that a warp stores 512 contiguous bytes
  uint4* so = reinterpret_cast<uint4*>(t + row_words(C, w));
  if (active) {
#pragma unroll
    for (int k = 0; k < kWords * C; ++k) so[threadIdx.x * kWords * C + k] = o.q[k];
  }
  __syncthreads();
  uint4* orow = reinterpret_cast<uint4*>(out + ((long long)n * H + Y) * W * C);
  const int words = W / kVec * kWords * C;
  for (int i = threadIdx.x; i < words; i += blockDim.x) orow[i] = so[i];
}

template <typename T>
__global__ void __launch_bounds__(kPixelThreads)
emit_kernel_pixels(const T* __restrict__ y, const T* __restrict__ lr,
                   T* __restrict__ out, int C, int H, int W, int r, int h, int w) {
  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int n = blockIdx.y;
  const int Y = (int)(p / W);
  const int X = (int)(p % W);
  const Src sy = source(Y, h, H), sx = source(X, w, W);

  const int r2 = r * r;
  const int Hs = H / r, Ws = W / r;
  const long long sp = (long long)(Y / r) * Ws + X / r;
  const int ph = (Y % r) * r + X % r;
  for (int c = 0; c < C; ++c) {
    const T* lc = lr + ((long long)n * C + c) * h * w;
    const float t0 = lerp(sy.f, crfp::load_f(lc + (long long)sy.lo * w + sx.lo),
                          crfp::load_f(lc + (long long)sy.hi * w + sx.lo));
    const float t1 = lerp(sy.f, crfp::load_f(lc + (long long)sy.lo * w + sx.hi),
                          crfp::load_f(lc + (long long)sy.hi * w + sx.hi));
    const float base = lerp(sx.f, t0, t1);
    const float yv = crfp::load_f(
        y + (((long long)n * C * r2 + (long long)c * r2 + ph) * Hs) * Ws + sp);
    out[((long long)n * HW + p) * C + c] = crfp::store_f<T>(yv + base);
  }
}

constexpr int kConvThreads = 256;
constexpr int kConvTH = 32, kConvTW = 64;

// f32 words of the conv route's shared memory: conv_last's weights, then
// lrelu(lv3) over the tile and its halo
__host__ __device__ inline int conv_words(int L, int C) {
  return crfp::hc_weight_words(L, C) + L * crfp::hc_in_rows(kConvTH) * (kConvTW + 2);
}

template <typename T, int L, int C>
__global__ void __launch_bounds__(kConvThreads)
emit_kernel_conv(const T* __restrict__ lv3, const T* __restrict__ wl, const T* __restrict__ bl,
                 const T* __restrict__ lr, T* __restrict__ out, T* __restrict__ state, int H,
                 int W, int h, int w, int Hr, int Wr) {
  extern __shared__ __align__(16) float cs[];
  const int n = blockIdx.z, ty0 = blockIdx.y * kConvTH, tx0 = blockIdx.x * kConvTW;
  crfp::hc_stage_weights(cs, wl, bl, 0, C, L, crfp::hc_cpad(C));
  float* Z = cs + crfp::hc_weight_words(L, C);
  constexpr int pw = kConvTW + 2, pz = crfp::hc_in_rows(kConvTH) * pw, r0 = kConvTH + 2;
  const long long plane = (long long)H * W, rplane = (long long)Hr * Wr;
  const T* ln = lv3 + (long long)n * L * plane;
  // lrelu(lv3) over the tile and a 1-pixel halo, zero outside the frame
  crfp::hc_fill<pw>(Z, L, r0, pz, [&](int c, int r, int col) {
    const int y = ty0 - 1 + r, x = tx0 - 1 + col;
    return y >= 0 && y < H && x >= 0 && x < W
               ? crfp::hc_lrelu<T>(crfp::load_f(ln + c * (int)plane + y * W + x))
               : 0.f;
  });
  __syncthreads();
  // the tile's pixels in the ROI are the new state
  const int sh = min(kConvTH, Hr - ty0), sw = min(kConvTW, Wr - tx0);
  for (int i = threadIdx.x; i < L * kConvTH * kConvTW; i += blockDim.x) {
    const int c = i / (kConvTH * kConvTW), rc = i - c * (kConvTH * kConvTW);
    const int r = rc / kConvTW, col = rc - r * kConvTW;
    if (r < sh && col < sw)
      state[((long long)n * L + c) * rplane + (long long)(ty0 + r) * Wr + tx0 + col] =
          crfp::store_f<T>(Z[c * pz + (r + 1) * pw + col + 1]);
  }
  crfp::hc_conv3x3<L, 0, C>(
      Z, pz, Z, 0, pw, cs, kConvTH, kConvTW,
      [&](int x, int y0, const auto& acc) {
        const int X = tx0 + x;
        if (X >= W) return;
        const Src sx = source(X, w, W);
#pragma unroll
        for (int q = 0; q < crfp::kHcRows; ++q) {
          const int Y = ty0 + y0 + q;
          if (Y >= H) break;
          const Src sy = source(Y, h, H);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const T* lc = lr + ((long long)n * C + c) * h * w;
            const float t0 = lerp(sy.f, crfp::load_f(lc + (long long)sy.lo * w + sx.lo),
                                  crfp::load_f(lc + (long long)sy.hi * w + sx.lo));
            const float t1 = lerp(sy.f, crfp::load_f(lc + (long long)sy.lo * w + sx.hi),
                                  crfp::load_f(lc + (long long)sy.hi * w + sx.hi));
            const float base = lerp(sx.f, t0, t1);
            out[((long long)n * plane + (long long)Y * W + X) * C + c] =
                crfp::store_f<T>(crfp::hc_round<T>(acc[c][q]) + base);
          }
        }
      });
}

template <typename T, int L>
cudaError_t launch_conv_l(const void* lv3, const void* wl, const void* bl, const void* lr,
                          void* out, void* state, int N, int C, int H, int W, int h, int w,
                          int Hr, int Wr, cudaStream_t s) {
  if (C != 1 && C != 3) return cudaErrorInvalidValue;
  const int smem = conv_words(L, C) * (int)sizeof(float);
  auto kernel = C == 3 ? emit_kernel_conv<T, L, 3> : emit_kernel_conv<T, L, 1>;
  // L = 8 stages 73 KB, past the 48 KB a launch gets without asking
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((W + kConvTW - 1) / kConvTW), (unsigned)((H + kConvTH - 1) / kConvTH),
            (unsigned)N);
  kernel<<<grid, kConvThreads, smem, s>>>(
      static_cast<const T*>(lv3), static_cast<const T*>(wl), static_cast<const T*>(bl),
      static_cast<const T*>(lr), static_cast<T*>(out), static_cast<T*>(state), H, W, h, w, Hr,
      Wr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv(const void* lv3, const void* wl, const void* bl, const void* lr,
                        void* out, void* state, int N, int L, int C, int H, int W, int h, int w,
                        int Hr, int Wr, cudaStream_t s) {
  switch (L) {
    case 2: return launch_conv_l<T, 2>(lv3, wl, bl, lr, out, state, N, C, H, W, h, w, Hr, Wr, s);
    case 3: return launch_conv_l<T, 3>(lv3, wl, bl, lr, out, state, N, C, H, W, h, w, Hr, Wr, s);
    case 4: return launch_conv_l<T, 4>(lv3, wl, bl, lr, out, state, N, C, H, W, h, w, Hr, Wr, s);
    case 8: return launch_conv_l<T, 8>(lv3, wl, bl, lr, out, state, N, C, H, W, h, w, Hr, Wr, s);
    default: return cudaErrorInvalidValue;
  }
}

// threads of a row block: one per 8 columns, in whole warps
int row_threads(int W) { return (W / kVec + 31) / 32 * 32; }

template <typename T>
cudaError_t launch(const void* y, const void* lr, void* out, int N, int C,
                   int H, int W, int r, int h, int w, int vec, int threads,
                   cudaStream_t s) {
  const T* yp = static_cast<const T*>(y);
  const T* lp = static_cast<const T*>(lr);
  T* op = static_cast<T*>(out);
  if (vec) {
    // the plan of ops/cuda/emit.py::emit_plan; refuse any other
    const size_t smem = (size_t)row_words(C, w) * sizeof(float) + (size_t)W * C * sizeof(T);
    if (r != 1 || W % kVec != 0 || (C != 1 && C != 3) || threads != row_threads(W) ||
        threads > kMaxRowThreads || smem > 48 * 1024 ||
        reinterpret_cast<uintptr_t>(y) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return cudaErrorInvalidValue;
    dim3 grid((unsigned)H, (unsigned)N);
    if (C == 3)
      emit_kernel<T, 3><<<grid, threads, smem, s>>>(yp, lp, op, H, W, h, w);
    else
      emit_kernel<T, 1><<<grid, threads, smem, s>>>(yp, lp, op, H, W, h, w);
    return cudaGetLastError();
  }
  if (threads != kPixelThreads) return cudaErrorInvalidValue;
  const long long HW = (long long)H * W;
  dim3 grid((unsigned)((HW + kPixelThreads - 1) / kPixelThreads), (unsigned)N);
  emit_kernel_pixels<T><<<grid, kPixelThreads, 0, s>>>(yp, lp, op, C, H, W, r, h, w);
  return cudaGetLastError();
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// y: (N, C*r*r, H/r, W/r); lr: (N, C, h, w); out: (N, H, W, C); all of
// one type, f32 or bf16 (is_bf16), contiguous. (vec, threads): the plan of
// ops/cuda/emit.py::emit_plan (the row route and its block, or the pixel
// route at 256 threads); a plan the call does not admit is refused.
extern "C" int crfp_emit(const void* y, const void* lr, void* out, int N,
                         int C, int H, int W, int r, int h, int w, int is_bf16,
                         int vec, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(y, lr, out, N, C, H, W, r, h, w, vec, threads, s)
              : launch<float>(y, lr, out, N, C, H, W, r, h, w, vec, threads, s);
  return (int)e;
}

// The conv route: lv3 (N, L, H, W) after the fovea blend, conv_last's
// weight (C, L, 3, 3) and bias (C), lr (N, C, h, w), out (N, H, W, C) and
// state (N, L, Hr, Wr), all of one type (is_bf16), contiguous. L in 2, 3, 4,
// 8; C 1 or 3; Hr <= H, Wr <= W.
extern "C" int crfp_emit_conv(const void* lv3, const void* wl, const void* bl, const void* lr,
                              void* out, void* state, int N, int L, int C, int H, int W, int h,
                              int w, int Hr, int Wr, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hr > H || Wr > W) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      is_bf16 ? launch_conv<__nv_bfloat16>(lv3, wl, bl, lr, out, state, N, L, C, H, W, h, w, Hr,
                                           Wr, s)
              : launch_conv<float>(lv3, wl, bl, lr, out, state, N, L, C, H, W, h, w, Hr, Wr, s);
  return (int)e;
}
