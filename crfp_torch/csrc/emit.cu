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
