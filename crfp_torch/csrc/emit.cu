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
// Design: one thread per output pixel; it writes the C channels of its
// pixel contiguously. Bound on the H100 at 1080p: y (1,3,1080,1920) bf16
// 12.4 MB + lr 0.2 MB + out 12.4 MB = 25 MB, ~7.5 us at 3.35 TB/s: bytes.
// y is read and the frame written once; the 2x2 LR neighbourhood of a
// pixel is shared by ~64 output pixels and stays in L1/L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const T* __restrict__ y, const T* __restrict__ lr,
            T* __restrict__ out, int C, int H, int W, int r, int h, int w) {
  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int n = blockIdx.y;
  const int Y = (int)(p / W);
  const int X = (int)(p % W);

  const float sy = fminf(fmaxf((Y + 0.5f) * ((float)h / (float)H) - 0.5f, 0.f),
                         (float)(h - 1));
  const float sx = fminf(fmaxf((X + 0.5f) * ((float)w / (float)W) - 0.5f, 0.f),
                         (float)(w - 1));
  const int ly = min((int)floorf(sy), h - 1), hy = min(ly + 1, h - 1);
  const int lx = min((int)floorf(sx), w - 1), hx = min(lx + 1, w - 1);
  const float fy = sy - (float)ly;
  const float fx = sx - (float)lx;

  const int r2 = r * r;
  const int Hs = H / r, Ws = W / r;
  const long long sp = (long long)(Y / r) * Ws + X / r;
  const int ph = (Y % r) * r + X % r;
  for (int c = 0; c < C; ++c) {
    const T* lc = lr + ((long long)n * C + c) * h * w;
    const float t0 = (1.f - fy) * crfp::load_f(lc + (long long)ly * w + lx) +
                     fy * crfp::load_f(lc + (long long)hy * w + lx);
    const float t1 = (1.f - fy) * crfp::load_f(lc + (long long)ly * w + hx) +
                     fy * crfp::load_f(lc + (long long)hy * w + hx);
    const float base = (1.f - fx) * t0 + fx * t1;
    const float yv = crfp::load_f(
        y + (((long long)n * C * r2 + (long long)c * r2 + ph) * Hs) * Ws + sp);
    out[((long long)n * HW + p) * C + c] = crfp::store_f<T>(yv + base);
  }
}

template <typename T>
cudaError_t launch(const void* y, const void* lr, void* out, int N, int C,
                   int H, int W, int r, int h, int w, cudaStream_t s) {
  const long long HW = (long long)H * W;
  dim3 grid((unsigned)((HW + kThreads - 1) / kThreads), (unsigned)N);
  emit_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(y),
                                           static_cast<const T*>(lr),
                                           static_cast<T*>(out), C, H, W, r,
                                           h, w);
  return cudaGetLastError();
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// y: (N, C*r*r, H/r, W/r); lr: (N, C, h, w); out: (N, H, W, C); all of
// one type, f32 or bf16 (is_bf16), contiguous.
extern "C" int crfp_emit(const void* y, const void* lr, void* out, int N,
                         int C, int H, int W, int r, int h, int w, int is_bf16,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16
                      ? launch<__nv_bfloat16>(y, lr, out, N, C, H, W, r, h, w, s)
                      : launch<float>(y, lr, out, N, C, H, W, r, h, w, s);
  return (int)e;
}
