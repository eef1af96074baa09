// Kernel E: the per-tap windowed DCNv2 forward straight from the offset and
// mask heads' raw conv outputs ("fused prep"), NCHW, inference only.
//
// Replaces crfp_tpu/ops/pallas/dcn.py::_dcn_kernel_fusedprep (:1468,
// pallas_call :1659, entry deform_conv2d_pallas_fusedprep :1667) together
// with the epilogue the JAX package leaves to XLA around it
// (crfp_tpu/nn/align.py:281, :292-296): from raw_off channel
// (g*K2 + k)*2 + {0: dy, 1: dx}, raw_mask channel g*K2 + k and the f32 flow
// (dx, dy),
//
//   dy = clip(mag * tanh(raw_off[.., 0]) + flow[1], -D, +D)
//   dx = clip(mag * tanh(raw_off[.., 1]) + flow[0], -D, +D)
//   m  = sigmoid(raw_mask)
//   out[o, p] = bias[o] + sum_{g, k, c in g} W[o, c, k] * m *
//               bilinear(x[c], p + p_k + (dy, dx))        (zeros outside)
//
// in one launch, written in x's type. The plain version is
// crfp_torch/ops/dcn_windowed.py::deform_conv2d_fusedprep_ref. The TPU
// kernel builds its query geometry block by block in fast memory because
// its matrix unit does the gathers; none of that carries over: Hopper
// gathers natively.
//
// Precision: heads are upcast to f32 before tanhf/expf (the unfused path's
// .float()), the product and the sum of mag * tanh + flow are rounded
// separately (__fmul_rn, __fadd_rn: no fused multiply-add) as two PyTorch
// launches round them, and the clamp is applied once, after the flow is
// added, by the same clamp_window as kernel A. The build has no
// --use_fast_math.
//
// Design: kernel A's tiled routine (common.cuh: x packed per group and
// zero-padded by a pre-pass, tiles of pixels on a persistent grid, the
// weight staged once per block, the bf16 contraction on the tensor cores
// with a warp per group, f32 on the CUDA cores) with the prologue
// crfp::ProE, which computes each (pixel, group, tap)'s offsets and mask in
// registers instead of reading f32 tensors that ~14 elementwise launches
// would have written first. The same offsets therefore give the same bits
// as "PyTorch prologue, then kernel A" in f32 and in bf16. Every width
// beside dcn_0/1/2's at mid 16 and 32 (any C % G == 0, O, kh x kw) takes
// the general route, crfp_dcn_fused_general: kernel A's general routine
// (common.cuh::dcn_tiles_general) with the same prologue, tap by tap.
//
// Bound on the H100 (bf16 x and heads): at the gate shape (1, 32, 180, 320)
// x 3.7 MB + offset head (1, 144, ...) 16.6 MB + mask head (1, 72, ...)
// 8.3 MB + flow 0.5 MB + out 3.7 MB = 32.8 MB, ~9.8 us at 3.35 TB/s, against
// 1.1 GFLOP of contraction and sampling, ~1.1 us at the bf16 tensor rate:
// bytes bound it. At the serving shape (1, 32, 180, 180) 18.4 MB, ~5.5 us.
// Against kernel A after the PyTorch prologue the function reads the heads
// in their own type (half the bytes in bf16) and never writes or re-reads
// the f32 offsets and masks.
#include "common.cuh"

namespace {

template <typename T, int O, int CPG, bool MMA, int SRC>
__global__ void __launch_bounds__(crfp::kMaxThreads, crfp::min_blocks(MMA, O))
dcn_fused_kernel(crfp::TileArgs<T> a, crfp::ProE<T> pro) {
  if constexpr (MMA)
    crfp::dcn_tiles_mma<CPG, SRC>(a, pro);
  else
    crfp::dcn_tiles<O, CPG, SRC, false>(a, pro);
}

// the pre-pass: x packed per group, pixel-major (crfp::pack_x)
template <typename T, int CPG>
__global__ void __launch_bounds__(256)
dcn_fused_kernel_pack_x(const T* __restrict__ x, T* __restrict__ xp, int H, int W, int pad) {
  crfp::pack_x<T, CPG>(x, xp, H, W, pad);
}

// the general route (common.cuh::dcn_tiles_general: a kernel per branch and
// corner width) and its pre-pass
template <typename T, int BRANCH, int VB>
__global__ void __launch_bounds__(crfp::kGenThreads, crfp::gen_min_blocks(BRANCH, VB))
dcn_fused_general(crfp::GenArgs<T> a, crfp::ProE<T> pro) {
  crfp::dcn_tiles_general<BRANCH, VB>(a, pro);
}
template <typename T>
struct FusedGeneral {
  template <int BRANCH, int VB>
  struct K {
    static void (*get())(crfp::GenArgs<T>, crfp::ProE<T>) {
      return dcn_fused_general<T, BRANCH, VB>;
    }
  };
};

template <typename T>
__global__ void __launch_bounds__(256)
dcn_fused_general_pack(const T* __restrict__ x, T* __restrict__ xp, float* __restrict__ dxp,
                       int H, int W, int cpg) {
  crfp::gen_pack(x, xp, dxp, H, W, cpg);
}

// bf16 x at O = 32 on the tensor cores; f32 x and O = 16 on the CUDA cores
template <typename T, int O, int CPG>
cudaError_t launch(crfp::TileArgs<T> a, const crfp::ProE<T>& pro, int smem,
                   cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value && O == crfp::kMmaO;
  int threads = 0, tiles = 0;
  cudaError_t e = crfp::check_plan(a, kMma, CPG, O, smem, &threads, &tiles);
  if (e != cudaSuccess) return e;
  void (*fn)(crfp::TileArgs<T>, crfp::ProE<T>) =
      a.pad > 0 ? dcn_fused_kernel<T, O, CPG, kMma, crfp::kPadded>
                : dcn_fused_kernel<T, O, CPG, kMma, crfp::kChecked>;
  return crfp::launch_tiles(dcn_fused_kernel_pack_x<T, CPG>, fn, a, pro, threads, smem, tiles,
                            stream);
}

template <typename T>
cudaError_t dispatch(int O, int cpg, const crfp::TileArgs<T>& a, const crfp::ProE<T>& pro,
                     int smem, cudaStream_t s) {
  if (O == 16 && cpg == 2) return launch<T, 16, 2>(a, pro, smem, s);  // mid 16
  if (O == 16 && cpg == 4) return launch<T, 16, 4>(a, pro, smem, s);
  if (O == 32 && cpg == 2) return launch<T, 32, 2>(a, pro, smem, s);
  if (O == 32 && cpg == 4) return launch<T, 32, 4>(a, pro, smem, s);  // mid 32
  return cudaErrorInvalidValue;
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

namespace {

// The general route: the plan's branch checked (crfp::check_gen_plan), the
// pre-pass and the branch's kernel.
template <typename T>
int general_route(const void* x, void* x_packed, const float* wt, const float* b, void* out,
                  int N, int C, int H, int W, int G, int O, int KH, int KW, float D, int tile_h,
                  int tile_w, int pad, int smem_bytes, int branch, const crfp::ProE<T>& pro,
                  cudaStream_t s) {
  crfp::GenArgs<T> a{static_cast<const T*>(x), static_cast<T*>(x_packed), wt, b,
                     static_cast<T*>(out), N, C, H, W, G, O, KH, KW, D, tile_h, tile_w,
                     0, 0, 0};
  int tiles = 0, threads = 0;
  cudaError_t e = crfp::check_gen_plan(a, branch, 0, pad, smem_bytes, &tiles, &threads);
  if (e != cudaSuccess) return (int)e;
  return (int)crfp::launch_general(
      dcn_fused_general_pack<T>,
      crfp::gen_kernel<T, FusedGeneral<T>::template K>(branch, C / G), a, pro, threads,
      smem_bytes, tiles, s);
}

// Both entries: the tuned route (dispatch) or the general one.
int run(bool general, const void* x, const void* raw_off, const void* raw_mask,
        const void* flow, const void* weight, const void* bias, void* out, void* x_packed,
        int N, int C, int H, int W, int O, int G, int KH, int KW, float D, float mag,
        int x_bf16, int tile_h, int tile_w, int pad, int smem_bytes, int branch, void* stream) {
  if (G < 1 || C % G || KH < 1 || KW < 1) return (int)cudaErrorInvalidValue;
  if (!general && (KH != 3 || KW != 3)) return (int)cudaErrorInvalidValue;
  const float* fl = static_cast<const float*>(flow);
  const float* wt = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_bf16) {
    using B = __nv_bfloat16;
    const crfp::ProE<B> pro{static_cast<const B*>(raw_off), static_cast<const B*>(raw_mask),
                            fl, mag};
    if (general)
      return general_route<B>(x, x_packed, wt, b, out, N, C, H, W, G, O, KH, KW, D, tile_h,
                              tile_w, pad, smem_bytes, branch, pro, s);
    if (branch != 0) return (int)cudaErrorInvalidValue;
    crfp::TileArgs<B> a{static_cast<const B*>(x), static_cast<B*>(x_packed), wt, b,
                        static_cast<B*>(out), N, C, H, W,
                        G, D, tile_h, tile_w, pad, 0, 0};
    e = dispatch(O, C / G, a, pro, smem_bytes, s);
  } else {
    const crfp::ProE<float> pro{static_cast<const float*>(raw_off),
                                static_cast<const float*>(raw_mask), fl, mag};
    if (general)
      return general_route<float>(x, x_packed, wt, b, out, N, C, H, W, G, O, KH, KW, D,
                                  tile_h, tile_w, pad, smem_bytes, branch, pro, s);
    if (branch != 0) return (int)cudaErrorInvalidValue;
    crfp::TileArgs<float> a{static_cast<const float*>(x), static_cast<float*>(x_packed), wt,
                            b, static_cast<float*>(out),
                            N, C, H, W, G, D, tile_h, tile_w, pad, 0, 0};
    e = dispatch(O, C / G, a, pro, smem_bytes, s);
  }
  return (int)e;
}

}  // namespace

#define CRFP_DCN_FUSED_ARGS                                                                  \
  const void *x, const void *raw_off, const void *raw_mask, const void *flow,                \
      const void *weight, const void *bias, void *out, void *x_packed, int N, int C, int H,  \
      int W, int O, int G, int KH, int KW, float D, float mag, int x_bf16, int tile_h,       \
      int tile_w, int pad, int smem_bytes, int branch, void *stream
#define CRFP_DCN_FUSED_PASS                                                                  \
  x, raw_off, raw_mask, flow, weight, bias, out, x_packed, N, C, H, W, O, G, KH, KW, D, mag, \
      x_bf16, tile_h, tile_w, pad, smem_bytes, branch, stream

// x: (N, C, H, W), raw_off (N, G*K2*2, H, W) and raw_mask (N, G*K2, H, W),
// all f32 or all bf16 (x_bf16); flow (N, 2, H, W) f32, channels (dx, dy);
// weight (O, C, KH, KW) f32; bias (O,) f32 or NULL; out (N, O, H, W) in x's
// type; x_packed: scratch of N*C*padded(H)*padded(W) elements of x's
// type. All contiguous. D < 0: no clamp. crfp_dcn_fused takes the tuned
// widths, 3x3 weights: O in {16, 32} (dcn_0/1/2 at mid 16 and 32), C/G in
// {2, 4}. The tile plan is ops/cuda/dcn.py::tile_plan's (per-tap, no
// shared mask: the tensor cores take bf16 x at O = 32; branch 0). No
// synchronisation, no allocation.
extern "C" int crfp_dcn_fused(CRFP_DCN_FUSED_ARGS) { return run(false, CRFP_DCN_FUSED_PASS); }

// The general route (common.cuh::dcn_tiles_general with ProE): any C % G ==
// 0, any O, any KH x KW; the plan is tile_plan's with route "general" (its
// branch with that branch's tile and smem_bytes, pad 0;
// crfp::check_gen_plan); x_packed holds N*G*H*W*gen_cpgp(C/G) elements.
extern "C" int crfp_dcn_fused_general(CRFP_DCN_FUSED_ARGS) {
  return run(true, CRFP_DCN_FUSED_PASS);
}
