// Kernel A: windowed modulated deformable conv (DCNv2) forward, NCHW.
//
// Replaces crfp_tpu/ops/pallas/dcn.py::_dcn_kernel (:59, pallas_call in
// _fwd_call :493). Semantics of the plain version
// crfp_torch/ops/dcn_windowed.py::deform_conv2d_windowed_ref: every offset
// component is clamped to +-D (D < 0: no clamp), each tap takes an exact
// bilinear sample of x at p + p_k + offset (zeros outside the frame), is
// scaled by its mask and contracted with the (O, C, 3, 3) weight inside
// the kernel; the bias is added last. shared_taps: one (dy, dx) per pixel
// and group for every tap. shared_mask: one mask per pixel and group,
// applied once to the group's sum (crfp_tpu/ops/pallas/dcn.py:196-200).
// Anchored (crfp_tpu/ops/pallas/dcn.py:975-1014): shared taps (dcn_3 under
// ModelConfig.dcn_anchor) or per-tap (DCNAlign(anchor=True) as a per-tap
// stage, which no model of the JAX package sets): a pre-pass writes each TPU
// cell's quantized mean displacement, averaged over the cell and the taps
// (common.cuh::anchor_table_kernel), and every tap of a pixel samples at its
// cell's anchor plus its own residual clipped to +-dl, exactly, up to A + dl
// (61 px for bf16 dcn_3 at D = 32, and for the per-tap stages at mid 32,
// D = 8, whose 4 channels a group quantize the columns to 32) from the
// pixel; the packed planes are padded for that reach (shared taps), or
// have no border and every corner is checked against the frame (per-tap).
//
// Design: the tiled routine of common.cuh, shared with kernel E
// (dcn_fused.cu), with the prologue crfp::ProA (f32 offsets and masks). A
// pre-pass packs x per group, pixel-major and zero-padded, so that a corner
// is one load of the group's channels with no frame check; blocks own
// tiles of pixels with all O outputs on a persistent grid and stage the
// weight once. bf16 x at O = 32 with per-tap masks: 32 pixels a block, a
// warp per group, the contraction over K = 9*C on the tensor cores
// (mma.sync m16n8k16, the modulated samples rounded to bf16 as the TPU
// kernel rounds them). bf16 x at O = 64 (the pyramids and PCD, C = 64,
// per-tap): 64 pixels a block of 8 warps, the samples of one tap at a time
// in U, contracted on the tensor cores while the next tap's corners are
// copied into shared memory by cp.async (common.cuh::dcn_tiles_wide_mma).
// f32 x and the other widths (O = 2, 4 for dcn_3, 16 for dcn_0/1/2 at mid
// 16, f32 at O = 64): a thread per pixel, f32 FMAs on the CUDA cores; a
// clamped call on bf16 x under shared_taps loads the 9 taps' corners as
// one 4 x 4 patch. The plan (ops/cuda/dcn.py::tile_plan) picks the tile. A
// group's window of x staged in shared memory for the O <= 32 routes was
// built and measured slower at every main-path shape (PERF.md) and is gone.
// Every other width the TPU kernel takes (any C % G == 0, O, kh x kw; the
// flags --mid_channels, --dg_num and --dcn_kernel reach them) runs the
// general route, crfp_dcn_fwd_general (common.cuh::dcn_tiles_general): x
// packed with its channels padded to whole 4-16 byte loads; O <= 8 (dcn_3)
// a thread per pixel with its sums in registers, bf16 x at O > 8 on the
// tensor cores with the weight staged once per block, the rest in chunks of
// K through shared memory. Its bound is the same bytes.
//
// Bound on the H100 at the main-path shapes (1080p, warp 720^2, mid 32):
// per-tap (dcn_0/1/2): x (1,32,180,180) bf16 2.1 MB + offset (1,144,180,180)
// f32 18.7 MB + mask (1,72,...) f32 9.3 MB + out 2.1 MB = 32 MB, i.e.
// ~9.6 us at 3.35 TB/s; 0.6 GFLOP of contraction is ~0.6 us at the bf16
// tensor rate (~9 us at the f32 CUDA-core rate, which is why bf16 goes to
// the tensor cores): bytes bound it. shared (dcn_3): x (1,4,720,720) bf16
// 4.1 MB + offset 4.1 MB + mask 2.1 MB + out 4.1 MB = 14.5 MB, ~4.3 us:
// bytes again. Offsets, masks and outputs are read and written once,
// coalesced (neighbouring lanes on neighbouring pixels of a tile row); the
// pre-pass adds one read and one write of x (+20-25 % with the border),
// ~2 MB a per-tap call. At O = 64: 2 * 9 * 64 * 64 = 73,728 FLOP a pixel,
// 68 GFLOP for the X8 pyramid's lv3 (1, 64, 720, 1280), 0.069 ms at the
// bf16 tensor-core peak against 0.34 GB of bf16 x, f32 offsets and masks
// and bf16 out (0.100 ms): bytes bound it in bf16, by 1.5x. The gather
// (4 corners x 9 taps of 128 bytes a pixel at 64 channels a group, through
// L1) is what the tensor-core route spends its time on; the pre-pass adds a
// read and a write of x. In f32 the same FLOP take ~1 ms at the CUDA-core
// rate: the operations bound that route.
#include "common.cuh"

namespace {

// TAP_ANCHOR: a per-tap anchored call (crfp::ProATap's arithmetic), its own
// instantiations, so that the clamped calls keep their code
template <typename T, int O, int CPG, bool MMA, int SRC, bool SHARED_TAPS = false,
          bool TAP_ANCHOR = false>
__global__ void __launch_bounds__(crfp::kMaxThreads, crfp::min_blocks(MMA, O))
dcn_fwd_kernel(crfp::TileArgs<T> a, crfp::ProA pro) {
  if constexpr (MMA && O == crfp::kWideO)
    crfp::dcn_tiles_wide_mma<CPG, SRC, TAP_ANCHOR>(a, pro);
  else if constexpr (MMA && TAP_ANCHOR)
    crfp::dcn_tiles_mma<CPG, SRC>(a, crfp::ProATap{pro});
  else if constexpr (MMA)
    crfp::dcn_tiles_mma<CPG, SRC>(a, pro);
  else if constexpr (O == crfp::kWideO)
    crfp::dcn_tiles_wide<CPG, SRC, TAP_ANCHOR>(a, pro);
  else if constexpr (TAP_ANCHOR)
    crfp::dcn_tiles<O, CPG, SRC, false>(a, crfp::ProATap{pro});
  else
    crfp::dcn_tiles<O, CPG, SRC, SHARED_TAPS>(a, pro);
}

// the pre-pass: x packed per group, pixel-major (crfp::pack_x)
template <typename T, int CPG>
__global__ void __launch_bounds__(256)
dcn_fwd_kernel_pack_x(const T* __restrict__ x, T* __restrict__ xp, int H, int W, int pad) {
  crfp::pack_x<T, CPG>(x, xp, H, W, pad);
}

// the general route (common.cuh::dcn_tiles_general: a kernel per branch and
// corner width) and its pre-pass
template <typename T, int BRANCH, int VB>
__global__ void __launch_bounds__(crfp::kGenThreads, crfp::gen_min_blocks(BRANCH, VB))
dcn_fwd_general(crfp::GenArgs<T> a, crfp::ProA pro) {
  crfp::dcn_tiles_general<BRANCH, VB>(a, pro);
}
template <typename T>
struct FwdGeneral {
  template <int BRANCH, int VB>
  struct K {
    static void (*get())(crfp::GenArgs<T>, crfp::ProA) { return dcn_fwd_general<T, BRANCH, VB>; }
  };
};

template <typename T>
__global__ void __launch_bounds__(256)
dcn_fwd_general_pack(const T* __restrict__ x, T* __restrict__ xp, float* __restrict__ dxp,
                     int H, int W, int cpg) {
  crfp::gen_pack(x, xp, dxp, H, W, cpg);
}

template <typename T, int O, int CPG, bool MMA>
cudaError_t launch(crfp::TileArgs<T> a, const crfp::ProA& pro, int smem,
                   cudaStream_t stream) {
  int threads = 0, tiles = 0;
  cudaError_t e = crfp::check_plan(a, MMA, CPG, O, smem, &threads, &tiles);
  if (e != cudaSuccess) return e;
  const bool padded = a.pad > 0;
  void (*fn)(crfp::TileArgs<T>, crfp::ProA) =
      padded ? dcn_fwd_kernel<T, O, CPG, MMA, crfp::kPadded>
             : dcn_fwd_kernel<T, O, CPG, MMA, crfp::kChecked>;
  // bf16 x, clamped, under shared taps: the 9 taps' 4 x 4 patch
  // (common.cuh::dcn_tiles); its checked form spills and is slower
  if constexpr (!MMA && O != crfp::kWideO && std::is_same<T, __nv_bfloat16>::value) {
    if (pro.shared_taps && padded) fn = dcn_fwd_kernel<T, O, CPG, false, crfp::kPadded, true>;
  }
  // per-tap anchored: the per-tap stages' widths, O >= 16, per-tap masks,
  // frame-checked corners, pad 0 (the O <= 4 widths are dcn_3's;
  // ops/cuda/dcn.py sends other calls to the general route; planes padded
  // by the reach read slower, PERF.md)
  if (pro.anchor != nullptr && !pro.shared_taps) {
    if (pro.shared_mask || padded) return cudaErrorInvalidValue;
    if constexpr (O >= 16) {
      fn = dcn_fwd_kernel<T, O, CPG, MMA, crfp::kChecked, false, true>;
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return crfp::launch_tiles(dcn_fwd_kernel_pack_x<T, CPG>, fn, a, pro, threads, smem, tiles,
                            stream);
}

template <typename T, int O>
cudaError_t dispatch_cpg(int cpg, bool mma, const crfp::TileArgs<T>& a,
                         const crfp::ProA& pro, int smem, cudaStream_t s) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (kBf16 && O == crfp::kWideO) {
    // bf16 at O = 64 on the tensor cores only: the pyramids' groups (16, 4,
    // 1 at mid 64) and PCD's (8 at nf 64)
    if (!mma) return cudaErrorInvalidValue;
    if (cpg == 4) return launch<T, O, 4, true>(a, pro, smem, s);
    if (cpg == 8) return launch<T, O, 8, true>(a, pro, smem, s);
    if (cpg == 16) return launch<T, O, 16, true>(a, pro, smem, s);
    if (cpg == 64) return launch<T, O, 64, true>(a, pro, smem, s);
  } else if constexpr (O == crfp::kWideO) {
    // f32 x at O = 64, on the CUDA cores
    if (mma) return cudaErrorInvalidValue;
    if (cpg == 4) return launch<T, O, 4, false>(a, pro, smem, s);
    if (cpg == 8) return launch<T, O, 8, false>(a, pro, smem, s);
    if (cpg == 16) return launch<T, O, 16, false>(a, pro, smem, s);
    if (cpg == 64) return launch<T, O, 64, false>(a, pro, smem, s);
  } else {
    if constexpr (kBf16 && O == crfp::kMmaO) {
      if (mma) {
        if (cpg == 2) return launch<T, O, 2, true>(a, pro, smem, s);
        if (cpg == 4) return launch<T, O, 4, true>(a, pro, smem, s);
        return cudaErrorInvalidValue;
      }
    } else {
      if (mma) return cudaErrorInvalidValue;
    }
    if (cpg == 2) return launch<T, O, 2, false>(a, pro, smem, s);
    if (cpg == 4) return launch<T, O, 4, false>(a, pro, smem, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(int O, int cpg, bool mma, const crfp::TileArgs<T>& a,
                     const crfp::ProA& pro, int smem, cudaStream_t s) {
  switch (O) {
    case 2:  // dcn_3 at mid 16
      return dispatch_cpg<T, 2>(cpg, mma, a, pro, smem, s);
    case 4:  // dcn_3 at mid 32
      return dispatch_cpg<T, 4>(cpg, mma, a, pro, smem, s);
    case 16:  // dcn_0/1/2 at mid 16
      return dispatch_cpg<T, 16>(cpg, mma, a, pro, smem, s);
    case 32:  // dcn_0/1/2 at mid 32
      return dispatch_cpg<T, 32>(cpg, mma, a, pro, smem, s);
    case crfp::kWideO:  // the pyramids' levels at mid 64, PCD at nf 64
      return dispatch_cpg<T, crfp::kWideO>(cpg, mma, a, pro, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

namespace {

// The general route: the plan's branch checked (crfp::check_gen_plan), the
// pre-pass and the branch's kernel.
template <typename T>
int general_route(const void* x, void* x_packed, const float* wt, const float* b, void* out,
                  int N, int C, int H, int W, int G, int O, int KH, int KW, float D, int tile_h,
                  int tile_w, int pad, int smem_bytes, int branch, const crfp::ProA& pro,
                  cudaStream_t s) {
  crfp::GenArgs<T> a{static_cast<const T*>(x), static_cast<T*>(x_packed), wt, b,
                     static_cast<T*>(out), N, C, H, W, G, O, KH, KW, D, tile_h, tile_w,
                     0, 0, 0};
  int tiles = 0, threads = 0;
  cudaError_t e = crfp::check_gen_plan(a, branch, pro.shared_mask, pad, smem_bytes, &tiles,
                                       &threads);
  if (e != cudaSuccess) return (int)e;
  return (int)crfp::launch_general(
      dcn_fwd_general_pack<T>, crfp::gen_kernel<T, FwdGeneral<T>::template K>(branch, C / G),
      a, pro, threads, smem_bytes, tiles, s);
}

// Both entries: the anchored pre-pass, then the tuned route (dispatch) or
// the general one.
int run(bool general, const void* x, const void* offset, const void* mask, const void* weight,
        const void* bias, void* out, void* x_packed, int N, int C, int H, int W, int O, int G,
        int KH, int KW, float D, int shared_taps, int shared_mask, int x_bf16, int tile_h,
        int tile_w, int pad, int smem_bytes, int branch, void* anchor, int band, int xtile,
        int sub_tile, int lane_q, int a_y, int a_x, float dl_r, float dl_c, void* stream) {
  if (G < 1 || C % G || KH < 1 || KW < 1) return (int)cudaErrorInvalidValue;
  if (!general && (KH != 3 || KW != 3)) return (int)cudaErrorInvalidValue;
  if (!general && O == crfp::kWideO && (shared_taps || shared_mask))
    return (int)cudaErrorInvalidValue;
  if (anchor != nullptr && D < fmaxf(a_y + dl_r, a_x + dl_c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  crfp::ProA pro{static_cast<const float*>(offset),
                 static_cast<const float*>(mask), shared_taps, shared_mask};
  if (anchor != nullptr) {
    const crfp::AnchorGrid g{band, xtile, (H + band - 1) / band, (W + xtile - 1) / xtile,
                             sub_tile, lane_q, a_y, a_x, dl_r, dl_c};
    const cudaError_t e = crfp::launch_anchor_table(
        static_cast<const float*>(offset), static_cast<float*>(anchor), N, G,
        shared_taps ? 1 : KH * KW, 0, 1, H, W, g, s);
    if (e != cudaSuccess) return (int)e;
    pro.anchor = static_cast<const float*>(anchor);
    pro.W = W, pro.band = band, pro.xtile = xtile, pro.nb = g.nb, pro.nt = g.nt;
    pro.dl_r = dl_r, pro.dl_c = dl_c;
  }
  const float* wt = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  if (general) {
    if (x_bf16) return general_route<__nv_bfloat16>(x, x_packed, wt, b, out, N, C, H, W, G, O,
                                                    KH, KW, D, tile_h, tile_w, pad, smem_bytes,
                                                    branch, pro, s);
    return general_route<float>(x, x_packed, wt, b, out, N, C, H, W, G, O, KH, KW, D, tile_h,
                                tile_w, pad, smem_bytes, branch, pro, s);
  }
  if (branch != 0) return (int)cudaErrorInvalidValue;
  const bool mma = x_bf16 && (O == crfp::kMmaO || O == crfp::kWideO) && !shared_mask;
  cudaError_t e;
  if (x_bf16) {
    crfp::TileArgs<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(x),
                                    static_cast<__nv_bfloat16*>(x_packed), wt, b,
                                    static_cast<__nv_bfloat16*>(out), N, C, H, W, G, D,
                                    tile_h, tile_w, pad, 0, 0};
    e = dispatch(O, C / G, mma, a, pro, smem_bytes, s);
  } else {
    crfp::TileArgs<float> a{static_cast<const float*>(x), static_cast<float*>(x_packed), wt,
                            b, static_cast<float*>(out),
                            N, C, H, W, G, D, tile_h, tile_w, pad, 0, 0};
    e = dispatch(O, C / G, mma, a, pro, smem_bytes, s);
  }
  return (int)e;
}

}  // namespace

#define CRFP_DCN_FWD_ARGS                                                                    \
  const void *x, const void *offset, const void *mask, const void *weight, const void *bias, \
      void *out, void *x_packed, int N, int C, int H, int W, int O, int G, int KH, int KW,   \
      float D, int shared_taps, int shared_mask, int x_bf16, int tile_h, int tile_w, int pad, \
      int smem_bytes, int branch, void *anchor, int band, int xtile, int sub_tile,          \
      int lane_q, int a_y, int a_x, float dl_r, float dl_c, void *stream
#define CRFP_DCN_FWD_PASS                                                                    \
  x, offset, mask, weight, bias, out, x_packed, N, C, H, W, O, G, KH, KW, D, shared_taps,    \
      shared_mask, x_bf16, tile_h, tile_w, pad, smem_bytes, branch, anchor, band, xtile,     \
      sub_tile, lane_q, a_y, a_x, dl_r, dl_c, stream

// x: (N, C, H, W) f32 or bf16 (x_bf16); offset (N, G*T*2, H, W) f32;
// mask (N, G*M, H, W) f32; weight (O, C, 3, 3) f32; bias (O,) f32 or
// NULL; out (N, O, H, W) in x's type; x_packed: scratch of N*C*padded(H)
// *padded(W) elements of x's type (the pre-pass writes x there per group,
// pixel-major, zero-padded). All contiguous. crfp_dcn_fwd takes the tuned
// routes' widths, 3x3 weights: O in {2, 4, 16, 32} with C/G in {2, 4}, or
// O = 64 with C/G in {4, 8, 16, 64}, per-tap (bf16 x: C = 64). The tile
// plan (tile_h, tile_w, pad, smem_bytes, branch = 0) is
// ops/cuda/dcn.py::tile_plan's;
// the tensor cores take bf16 x at O = 32 without shared_mask and at O =
// 64. No synchronisation, no allocation.
//
// Anchored (anchor not NULL, shared taps or per-tap): the cells are band x
// xtile pixels, nb = ceil(H / band) x nt = ceil(W / xtile) of them; a
// pre-pass (common.cuh::anchor_table_kernel) writes their anchors, the
// cell's mean over its pixels and their taps, quantized to sub_tile rows and
// lane_q columns within +-a_y / +-a_x, into `anchor`, f32 scratch of
// N*G*nb*nt*2 (ops/anchor.py::anchor_table's table); each tap of a pixel
// then takes F + clip(off_k - F, +-dl) for its cell's anchor F. D is the
// anchored reach max(a_y + dl_r, a_x + dl_c), which bounds every
// displacement and so sizes the padding (pad >= ceil(D) + 1) as a clamp to
// +-D would; a per-tap anchored call takes pad 0 (frame-checked corners).
extern "C" int crfp_dcn_fwd(CRFP_DCN_FWD_ARGS) { return run(false, CRFP_DCN_FWD_PASS); }

// The general route (common.cuh::dcn_tiles_general): any C % G == 0, any
// O, any KH x KW, per-tap or shared taps, clamped or anchored; the plan is
// tile_plan's with route "general" (its branch, crfp::GenBranch, with that
// branch's tile and smem_bytes, pad 0; crfp::check_gen_plan); x_packed
// holds N*G*H*W*gen_cpgp(C/G) elements of x's type.
extern "C" int crfp_dcn_fwd_general(CRFP_DCN_FWD_ARGS) { return run(true, CRFP_DCN_FWD_PASS); }
