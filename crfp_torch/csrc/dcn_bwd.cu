// Kernel D (DCN stages): windowed modulated deformable conv (DCNv2)
// backward, NCHW.
//
// Replaces crfp_tpu/ops/pallas/dcn.py::_dcn_bwd_kernel (:219, pallas_call in
// _bwd_call :593, and in anchored mode :581) for the DCN stages (the warp is
// csrc/flow_warp_bwd.cu).
// The forward is kernel A (csrc/dcn_fwd.cu):
//   out[o,p] = sum_g gm_g(p) sum_k sum_{c in g} W[o,c,k] m_gk(p) v_ck(p) + b[o]
// with v_ck the bilinear sample of x at p + p_k + clamp(off_gk(p), +-D)
// (zeros outside the frame), m_gk the per-tap mask (1 in shared_mask mode)
// and gm_g the shared mask (1 otherwise). For s_ck = sum_o W[o,c,k] g[o,p]:
//   d mask        = sum_c v_ck s_ck        (summed over k in shared_mask mode)
//   d v_ck        = m_gk gm_g s_ck         -> dx at the sample's corners
//   d offset      = sum_c d v_ck dv_ck/ds  (summed over k in shared_taps
//                   mode), times torch's clamp derivative: 1 where
//                   |off| <= D, else 0
//   dW[o,c,k]     = sum_p g[o,p] u_ck(p),  u_ck = m_gk gm_g v_ck
// Anchored (the TPU's _core_op_anchored :673-713; shared taps: dcn_3 trained
// under ModelConfig.dcn_anchor_vjp; per-tap: DCNAlign(anchor=True,
// anchor_vjp=True) as a per-tap stage): the forward (kernel A) sampled each
// tap k at F + clip(off_k - F, +-dl) for the anchor F of the pixel's cell,
// from the table its pre-pass wrote; this kernel reads that table (the
// forward's, saved by the autograd Function), samples at the same points and
// multiplies each tap's d-offset by its own residual clip's derivative, 1
// where |off_k - F| <= dl, else 0 (torch.clamp's, the plain version's). The
// anchor itself is flat (a rounded mean): no gradient reaches it. D is then
// the anchored reach A + dl, which sizes the zero border of the packed planes
// (62 pixels for dcn_3 in bf16 at D = 32) as a clamp to +-reach would, or,
// per-tap, the planes have no border (pad 0) and every corner is checked
// (ops/cuda/dcn.py::border); dx, d-mask and dW are the clamped mode's.
// The bias gradient is a reduction of grad_out outside the kernel, as on the
// TPU (crfp_tpu/ops/pallas/dcn.py:1139). For bf16 x, u is rounded to bf16
// before the dW product, as the TPU kernel rounds its dot operands
// (crfp_tpu/ops/pallas/dcn.py:323, :418); grad_out is bf16 already.
//
// Design. Three launches a call, all on the caller's stream, no
// allocation, no synchronisation:
//  1. dcn_bwd_pack: x packed per group, pixel-major, zero-padded by
//     ceil(D) + 1 below and + 2 above for a clamped call (crfp::pack_x, the
//     pre-pass of kernels A and E), so that a corner's CPG channels are one
//     8-16 byte load with no frame check; the same pass zeroes an f32 dx
//     accumulator of the same packed layout.
//  2. dcn_bwd_kernel, a programmatic dependent launch on a persistent grid
//     (at most 2 blocks a SM, see blocks_per_sm). A block of 256 threads
//     walks tiles of 256 / G pixels, a thread per (pixel, group): warp w of
//     a per-tap call (G = 8) is group w, its lanes 32 pixels. For each tile:
//      - the tile's output gradient, gs[O][P], staged in shared memory;
//      - each thread forms its 9 taps' samples, s = W^T g from its O
//        gradients in registers and the block's weight in shared memory
//        (read as broadcasts), d-mask and d-offset (written once,
//        deterministic), dx as one vector atomic a corner into the packed
//        accumulator (atomicAdd float4 / float2: one per corner, not one a
//        channel) and u into us[P][9C + 1];
//      - dW += gs^T us: thread t owns the 9 taps of rows x 1 of the (O, C)
//        plane, rows = min(O, 4), sums its pixels of the tile in registers
//        and adds them to its elements of the block's dW partial (the
//        registers live only in this phase: held across the pixel phase
//        they spilled).
//     Under shared taps on a clamped call (dcn_3) the 9 taps' corners lie
//     in one 4x4 patch (kernel A's, common.cuh::dcn_tiles); where every tap
//     keeps its shift there, the thread loads the 16 pixels at once, sums
//     its 36 corner contributions in 16 patch registers and issues 16 vector
//     atomics, else the per-tap ones.
//     Each block leaves one dW partial in scratch.
//  3. dcn_bwd_epilogue (programmatic dependent launch): unpacks dx into x's
//     dtype, NCHW, and sums the blocks' dW partials in a fixed order, so dW
//     is deterministic; only dx's f32 atomics depend on the run's order.
// The kernel's first design summed dW with a 5-step warp butterfly per
// (tap, channel, output) and shared atomics, added dx with four scalar
// global atomics per (pixel, tap, channel), gathered x one channel at a
// time from NCHW, and ran one thread per pixel for one group.
//
// Bound on the H100 at the training shapes (B 2, T 7, GT 192, mid 32, bf16
// activations): per-tap (dcn_0/1/2) x (2,32,48,48) bf16 0.29 MB + offset
// (2,144,48,48) f32 2.65 MB + mask 1.33 MB + grad_out 0.29 MB in, dx 0.29 MB
// + d-offset 2.65 MB + d-mask 1.33 MB out = 8.8 MB, ~2.6 us at 3.35 TB/s;
// shared (dcn_3) x (2,4,192,192) with one offset pair and mask per pixel
// moves 3.5 MB, ~1.1 us. The arithmetic is ~(4 O + 22) operations per
// (pixel, tap, channel), 0.19 GFLOP a per-tap call: ~2.8 us at the f32
// CUDA-core rate. Measured on an H100 (PERF.md): ~0.051 ms a per-tap call
// and ~0.039 a dcn_3 call; without the dx atomics (1.2-1.3 M a call) 13-18
// us less, without the s and dW arithmetic at most 5 us less. So the
// contraction stays on the CUDA cores, where bf16 and f32 share one code
// path; the atomics are what a next design must cut.
//
// The kernel above is the tuned route (the widths of dispatch(): O in {2, 4,
// 16, 32}, 2 or 4 channels a group, G <= 8, 3x3). Every other width the TPU
// kernel takes runs the general route below, crfp_dcn_bwd_general, in the
// same three launches with every size a runtime value.
#include "common.cuh"

namespace {

using crfp::kTaps;
using crfp::Pix;

constexpr int kThreads = 256;

// Resident blocks an SM that __launch_bounds__ asks for
// (ops/cuda/dcn.py::_bwd_blocks_per_sm): 2 (at most 128 registers a
// thread), 1 at O <= 4 with 4 channels a group (dcn_3 at mid 32), whose 64
// patch sums spilled ~480 B under 128 registers and ran 20 % slower
__host__ __device__ constexpr int blocks_per_sm(int o, int cpg) {
  return o <= 4 && cpg == 4 ? 1 : 2;
}

// output channels of a thread's dW block (ops/cuda/dcn.py::_dw_rows)
__host__ __device__ constexpr int dw_rows(int o) { return o < 4 ? o : 4; }

// Bytes of dynamic shared memory (ops/cuda/dcn.py::_bwd_smem_bytes): the
// f32 weight wf[G][9][CPG][O], the tile's output gradient gs[O][P] and its
// modulated samples us[P][9C + 1] (the + 1 keeps a warp's rows on distinct
// banks), P = kThreads / G; after a tile's dW products the threads' sums
// [kThreads][rows * 9] take the place of us.
__host__ __device__ inline int bwd_smem_bytes(int C, int O, int G) {
  const int P = kThreads / G;
  const int u = P * (kTaps * C + 1), red = kThreads * dw_rows(O) * kTaps;
  return 4 * (C * kTaps * O + O * P + (u > red ? u : red));
}

template <typename T>
struct BwdArgs {
  const T* x;            // (N, C, H, W)
  const float* off;      // (N, G*T*2, H, W), T = 1 under shared_taps
  const float* mask;     // (N, G*M, H, W), M = 1 under shared_mask
  const float* weight;   // (O, C, 3, 3)
  const T* gout;         // (N, O, H, W)
  T* dx;                 // (N, C, H, W)
  float* doff;           // offset's layout
  float* dmask;          // mask's layout
  float* dw;             // (O, C, 3, 3)
  T* xp;                 // scratch: x packed, [N][G][padded(H)][padded(W)][CPG]
  float* dxp;            // scratch: the f32 dx accumulator, packed like xp
  float* dw_part;        // scratch: the blocks' dW partials, [grid][rows x 9][NB]
  int N, C, H, W, O, G;
  float D;               // clamp (anchored: the reach); < 0: none
  int shared_taps, shared_mask;
  int tile_h, tile_w, pad, tiles_y, tiles_x, grid;
  // anchored: the forward's table [N][G][nb][nt][2] as (dy,
  // dx), cells of band x xtile pixels, residual margins dl_r / dl_c; NULL:
  // the clamp
  const float* anchor;
  int band, xtile, nb, nt;
  float dl_r, dl_c;
  // the general route: the weight's KH x KW, and under shared taps or a
  // shared mask its per-tap sums [N][G][K2][3][H][W] (d-mask, d-offset y,
  // x), which the epilogue adds up over the taps in order
  int KH, KW;
  float* tap_part;
  // the general route: its branch (crfp::GenBranch), the packed pixel's
  // padded channels (crfp::gen_cpgp) and, in the pixel branch, whether the
  // weight is staged in shared memory
  int branch, cpgp, wstage;
};

// dv * w into one corner of the packed f32 accumulator: one vector atomic
// for the group's CPG channels (sm_90)
template <int CPG>
__device__ __forceinline__ void red_pix(float* p, const float (&dv)[CPG], float w) {
  if constexpr (CPG == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(dv[0] * w, dv[1] * w, dv[2] * w, dv[3] * w));
  } else {
    static_assert(CPG == 2, "2 or 4 channels per group");
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(dv[0] * w, dv[1] * w));
  }
}

// frame pixel (y, x) of a packed accumulator plane (`pad` pixels of border,
// `stride` pixels a row); CHECKED: no border, and a corner outside the
// frame takes nothing
template <int CPG, bool CHECKED>
__device__ __forceinline__ void scatter(float* plane, int y, int x, int pad, int stride,
                                        int H, int W, const float (&dv)[CPG], float w) {
  if (CHECKED && !(y >= 0 && y < H && x >= 0 && x < W)) return;
  red_pix<CPG>(plane + ((long long)(y + pad) * stride + (x + pad)) * CPG, dv, w);
}

// Launch 1: x packed per group (crfp::pack_x) and the dx accumulator
// zeroed, the same pixel of both per thread.
template <typename T, int CPG>
__global__ void __launch_bounds__(256) dcn_bwd_pack(BwdArgs<T> a) {
  crfp::pack_x<T, CPG>(a.x, a.xp, a.H, a.W, a.pad);
  const int Hp = crfp::padded(a.H, a.pad), Wp = crfp::padded(a.W, a.pad);
  const int xq = blockIdx.x * blockDim.x + threadIdx.x;
  const int yq = blockIdx.y * blockDim.y + threadIdx.y;
  if (xq >= Wp || yq >= Hp) return;
  Pix<float, CPG> z;
#pragma unroll
  for (int c = 0; c < CPG; ++c) z.v[c] = 0.f;
  reinterpret_cast<Pix<float, CPG>*>(a.dxp)[((long long)blockIdx.z * Hp + yq) * Wp + xq] = z;
}

// Launch 2 (see the note at the top). SRC: crfp::kPadded or kChecked;
// PATCH: shared taps on padded planes, dx summed in the 4x4 patch;
// TAP_ANCHOR: a per-tap anchored call, its own instantiations, so that the
// clamped calls keep their code.
template <typename T, int O, int CPG, int SRC, bool PATCH, bool TAP_ANCHOR = false>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(O, CPG))
dcn_bwd_kernel(BwdArgs<T> a) {
  static_assert(!PATCH || SRC == crfp::kPadded, "the patch reads padded planes");
  constexpr bool kChk = SRC == crfp::kChecked;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int OB = dw_rows(O);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, G = a.G, H = a.H, W = a.W, P = kThreads / G;
  const long long HW = (long long)H * W;
  const int pad = a.pad, Wp = crfp::padded(W, pad);
  const long long HWp = (long long)crfp::padded(H, pad) * Wp;  // a packed plane
  const int US = kTaps * C + 1;
  float* wf = reinterpret_cast<float*>(smem);  // [g][k][ci][o]
  float* gs = wf + C * kTaps * O;              // [o][P]
  float* us = gs + O * P;                      // [P][US]

  // the weight, once per block: warp w takes the rows (g, k, ci) of wf
  // w, w + 8, ..., its lanes over o (O <= 32), so that the stores hit
  // distinct banks; all of a thread's loads are issued before its first
  // store (one round trip, where a load-store loop waited for each)
  {
    constexpr int kMaxC = 32;  // G <= 8 groups of <= 4 channels
    constexpr int kRows = kMaxC * kTaps / (kThreads / 32);
    float v[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int row = warp + u * (kThreads / 32);
      const int g = row / (kTaps * CPG), k = row / CPG % kTaps, ci = row % CPG;
      v[u] = row < C * kTaps && lane < O
                 ? __ldg(a.weight + ((long long)lane * C + g * CPG + ci) * kTaps + k)
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int row = warp + u * (kThreads / 32);
      if (row < C * kTaps && lane < O) wf[row * O + lane] = v[u];
    }
  }
  __syncthreads();

  // this thread's (pixel, group) of a tile, and its dW block
  const int gi = tid / P, q = tid - gi * P;
  const int qy = q / a.tile_w, qx = q - qy * a.tile_w;
  const int NB = O / OB * C, R = kThreads / NB;
  const int eb = tid % NB, slice = tid / NB, ob = eb / C, ce = eb - ob * C;
  const float* wg = wf + gi * kTaps * CPG * O;
  float* urow = us + q * US + gi * CPG * kTaps;  // u[c * 9 + k]
  const int taps = a.shared_taps ? 1 : kTaps, mtaps = a.shared_mask ? 1 : kTaps;
  // the block's dW partial: each tile adds its sums, each element by one
  // thread
  float* part = a.dw_part + (long long)blockIdx.x * O * C * kTaps;

  crfp::wait_for_packed_x();  // the packed x and the zeroed accumulator
  crfp::allow_dependent_launch();
  const Pix<T, CPG>* xp = reinterpret_cast<const Pix<T, CPG>*>(a.xp);
  const int tiles = a.N * a.tiles_y * a.tiles_x;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % a.tiles_x, r = tile / a.tiles_x;
    const int n = r / a.tiles_y, ty0 = (r % a.tiles_y) * a.tile_h, tx0 = tx * a.tile_w;
#pragma unroll 4
    for (int i = tid; i < O * P; i += kThreads) {
      const int o = i / P, qq = i - o * P;
      const int yy = ty0 + qq / a.tile_w, xx = tx0 + qq % a.tile_w;
      gs[i] = yy < H && xx < W ? crfp::load_f(a.gout + ((long long)n * O + o) * HW +
                                              (long long)yy * W + xx)
                               : 0.f;
    }
    __syncthreads();  // gs complete

    const int py = ty0 + qy, px = tx0 + qx;
    if (py < H && px < W) {
      const long long p = (long long)py * W + px, ng = (long long)n * G + gi;
      const float* offp = a.off + ng * taps * 2 * HW + p;
      const float* mp = a.mask + ng * mtaps * HW + p;
      float* doffp = a.doff + ng * taps * 2 * HW + p;
      float* dmp = a.dmask + ng * mtaps * HW + p;
      const Pix<T, CPG>* src = xp + ng * HWp;
      float* dst = a.dxp + ng * HWp * CPG;
      float go[O];
#pragma unroll
      for (int o = 0; o < O; ++o) go[o] = gs[o * P + q];
      const float gm = a.shared_mask ? __ldg(mp) : 1.f;
      // every tap's offset pair first (under shared taps one pair; loaded
      // with each tap's corners instead, it ran up to 3 % slower)
      float oyk[kTaps], oxk[kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int t = a.shared_taps ? 0 : k;
        oyk[k] = __ldg(offp + (2 * t) * HW);
        oxk[k] = __ldg(offp + (2 * t + 1) * HW);
      }
      // under shared taps, the derivative of the one offset pair's
      // window: the clamp's; anchored, the residual clip's around the
      // cell's anchor F, every tap then sampling at F + clip(off - F, +-dl)
      // exactly as kernel A's prologue (common.cuh::ProA) computes it
      float pass_y = crfp::clamp_pass(oyk[0], a.D), pass_x = crfp::clamp_pass(oxk[0], a.D);
      if (!TAP_ANCHOR && a.anchor != nullptr) {
        const float2 f = crfp::cell_anchor(a.anchor, ng, py, px, a.band, a.xtile, a.nb, a.nt);
        const float2 ps = crfp::anchored_pass(f, oyk[0], oxk[0], a.dl_r, a.dl_c);
        const float2 e = crfp::anchored_offset(f, oyk[0], oxk[0], a.dl_r, a.dl_c);
        pass_y = ps.x, pass_x = ps.y;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) oyk[k] = e.x, oxk[k] = e.y;
      }
      // per-tap anchored: each tap k samples at F + clip(off_k - F, +-dl)
      // and passes its d-offset where |off_k - F| <= dl; oyk / oxk keep the
      // raw offsets, F is all the mode holds besides
      float2 fa = make_float2(0.f, 0.f);
      if constexpr (TAP_ANCHOR)
        fa = crfp::cell_anchor(a.anchor, ng, py, px, a.band, a.xtile, a.nb, a.nt);
      // tap k's displacement, and its d-offset's factor (the derivative)
      auto disp_y = [&](int k) {
        if constexpr (TAP_ANCHOR)
          return crfp::anchored_offset(fa, oyk[k], oxk[k], a.dl_r, a.dl_c).x;
        return crfp::clamp_window(oyk[k], a.D);
      };
      auto disp_x = [&](int k) {
        if constexpr (TAP_ANCHOR)
          return crfp::anchored_offset(fa, oyk[k], oxk[k], a.dl_r, a.dl_c).y;
        return crfp::clamp_window(oxk[k], a.D);
      };
      auto pass_yk = [&](int k) {
        if constexpr (TAP_ANCHOR) return crfp::anchored_pass(fa, oyk[k], oxk[k], a.dl_r, a.dl_c).x;
        return crfp::clamp_pass(oyk[k], a.D);
      };
      auto pass_xk = [&](int k) {
        if constexpr (TAP_ANCHOR) return crfp::anchored_pass(fa, oyk[k], oxk[k], a.dl_r, a.dl_c).y;
        return crfp::clamp_pass(oxk[k], a.D);
      };
      float dgm = 0.f, sdy = 0.f, sdx = 0.f;
      float pd[4][4][CPG];  // dx of the patch (unused and removed without PATCH)

      // tap k's sample from its four corners: s, d-mask, d-offset, u, and
      // dx into the patch registers or by four vector atomics
      auto tap = [&](int k, float m, const Pix<T, CPG>& p00, const Pix<T, CPG>& p01,
                     const Pix<T, CPG>& p10, const Pix<T, CPG>& p11, bool in_patch) {
        const int ky = k / 3, kx = k % 3;
        const float sy = (float)(py + ky - 1) + disp_y(k);
        const float sx = (float)(px + kx - 1) + disp_x(k);
        const float y0f = floorf(sy), x0f = floorf(sx);
        const float fy = sy - y0f, fx = sx - x0f;
        const int y0 = (int)y0f, x0 = (int)x0f;
        const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
        const float w10 = fy * (1.f - fx), w11 = fy * fx;
        const float mult = m * gm;
        const float* wk = wg + k * CPG * O;
        float dm = 0.f, dsy = 0.f, dsx = 0.f, dv[CPG];
#pragma unroll
        for (int c = 0; c < CPG; ++c) {
          const float c00 = crfp::to_f(p00.v[c]), c01 = crfp::to_f(p01.v[c]);
          const float c10 = crfp::to_f(p10.v[c]), c11 = crfp::to_f(p11.v[c]);
          const float v = fmaf(w11, c11, fmaf(w10, c10, fmaf(w01, c01, w00 * c00)));
          float s = 0.f;
          if constexpr (O % 4 == 0) {  // the weight row as 16-byte broadcasts
            const float4* w4 = reinterpret_cast<const float4*>(wk + c * O);
#pragma unroll
            for (int o = 0; o < O; o += 4) {
              const float4 wv = w4[o / 4];
              s = fmaf(wv.w, go[o + 3], fmaf(wv.z, go[o + 2],
                                             fmaf(wv.y, go[o + 1], fmaf(wv.x, go[o], s))));
            }
          } else {
#pragma unroll
            for (int o = 0; o < O; ++o) s = fmaf(wk[c * O + o], go[o], s);
          }
          dm = fmaf(v, s, dm);
          dv[c] = mult * s;
          dsy = fmaf(dv[c], (1.f - fx) * (c10 - c00) + fx * (c11 - c01), dsy);
          dsx = fmaf(dv[c], (1.f - fy) * (c01 - c00) + fy * (c11 - c10), dsx);
          float u = mult * v;
          if constexpr (kBf16) u = __bfloat162float(__float2bfloat16(u));
          urow[c * kTaps + k] = u;
        }
        if (PATCH && in_patch) {
#pragma unroll
          for (int c = 0; c < CPG; ++c) {
            pd[ky][kx][c] += dv[c] * w00;
            pd[ky][kx + 1][c] += dv[c] * w01;
            pd[ky + 1][kx][c] += dv[c] * w10;
            pd[ky + 1][kx + 1][c] += dv[c] * w11;
          }
        } else {
          scatter<CPG, kChk>(dst, y0, x0, pad, Wp, H, W, dv, w00);
          scatter<CPG, kChk>(dst, y0, x0 + 1, pad, Wp, H, W, dv, w01);
          scatter<CPG, kChk>(dst, y0 + 1, x0, pad, Wp, H, W, dv, w10);
          scatter<CPG, kChk>(dst, y0 + 1, x0 + 1, pad, Wp, H, W, dv, w11);
        }
        if (a.shared_mask) {
          dgm += dm;
        } else {
          dmp[k * HW] = dm;
        }
        if (a.shared_taps) {
          sdy += dsy;
          sdx += dsx;
        } else {
          doffp[(2 * k) * HW] = pass_yk(k) * dsy;
          doffp[(2 * k + 1) * HW] = pass_xk(k) * dsx;
        }
      };
      // tap k's top-left corner
      auto corner = [&](int k, int& y, int& x) {
        y = (int)floorf((float)(py + k / 3 - 1) + disp_y(k));
        x = (int)floorf((float)(px + k % 3 - 1) + disp_x(k));
      };

      // the patch: under shared taps every tap's top-left corner at its
      // shift from tap 0's; its 16 pixels are loaded at once
      bool patch = PATCH;
      int y0p = 0, x0p = 0;
      if constexpr (PATCH) {
        corner(0, y0p, x0p);
#pragma unroll
        for (int k = 1; k < kTaps; ++k) {
          int y, x;
          corner(k, y, x);
          patch = patch && y == y0p + k / 3 && x == x0p + k % 3;
        }
      }
      if (PATCH && patch) {
        Pix<T, CPG> qp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qp[i][j] = crfp::pixel<T, CPG, false>(src, y0p + i, x0p + j, -pad, -pad, Wp, H, W);
#pragma unroll
            for (int c = 0; c < CPG; ++c) pd[i][j][c] = 0.f;
          }
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const int ky = k / 3, kx = k % 3;
          const float m = a.shared_mask ? 1.f : __ldg(mp + k * HW);
          tap(k, m, qp[ky][kx], qp[ky][kx + 1], qp[ky + 1][kx], qp[ky + 1][kx + 1], true);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v[CPG];
#pragma unroll
            for (int c = 0; c < CPG; ++c) v[c] = pd[i][j][c];
            scatter<CPG, false>(dst, y0p + i, x0p + j, pad, Wp, H, W, v, 1.f);
          }
      } else {
        // a tap at a time: its mask and corners (the corners of 3 or 9 taps
        // issued together spilled and ran 2-30 % slower)
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          int y, x;
          corner(k, y, x);
          const float m = a.shared_mask ? 1.f : __ldg(mp + k * HW);
          tap(k, m, crfp::pixel<T, CPG, kChk>(src, y, x, -pad, -pad, Wp, H, W),
              crfp::pixel<T, CPG, kChk>(src, y, x + 1, -pad, -pad, Wp, H, W),
              crfp::pixel<T, CPG, kChk>(src, y + 1, x, -pad, -pad, Wp, H, W),
              crfp::pixel<T, CPG, kChk>(src, y + 1, x + 1, -pad, -pad, Wp, H, W), false);
        }
      }
      if (a.shared_mask) dmp[0] = dgm;
      if (a.shared_taps) {  // the one offset pair every tap read
        doffp[0] = pass_y * sdy;
        doffp[HW] = pass_x * sdx;
      }
    } else {
#pragma unroll
      for (int i = 0; i < CPG * kTaps; ++i) urow[i] = 0.f;
    }
    __syncthreads();  // us complete

    // dW += gs^T us over this thread's pixels of the tile, in registers
    // only here (live through the pixel phase they spilled)
    float acc[OB][kTaps];
#pragma unroll
    for (int j = 0; j < OB; ++j)
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc[j][k] = 0.f;
    for (int pp = slice; pp < P; pp += R) {
      float gv[OB], uv[kTaps];
#pragma unroll
      for (int j = 0; j < OB; ++j) gv[j] = gs[(ob * OB + j) * P + pp];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) uv[k] = us[pp * US + ce * kTaps + k];
#pragma unroll
      for (int j = 0; j < OB; ++j)
#pragma unroll
        for (int k = 0; k < kTaps; ++k) acc[j][k] = fmaf(gv[j], uv[k], acc[j][k]);
    }
    const bool first = tile == (int)blockIdx.x;
    __syncthreads();  // gs and us read
    // the partial's layout is [rows x 9][NB]: a warp's stores are coalesced
    if (R == 1) {
#pragma unroll
      for (int jk = 0; jk < OB * kTaps; ++jk) {
        float* e = part + jk * NB + eb;
        if (first)
          *e = acc[jk / kTaps][jk % kTaps];
        else
          *e += acc[jk / kTaps][jk % kTaps];
      }
    } else {  // the R threads of a dW block summed in a fixed order
      float* red = us;  // [kThreads][OB * 9]
#pragma unroll
      for (int jk = 0; jk < OB * kTaps; ++jk)
        red[tid * OB * kTaps + jk] = acc[jk / kTaps][jk % kTaps];
      __syncthreads();
      for (int e = tid; e < NB * OB * kTaps; e += kThreads) {
        const int b = e % NB, jk = e / NB;
        float t = 0.f;
        for (int sl = 0; sl < R; ++sl) t += red[(sl * NB + b) * OB * kTaps + jk];
        if (first)
          part[e] = t;
        else
          part[e] += t;
      }
    }
    // the next tile writes gs first and us after a barrier: red is free then
  }
}

// Launch 3: blocks [0, nb_dx) unpack dx (a thread per (pixel, group)),
// the rest sum the dW partials: a block per 32 elements, warp w summing
// the partials w, w + 8, ..., then the 8 warps' sums in order.
template <typename T, int CPG>
__global__ void __launch_bounds__(256) dcn_bwd_epilogue(BwdArgs<T> a, int nb_dx) {
  crfp::wait_for_packed_x();  // the tiled kernel has finished
  const long long HW = (long long)a.H * a.W;
  if ((int)blockIdx.x < nb_dx) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)a.N * a.G * HW) return;
    const long long ng = i / HW, p = i - ng * HW;
    const int y = (int)(p / a.W), x = (int)(p - (long long)y * a.W);
    const int Hp = crfp::padded(a.H, a.pad), Wp = crfp::padded(a.W, a.pad);
    const Pix<float, CPG> v = reinterpret_cast<const Pix<float, CPG>*>(
        a.dxp)[(ng * Hp + y + a.pad) * Wp + x + a.pad];
    T* out = a.dx + ng * CPG * HW + p;
#pragma unroll
    for (int c = 0; c < CPG; ++c) out[c * HW] = crfp::store_f<T>(v.v[c]);
    return;
  }
  // slot e of a partial ([rows x 9][NB], see dcn_bwd_kernel) holds dW[o,c,k]
  // for o = (b / C) rows + j, c = b % C, with b = e % NB, (j, k) = e / NB
  __shared__ float sums[8][32];
  const int E = a.O * a.C * kTaps, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = dw_rows(a.O), NB = a.O / rows * a.C;
  const int e = ((int)blockIdx.x - nb_dx) * 32 + lane;
  float s = 0.f;
  if (e < E)
    for (int b = warp; b < a.grid; b += 8) s += a.dw_part[(long long)b * E + e];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < E) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += sums[w][lane];
    const int b = e % NB, j = e / NB / kTaps, k = e / NB % kTaps;
    a.dw[((b / a.C * rows + j) * a.C + b % a.C) * kTaps + k] = t;
  }
}

// ---- the general route ------------------------------------------------
// Every width the TPU kernel takes (any C % G == 0, O, KH x KW; common.cuh's
// note on the general route), in the tuned route's three launches:
//  1. dcn_bwd_general_pack: x packed per group, pixel-major, no border, its
//     channels padded to cpgp (common.cuh::gen_pack, gen_cpgp), and the f32
//     dx accumulator of the same layout zeroed;
//  2. the tiled kernel (programmatic dependent launch, persistent grid), of
//     the plan's branch:
//     - general/pixel (dcn_bwd_general_pixel, the tuned kernel's shape): a
//       block of 256 threads on tiles of P pixels (P G >= 256 where shared
//       memory allows: 256 pixels for dcn_3, 32 at 8 groups), a thread a
//       (pixel, group). Per tile the output gradient is staged as gs[O][P];
//       the weight, f32 in its own layout [O][C K2], once per block where
//       it fits (else read through L1). The thread walks its taps: a
//       tap's geometry once (under shared taps one offset pair and its
//       window derivative for all taps), per chunk of CH channels s = W^T g
//       from gs and the weight, the corners one vector load each (checked
//       against the frame once), d-mask, d-offset, u = m gm v (rounded to
//       bf16 for bf16 x) into U [C K2][P + 1], and dx as one vector atomic a
//       corner into the packed accumulator (float4, float2 or float: the
//       chunk's CH channels). d-mask and d-offset are summed over the taps
//       in tap order in registers (shared taps, a shared mask) and written
//       once; then dW += gs U^T over the tile, each element a fixed-order
//       sum (split over R pixel slices where O C K2 < 256 and added up in
//       slice order) added to the block's partial, in tile order.
//     - general/chunked (dcn_bwd_general_chunked; widths whose U does not
//       fit): K = C KH KW in common.cuh's chunks (rows ordered (group, tap,
//       channel)). Per chunk (a) s = W^T g for each row and pixel into S
//       [rows][32], a thread a (row, pixel), the O products from the f32
//       weight and grad_out through L1; (b) a thread a (group, tap) pair and
//       pixel: the tap's geometry once, then per channel the sample v,
//       d-mask += v s, dv = m gm s, the d-offset sums, u into U [rows][33],
//       and dx by one f32 atomicAdd a corner and channel; a pair's d-mask
//       and d-offset are written once, under shared taps (a shared mask) as
//       per-tap sums into tap_part; a pair split over chunks (CPG > 64)
//       carries its sums in shared memory; (c) dW += g^T u, a thread an
//       (output, row) element summed over the tile's pixels into the block's
//       partial, in tile order.
//  3. dcn_bwd_general_epilogue: dx unpacked into x's type; for the chunked
//     branch under shared taps d-offset, under a shared mask d-mask, summed
//     over the taps in order; dW summed over the blocks' partials in order.
// So dW, d-offset and d-mask are deterministic; only dx's f32 atomics are
// not. The route's first design was the chunked branch alone, with x packed
// and dx added one scalar a channel (PERF.md).

// bytes of dynamic shared memory of the chunked branch
// (ops/cuda/dcn.py::_GEN_BWD_SMEM): S [kGenRows][kGenPix], U [kGenRows]
// [kGenPix + 1], a split pair's sums [kGenPix][3], f32
__host__ __device__ constexpr int gen_bwd_smem_bytes() {
  return 4 * (crfp::kGenRows * crfp::kGenPix + crfp::kGenRows * (crfp::kGenPix + 1) +
              3 * crfp::kGenPix);
}

// and of the pixel branch at P pixels a tile (ops/cuda/dcn.py::
// _gen_bwd_pixel_smem): gs [O][P], U [C K2][P + 1], the dW slices' sums
// [kGenThreads], and where `staged` the weight [O][C K2], f32
__host__ __device__ inline long long gen_bwd_pixel_smem_bytes(int C, int O, int K2, int P,
                                                              bool staged) {
  const long long ck2 = (long long)C * K2;
  return 4 * ((long long)O * P + ck2 * (P + 1) + crfp::kGenThreads + (staged ? O * ck2 : 0));
}

// dv * w into one corner's chunk of the packed f32 accumulator: one vector
// atomic per 4 channels (sm_90), float2 or float below
template <int CH>
__device__ __forceinline__ void red_chunk(float* p, const float (&dv)[CH], float w) {
  if constexpr (CH >= 4) {
#pragma unroll
    for (int i = 0; i < CH; i += 4)
      atomicAdd(reinterpret_cast<float4*>(p + i),
                make_float4(dv[i] * w, dv[i + 1] * w, dv[i + 2] * w, dv[i + 3] * w));
  } else if constexpr (CH == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(dv[0] * w, dv[1] * w));
  } else {
    atomicAdd(p, dv[0] * w);
  }
}

template <typename T>
__global__ void __launch_bounds__(256) dcn_bwd_general_pack(BwdArgs<T> a) {
  crfp::gen_pack(a.x, a.xp, a.dxp, a.H, a.W, a.C / a.G);
}

// Launch 2, general/pixel (see above). VB: bytes of a corner's chunk
// (common.cuh::gen_vec_bytes).
template <typename T, int VB>
__global__ void __launch_bounds__(crfp::kGenThreads, crfp::kGenMinBlocks)
dcn_bwd_general_pixel(BwdArgs<T> a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int CH = VB / (int)sizeof(T), NT = crfp::kGenThreads;
  using V = Pix<T, CH>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int C = a.C, G = a.G, H = a.H, W = a.W, O = a.O, KW = a.KW, K2 = a.KH * a.KW;
  const int cpg = C / G, CK2 = C * K2, nch = a.cpgp / CH;
  const int ky0 = (a.KH - 1) / 2, kx0 = (KW - 1) / 2;
  const int P = a.tile_h * a.tile_w, US = P + 1;
  const long long HW = (long long)H * W;
  float* gs = reinterpret_cast<float*>(smem);  // [O][P]
  float* Us = gs + O * P;                      // [C K2][P + 1]: row c K2 + k
  float* red = Us + CK2 * US;                  // [NT]
  float* ws = red + NT;                        // [O][C K2], where staged
  const float* wt = a.wstage ? ws : a.weight;  // W[o][c][k] at o C K2 + c K2 + k
  if (a.wstage) {
    for (int i = tid; i < O * CK2; i += NT) ws[i] = __ldg(a.weight + i);
  }
  // dW: element e = o C K2 + c K2 + k, dW's own layout; where O C K2 < NT,
  // R slices of the pixels each
  const int E = O * CK2, R = E < NT ? NT / E : 1;
  float* dwp = a.dw_part + (long long)blockIdx.x * E;

  crfp::wait_for_packed_x();  // the packed x and the zeroed accumulator
  crfp::allow_dependent_launch();
  const V* xp = reinterpret_cast<const V*>(a.xp);
  const int tiles = a.N * a.tiles_y * a.tiles_x, items = P * G;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % a.tiles_x, r0 = tile / a.tiles_x;
    const int n = r0 / a.tiles_y, ty0 = (r0 % a.tiles_y) * a.tile_h, tx0 = tx * a.tile_w;
    for (int i = tid; i < O * P; i += NT) {
      const int o = i / P, qq = i - o * P;
      const int yy = ty0 + qq / a.tile_w, xx = tx0 + qq % a.tile_w;
      gs[i] = yy < H && xx < W ? crfp::load_f(a.gout + ((long long)n * O + o) * HW +
                                              (long long)yy * W + xx)
                               : 0.f;
    }
    __syncthreads();  // gs complete (and the weight staged)

    for (int it = tid; it < items; it += NT) {
      const int q = it % P, gi = it / P;
      const int py = ty0 + q / a.tile_w, px = tx0 + q % a.tile_w;
      float* urow = Us + (gi * cpg) * K2 * US + q;  // row (gi cpg + ci) K2 + k
      if (py >= H || px >= W) {
        for (int r = 0; r < cpg * K2; ++r) urow[r * US] = 0.f;
        continue;
      }
      const long long p = (long long)py * W + px, ng = (long long)n * G + gi;
      const int taps = a.shared_taps ? 1 : K2;
      const float* offp = a.off + ng * taps * 2 * HW + p;
      const float gm = a.shared_mask ? __ldg(a.mask + ng * HW + p) : 1.f;
      const bool anchored = a.anchor != nullptr;
      float2 fa = make_float2(0.f, 0.f);
      if (anchored) fa = crfp::cell_anchor(a.anchor, ng, py, px, a.band, a.xtile, a.nb, a.nt);
      // tap t's displacement and its d-offset's factor: the clamp's
      // derivative, or anchored the residual clip's around the cell's
      // anchor (dcn_bwd_kernel's arithmetic)
      float ey = 0.f, ex = 0.f, pass_y = 0.f, pass_x = 0.f;
      auto geometry = [&](int t) {
        const float oy = __ldg(offp + (2 * t) * HW), ox = __ldg(offp + (2 * t + 1) * HW);
        if (anchored) {
          const float2 e = crfp::anchored_offset(fa, oy, ox, a.dl_r, a.dl_c);
          const float2 ps = crfp::anchored_pass(fa, oy, ox, a.dl_r, a.dl_c);
          ey = e.x, ex = e.y, pass_y = ps.x, pass_x = ps.y;
        } else {
          ey = crfp::clamp_window(oy, a.D), ex = crfp::clamp_window(ox, a.D);
          pass_y = crfp::clamp_pass(oy, a.D), pass_x = crfp::clamp_pass(ox, a.D);
        }
      };
      geometry(0);
      const V* src = xp + ng * HW * nch;
      float* dst = a.dxp + ng * HW * a.cpgp;
      const float* wg = wt + (gi * cpg) * K2;
      float dgm = 0.f, sdy = 0.f, sdx = 0.f;
      for (int k = 0; k < K2; ++k) {
        if (k > 0 && !a.shared_taps) geometry(k);
        const float m = a.shared_mask ? 1.f : __ldg(a.mask + (ng * K2 + k) * HW + p);
        const float mult = m * gm;
        const float sy = (float)(py + k / KW - ky0) + ey, sx = (float)(px + k % KW - kx0) + ex;
        const float y0f = floorf(sy), x0f = floorf(sx), fy = sy - y0f, fx = sx - x0f;
        const int y0 = (int)y0f, x0 = (int)x0f;
        const float wq[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx, fy * (1.f - fx), fy * fx};
        long long at[4];
        bool in[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int y = y0 + i / 2, x = x0 + i % 2;
          in[i] = y >= 0 && y < H && x >= 0 && x < W;
          at[i] = in[i] ? ((long long)y * W + x) * nch : 0;
        }
        float dm = 0.f, dsy = 0.f, dsx = 0.f;
        for (int j = 0; j < nch; ++j) {
          // s = W^T g for the chunk's channels
          float s[CH];
#pragma unroll
          for (int cc = 0; cc < CH; ++cc) s[cc] = 0.f;
          const float* wk = wg + (j * CH) * K2 + k;
          for (int o = 0; o < O; ++o) {
            const float g = gs[o * P + q];
            const float* wo = wk + o * CK2;
#pragma unroll
            for (int cc = 0; cc < CH; ++cc)
              if (j * CH + cc < cpg) s[cc] = fmaf(wo[cc * K2], g, s[cc]);
          }
          V c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (in[i]) {
              c[i] = src[at[i] + j];
            } else {
#pragma unroll
              for (int cc = 0; cc < CH; ++cc) c[i].v[cc] = crfp::store_f<T>(0.f);
            }
          }
          float dv[CH];
#pragma unroll
          for (int cc = 0; cc < CH; ++cc) {
            const float c00 = crfp::to_f(c[0].v[cc]), c01 = crfp::to_f(c[1].v[cc]);
            const float c10 = crfp::to_f(c[2].v[cc]), c11 = crfp::to_f(c[3].v[cc]);
            const float v = fmaf(wq[3], c11, fmaf(wq[2], c10, fmaf(wq[1], c01, wq[0] * c00)));
            dm = fmaf(v, s[cc], dm);
            dv[cc] = mult * s[cc];
            dsy = fmaf(dv[cc], (1.f - fx) * (c10 - c00) + fx * (c11 - c01), dsy);
            dsx = fmaf(dv[cc], (1.f - fy) * (c01 - c00) + fy * (c11 - c10), dsx);
            if (j * CH + cc < cpg) {
              float u = mult * v;
              if constexpr (kBf16) u = __bfloat162float(__float2bfloat16(u));
              urow[((j * CH + cc) * K2 + k) * US] = u;
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (in[i]) red_chunk<CH>(dst + (at[i] + j) * CH, dv, wq[i]);
        }
        if (a.shared_mask) {
          dgm += dm;
        } else {
          a.dmask[(ng * K2 + k) * HW + p] = dm;
        }
        if (a.shared_taps) {
          sdy += dsy;
          sdx += dsx;
        } else {
          a.doff[(ng * K2 + k) * 2 * HW + p] = pass_y * dsy;
          a.doff[((ng * K2 + k) * 2 + 1) * HW + p] = pass_x * dsx;
        }
      }
      if (a.shared_mask) a.dmask[ng * HW + p] = dgm;
      if (a.shared_taps) {  // the one offset pair every tap read
        a.doff[ng * 2 * HW + p] = pass_y * sdy;
        a.doff[(ng * 2 + 1) * HW + p] = pass_x * sdx;
      }
    }
    __syncthreads();  // U complete

    // dW += gs U^T over the tile, into the block's partial
    const bool first = tile == (int)blockIdx.x;
    if (R > 1) {
      float t = 0.f;
      if (tid < E * R) {
        const int e = tid % E, sl = tid / E, o = e / CK2, r = e - o * CK2;
        for (int q = sl; q < P; q += R) t = fmaf(gs[o * P + q], Us[r * US + q], t);
      }
      red[tid] = t;
      __syncthreads();
      if (tid < E) {
        float sum = 0.f;
        for (int sl = 0; sl < R; ++sl) sum += red[sl * E + tid];
        dwp[tid] = first ? sum : dwp[tid] + sum;
      }
    } else {
      for (int e = tid; e < E; e += NT) {
        const int o = e / CK2, r = e - o * CK2;
        const float* go = gs + o * P;
        const float* ur = Us + r * US;
        float t = 0.f;
        for (int q = 0; q < P; ++q) t = fmaf(go[q], ur[q], t);
        dwp[e] = first ? t : dwp[e] + t;
      }
    }
    __syncthreads();  // gs, U and the slices read: the next tile may write them
  }
}

// Launch 2, general/chunked (see above).
template <typename T>
__global__ void __launch_bounds__(crfp::kGenThreads) dcn_bwd_general_chunked(BwdArgs<T> a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int P = crfp::kGenPix, R = crfp::kGenRows, US = P + 1, NT = crfp::kGenThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);  // [R][P]
  float* Us = S + R * P;                      // [R][US]
  float* part = Us + R * US;                  // [P][3]
  const int tid = threadIdx.x;
  const int C = a.C, G = a.G, H = a.H, W = a.W, O = a.O, KW = a.KW, K2 = a.KH * a.KW;
  const int cpg = C / G, cpgp = a.cpgp, ky0 = (a.KH - 1) / 2, kx0 = (KW - 1) / 2;
  const long long HW = (long long)H * W;
  const crfp::GenChunks chunks(cpg, G, K2);
  const int nchunks = chunks.count();
  const int taps = a.shared_taps ? 1 : K2;
  float* dwp = a.dw_part + (long long)blockIdx.x * O * C * K2;  // [O][C][K2]

  crfp::wait_for_packed_x();  // the packed x and the zeroed accumulator
  crfp::allow_dependent_launch();
  const int tiles = a.N * a.tiles_y * a.tiles_x;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % a.tiles_x, r0 = tile / a.tiles_x;
    const int n = r0 / a.tiles_y, y0 = (r0 % a.tiles_y) * a.tile_h, x0 = tx * a.tile_w;
    const bool first = tile == (int)blockIdx.x;
    const T* gn = a.gout + (long long)n * O * HW;
    for (int j = 0; j < nchunks; ++j) {
      int t0, nt, c0, nc;
      chunks.at(j, t0, nt, c0, nc);
      const int rows = nt * nc;
      // (a) s = W^T g; the last chunk's (c) read only U
      for (int i = tid; i < rows * P; i += NT) {
        const int r = i / P, pq = i - r * P;
        const int tl = r / nc, pair = t0 + tl, g = pair / K2, k = pair - g * K2;
        const int c = g * cpg + c0 + (r - tl * nc);
        const int py = y0 + pq / a.tile_w, px = x0 + pq % a.tile_w;
        float s = 0.f;
        if (py < H && px < W) {
          const T* go = gn + (long long)py * W + px;
          const float* wr = a.weight + (long long)c * K2 + k;
          for (int o = 0; o < O; ++o)
            s = fmaf(__ldg(wr + (long long)o * C * K2), crfp::load_f(go + o * HW), s);
        }
        S[i] = s;
      }
      __syncthreads();  // S complete; U free
      // (b) a thread a (pair, pixel)
      for (int i = tid; i < nt * P; i += NT) {
        const int tl = i / P, pq = i - tl * P;
        const int pair = t0 + tl, g = pair / K2, k = pair - g * K2;
        const int py = y0 + pq / a.tile_w, px = x0 + pq % a.tile_w;
        float* urow = Us + tl * nc * US + pq;
        if (py >= H || px >= W) {
          for (int cc = 0; cc < nc; ++cc) urow[cc * US] = 0.f;
          continue;
        }
        const long long p = (long long)py * W + px, ng = (long long)n * G + g;
        const float* offp = a.off + (ng * taps + (a.shared_taps ? 0 : k)) * 2 * HW + p;
        const float oy = __ldg(offp), ox = __ldg(offp + HW);
        float ey = crfp::clamp_window(oy, a.D), ex = crfp::clamp_window(ox, a.D);
        float pass_y = crfp::clamp_pass(oy, a.D), pass_x = crfp::clamp_pass(ox, a.D);
        if (a.anchor != nullptr) {  // dcn_bwd_kernel's anchored arithmetic
          const float2 f = crfp::cell_anchor(a.anchor, ng, py, px, a.band, a.xtile, a.nb, a.nt);
          const float2 ps = crfp::anchored_pass(f, oy, ox, a.dl_r, a.dl_c);
          const float2 e = crfp::anchored_offset(f, oy, ox, a.dl_r, a.dl_c);
          pass_y = ps.x, pass_x = ps.y, ey = e.x, ex = e.y;
        }
        const float m = a.shared_mask ? 1.f : __ldg(a.mask + (ng * K2 + k) * HW + p);
        const float gm = a.shared_mask ? __ldg(a.mask + ng * HW + p) : 1.f;
        const float mult = m * gm;
        const float sy = (float)(py + k / KW - ky0) + ey, sx = (float)(px + k % KW - kx0) + ex;
        const crfp::GenCorners cr = crfp::gen_corners(sy, sx, H, W, cpgp);
        const float fy = sy - floorf(sy), fx = sx - floorf(sx);
        const T* src = a.xp + ng * HW * cpgp + c0;
        float* dst = a.dxp + ng * HW * cpgp + c0;
        const float wq[4] = {cr.b.w00, cr.b.w01, cr.b.w10, cr.b.w11};
        float dm = 0.f, dsy = 0.f, dsx = 0.f;
        if (c0 > 0) dm = part[pq * 3], dsy = part[pq * 3 + 1], dsx = part[pq * 3 + 2];
        for (int cc = 0; cc < nc; ++cc) {
          float cv[4];
          crfp::gen_corner_values(cr, src + cc, cv);
          const float v = crfp::gen_blend(cr.b, cv);
          const float s = S[(tl * nc + cc) * P + pq];
          dm = fmaf(v, s, dm);
          const float dv = mult * s;
          dsy = fmaf(dv, (1.f - fx) * (cv[2] - cv[0]) + fx * (cv[3] - cv[1]), dsy);
          dsx = fmaf(dv, (1.f - fy) * (cv[1] - cv[0]) + fy * (cv[3] - cv[2]), dsx);
          float u = mult * v;
          if constexpr (kBf16) u = __bfloat162float(__float2bfloat16(u));
          urow[cc * US] = u;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (cr.in[q]) atomicAdd(dst + cr.at[q] + cc, dv * wq[q]);
        }
        if (c0 + nc < cpg) {  // the pair goes on in the next chunk
          part[pq * 3] = dm, part[pq * 3 + 1] = dsy, part[pq * 3 + 2] = dsx;
          continue;
        }
        if (a.shared_taps || a.shared_mask) {  // summed over the taps by the epilogue
          float* tp = a.tap_part + ((ng * K2 + k) * 3) * HW + p;
          tp[0] = dm;
          tp[HW] = pass_y * dsy;
          tp[2 * HW] = pass_x * dsx;
        }
        if (!a.shared_mask) a.dmask[(ng * K2 + k) * HW + p] = dm;
        if (!a.shared_taps) {
          a.doff[(ng * K2 + k) * 2 * HW + p] = pass_y * dsy;
          a.doff[((ng * K2 + k) * 2 + 1) * HW + p] = pass_x * dsx;
        }
      }
      __syncthreads();  // U complete
      // (c) dW += g^T u over the tile, into the block's partial
      for (int i = tid; i < O * rows; i += NT) {
        const int o = i / rows, r = i - o * rows;
        const int tl = r / nc, pair = t0 + tl, g = pair / K2, k = pair - g * K2;
        const int c = g * cpg + c0 + (r - tl * nc);
        const T* go = gn + (long long)o * HW;
        const float* ur = Us + r * US;
        float t = 0.f;
        for (int pq = 0; pq < P; ++pq) {
          const int py = y0 + pq / a.tile_w, px = x0 + pq % a.tile_w;
          if (py < H && px < W) t = fmaf(crfp::load_f(go + (long long)py * W + px), ur[pq], t);
        }
        float* e = dwp + ((long long)o * C + c) * K2 + k;
        *e = first ? t : *e + t;
      }
    }
  }
}

// Launch 3 of the general route: blocks [0, nb_px) take a thread a (image,
// group, pixel): dx unpacked, for the chunked branch under shared taps or a
// shared mask the per-tap sums added up in tap order; the rest a thread a dW
// element, the blocks' partials summed in order.
template <typename T>
__global__ void __launch_bounds__(256) dcn_bwd_general_epilogue(BwdArgs<T> a, int nb_px) {
  crfp::wait_for_packed_x();  // the tiled kernel has finished
  const long long HW = (long long)a.H * a.W;
  const int K2 = a.KH * a.KW, cpg = a.C / a.G;
  if ((int)blockIdx.x < nb_px) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)a.N * a.G * HW) return;
    const long long ng = i / HW, p = i - ng * HW;
    const float* v = a.dxp + i * a.cpgp;
    T* out = a.dx + ng * cpg * HW + p;
    for (int c = 0; c < cpg; ++c) out[c * HW] = crfp::store_f<T>(v[c]);
    if (a.branch == crfp::kGenChunked && (a.shared_taps || a.shared_mask)) {
      const float* tp = a.tap_part + ng * K2 * 3 * HW + p;
      float dm = 0.f, sy = 0.f, sx = 0.f;
      for (int k = 0; k < K2; ++k) {
        dm += tp[(k * 3) * HW];
        sy += tp[(k * 3 + 1) * HW];
        sx += tp[(k * 3 + 2) * HW];
      }
      if (a.shared_taps) {
        a.doff[ng * 2 * HW + p] = sy;
        a.doff[(ng * 2 + 1) * HW + p] = sx;
      }
      if (a.shared_mask) a.dmask[ng * HW + p] = dm;
    }
    return;
  }
  const long long E = (long long)a.O * a.C * K2;
  const long long e = (long long)((int)blockIdx.x - nb_px) * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int b = 0; b < a.grid; ++b) s += a.dw_part[(long long)b * E + e];
  a.dw[e] = s;
}

// a programmatic dependent launch of `fn` on `stream`
template <typename... Args>
cudaError_t launch_dependent(void (*fn)(Args...), dim3 grid, dim3 block, int smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, fn, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the pixel branch's kernel for the corners' vector bytes (8 or 16 for f32
// x, 4, 8 or 16 for bf16)
template <typename T>
void (*general_pixel(int vb))(BwdArgs<T>) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (vb == 4) return dcn_bwd_general_pixel<T, 4>;
  }
  return vb == 8 ? dcn_bwd_general_pixel<T, 8> : dcn_bwd_general_pixel<T, 16>;
}

template <typename T>
cudaError_t launch_general(BwdArgs<T> a, int smem, cudaStream_t stream) {
  void (*fn)(BwdArgs<T>) =
      a.branch == crfp::kGenPixel
          ? general_pixel<T>(crfp::gen_vec_bytes(a.C / a.G, (int)sizeof(T)))
          : dcn_bwd_general_chunked<T>;
  // the first launch of each kernel raises its shared memory limit
  static void (*raised[8])(BwdArgs<T>) = {};
  bool seen = false;
  for (auto f : raised) seen = seen || f == fn;
  if (!seen) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         crfp::kMaxSmem);
    if (e != cudaSuccess) return e;
    for (auto& f : raised)
      if (f == nullptr) {
        f = fn;
        break;
      }
  }
  dcn_bwd_general_pack<T><<<dim3((unsigned)((a.W + 31) / 32), (unsigned)((a.H + 7) / 8),
                                 (unsigned)(a.N * a.G)),
                            dim3(32, 8), 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_dependent(fn, dim3((unsigned)a.grid), dim3(crfp::kGenThreads), smem, stream, a);
  if (e != cudaSuccess) return e;
  const long long pixels = (long long)a.N * a.G * a.H * a.W;
  const int nb_px = (int)((pixels + 255) / 256);
  const int nb_dw = (int)(((long long)a.O * a.C * a.KH * a.KW + 255) / 256);
  return launch_dependent(dcn_bwd_general_epilogue<T>, dim3((unsigned)(nb_px + nb_dw)),
                          dim3(256), 0, stream, a, nb_px);
}

template <typename T, int O, int CPG>
cudaError_t launch(BwdArgs<T> a, int smem, int patch, cudaStream_t stream) {
  void (*fns[4])(BwdArgs<T>) = {dcn_bwd_kernel<T, O, CPG, crfp::kChecked, false>,
                                 dcn_bwd_kernel<T, O, CPG, crfp::kPadded, false>,
                                 dcn_bwd_kernel<T, O, CPG, crfp::kPadded, true>, nullptr};
  // per-tap anchored: the per-tap stages' widths, O >= 16, per-tap masks,
  // frame-checked corners, pad 0 (ops/cuda/dcn.py sends other calls to the
  // general route; planes padded by the reach read slower, PERF.md)
  if constexpr (O >= 16) fns[3] = dcn_bwd_kernel<T, O, CPG, crfp::kChecked, false, true>;
  const bool tap = a.anchor != nullptr && !a.shared_taps;
  if (tap && (fns[3] == nullptr || a.shared_mask || patch || a.pad > 0))
    return cudaErrorInvalidValue;
  const int variant = tap ? 3 : patch ? 2 : a.pad > 0 ? 1 : 0;
  // the first launch of each instantiation raises its shared memory limit
  // and asks for the largest shared-memory carveout: with the default one
  // an SM held one 78 KB block (per-tap at O = 32), and 144 blocks ran in
  // two waves
  static bool raised[4] = {false, false, false, false};
  if (!raised[variant]) {
    cudaError_t e = cudaFuncSetAttribute(fns[variant],
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         crfp::kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fns[variant], cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    raised[variant] = true;
  }
  const int Hp = crfp::padded(a.H, a.pad), Wp = crfp::padded(a.W, a.pad);
  dcn_bwd_pack<T, CPG><<<dim3((unsigned)((Wp + 31) / 32), (unsigned)((Hp + 7) / 8),
                              (unsigned)(a.N * a.G)),
                         dim3(32, 8), 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_dependent(fns[variant], dim3((unsigned)a.grid), dim3(kThreads), smem, stream,
                       a);
  if (e != cudaSuccess) return e;
  const long long pixels = (long long)a.N * a.G * a.H * a.W;
  const int nb_dx = (int)((pixels + 255) / 256);
  const int nb_dw = (O * a.C * kTaps + 31) / 32;
  return launch_dependent(dcn_bwd_epilogue<T, CPG>, dim3((unsigned)(nb_dx + nb_dw)), dim3(256),
                          0, stream, a, nb_dx);
}

template <typename T, int O>
cudaError_t dispatch_cpg(int cpg, const BwdArgs<T>& a, int smem, int patch, cudaStream_t s) {
  if (cpg == 2) return launch<T, O, 2>(a, smem, patch, s);
  if (cpg == 4) return launch<T, O, 4>(a, smem, patch, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(BwdArgs<T> a, int smem, int patch, cudaStream_t s) {
  const int cpg = a.C / a.G;
  switch (a.O) {
    case 2:  // dcn_3 at mid 16
      return dispatch_cpg<T, 2>(cpg, a, smem, patch, s);
    case 4:  // dcn_3 at mid 32
      return dispatch_cpg<T, 4>(cpg, a, smem, patch, s);
    case 16:  // dcn_0/1/2 at mid 16
      return dispatch_cpg<T, 16>(cpg, a, smem, patch, s);
    case 32:  // dcn_0/1/2 at mid 32
      return dispatch_cpg<T, 32>(cpg, a, smem, patch, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The plan checks of ops/cuda/dcn.py::bwd_plan and width_fault:
// cudaErrorInvalidValue for a plan it would not make.
template <typename T>
cudaError_t check_plan(BwdArgs<T>& a, int smem, int patch, int a_y, int a_x) {
  if (a.G != 1 && a.G != 2 && a.G != 4 && a.G != 8) return cudaErrorInvalidValue;
  const int cpg = a.C / a.G, P = kThreads / a.G;
  if (a.C != a.G * cpg || (cpg != 2 && cpg != 4)) return cudaErrorInvalidValue;
  const int NB = a.O / dw_rows(a.O) * a.C;
  if (kThreads % NB) return cudaErrorInvalidValue;
  if (a.tile_h < 1 || a.tile_w < 1 || a.tile_h * a.tile_w != P) return cudaErrorInvalidValue;
  if (a.pad < 0 || (a.pad > 0 && (a.D < 0.f || (float)(a.pad - 1) < ceilf(a.D))))
    return cudaErrorInvalidValue;
  if (patch && !(a.shared_taps && a.pad > 0)) return cudaErrorInvalidValue;
  // anchored: a cell grid, and D (which sized the padding) no less than the
  // reach, so that no sample leaves the padded planes
  if (a.anchor != nullptr &&
      (a.band < 1 || a.xtile < 1 || a.D < fmaxf(a_y + a.dl_r, a_x + a.dl_c)))
    return cudaErrorInvalidValue;
  if (smem != bwd_smem_bytes(a.C, a.O, a.G) || smem > crfp::kMaxSmem)
    return cudaErrorInvalidValue;
  a.tiles_y = (a.H + a.tile_h - 1) / a.tile_h;
  a.tiles_x = (a.W + a.tile_w - 1) / a.tile_w;
  const int tiles = a.N * a.tiles_y * a.tiles_x;
  return tiles > 0 && a.grid >= 1 && a.grid <= tiles ? cudaSuccess : cudaErrorInvalidValue;
}

// The general route's plan check (ops/cuda/dcn.py::bwd_plan, route
// "general"): no border, no patch; the pixel branch: tiles of 32-256
// pixels, a multiple of 32, its shared memory with or without the weight
// (which sets wstage); the chunked branch: tiles of kGenPix pixels, its
// fixed shared memory; anchored: a cell grid.
template <typename T>
cudaError_t check_general_plan(BwdArgs<T>& a, int smem, int patch) {
  if (a.G < 1 || a.C < 1 || a.C % a.G || a.O < 1 || a.KH < 1 || a.KW < 1)
    return cudaErrorInvalidValue;
  const int P = a.tile_h * a.tile_w;
  if (a.tile_h < 1 || a.tile_w < 1 || a.pad != 0 || patch) return cudaErrorInvalidValue;
  if (a.anchor != nullptr && (a.band < 1 || a.xtile < 1)) return cudaErrorInvalidValue;
  if (a.branch == crfp::kGenPixel) {
    if (P % 32 || P > crfp::kGenThreads || smem > crfp::kMaxSmem) return cudaErrorInvalidValue;
    const int K2 = a.KH * a.KW;
    if (smem == gen_bwd_pixel_smem_bytes(a.C, a.O, K2, P, true))
      a.wstage = 1;
    else if (smem == gen_bwd_pixel_smem_bytes(a.C, a.O, K2, P, false))
      a.wstage = 0;
    else
      return cudaErrorInvalidValue;
  } else if (a.branch == crfp::kGenChunked) {
    if (P != crfp::kGenPix || smem != gen_bwd_smem_bytes()) return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  a.tiles_y = (a.H + a.tile_h - 1) / a.tile_h;
  a.tiles_x = (a.W + a.tile_w - 1) / a.tile_w;
  const int tiles = a.N * a.tiles_y * a.tiles_x;
  return tiles > 0 && a.grid >= 1 && a.grid <= tiles ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run(bool general, const void* x, const void* offset, const void* mask,
                const void* weight, const void* grad_out, void* dx, void* d_offset,
                void* d_mask, void* dw, void* x_packed, void* acc, int N, int C, int H, int W,
                int O, int G, int KH, int KW, float D, int shared_taps, int shared_mask,
                int tile_h, int tile_w, int pad, int smem, int grid, int patch, int branch,
                const float* anchor, int band, int xtile, int a_y, int a_x, float dl_r,
                float dl_c, cudaStream_t s) {
  const int Hp = crfp::padded(H, pad), Wp = crfp::padded(W, pad);
  const int cpgp = crfp::gen_cpgp(C / G);
  float* dxp = static_cast<float*>(acc);
  float* dw_part = dxp + (general ? (long long)N * G * H * W * cpgp : (long long)N * C * Hp * Wp);
  BwdArgs<T> a{static_cast<const T*>(x), static_cast<const float*>(offset),
               static_cast<const float*>(mask), static_cast<const float*>(weight),
               static_cast<const T*>(grad_out), static_cast<T*>(dx),
               static_cast<float*>(d_offset), static_cast<float*>(d_mask),
               static_cast<float*>(dw), static_cast<T*>(x_packed), dxp, dw_part,
               N, C, H, W, O, G, D, shared_taps, shared_mask,
               tile_h, tile_w, pad, 0, 0, grid,
               anchor, band, xtile, band > 0 ? (H + band - 1) / band : 0,
               xtile > 0 ? (W + xtile - 1) / xtile : 0, dl_r, dl_c,
               KH, KW, dw_part + (long long)grid * O * C * KH * KW, branch, cpgp, 0};
  if (!general && branch != 0) return cudaErrorInvalidValue;
  if (general) {
    cudaError_t e = check_general_plan(a, smem, patch);
    return e != cudaSuccess ? e : launch_general(a, smem, s);
  }
  cudaError_t e = check_plan(a, smem, patch, a_y, a_x);
  if (e != cudaSuccess) return e;
  return dispatch(a, smem, patch, s);
}

int entry(bool general, const void* x, const void* offset, const void* mask,
          const void* weight, const void* grad_out, void* dx, void* d_offset, void* d_mask,
          void* dw, void* x_packed, void* acc, int N, int C, int H, int W, int O, int G, int KH,
          int KW, float D, int shared_taps, int shared_mask, int x_bf16, const void* anchor,
          int band, int xtile, int a_y, int a_x, float dl_r, float dl_c, int tile_h,
          int tile_w, int pad, int smem_bytes, int grid, int patch, int branch, void* stream) {
  if (G < 1 || C % G || KH < 1 || KW < 1) return (int)cudaErrorInvalidValue;
  if (!general && (KH != 3 || KW != 3)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* an = static_cast<const float*>(anchor);
  cudaError_t e =
      x_bf16 ? run<__nv_bfloat16>(general, x, offset, mask, weight, grad_out, dx, d_offset,
                                  d_mask, dw, x_packed, acc, N, C, H, W, O, G, KH, KW, D,
                                  shared_taps, shared_mask, tile_h, tile_w, pad, smem_bytes,
                                  grid, patch, branch, an, band, xtile, a_y, a_x, dl_r, dl_c,
                                  s)
             : run<float>(general, x, offset, mask, weight, grad_out, dx, d_offset, d_mask,
                          dw, x_packed, acc, N, C, H, W, O, G, KH, KW, D, shared_taps,
                          shared_mask, tile_h, tile_w, pad, smem_bytes, grid, patch, branch, an,
                          band, xtile, a_y, a_x, dl_r, dl_c, s);
  return (int)e;
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

#define CRFP_DCN_BWD_ARGS                                                                    \
  const void *x, const void *offset, const void *mask, const void *weight,                  \
      const void *grad_out, void *dx, void *d_offset, void *d_mask, void *dw,               \
      void *x_packed, void *acc, int N, int C, int H, int W, int O, int G, int KH, int KW,  \
      float D, int shared_taps, int shared_mask, int x_bf16, const void *anchor, int band,  \
      int xtile, int sub_tile, int lane_q, int a_y, int a_x, float dl_r, float dl_c,        \
      int tile_h, int tile_w, int pad, int smem_bytes, int grid, int patch, int branch,    \
      void *stream
#define CRFP_DCN_BWD_PASS                                                                    \
  x, offset, mask, weight, grad_out, dx, d_offset, d_mask, dw, x_packed, acc, N, C, H, W, O, \
      G, KH, KW, D, shared_taps, shared_mask, x_bf16, anchor, band, xtile, a_y, a_x, dl_r,  \
      dl_c, tile_h, tile_w, pad, smem_bytes, grid, patch, branch, stream

// x: (N, C, H, W) f32 or bf16 (x_bf16); offset (N, G*T*2, H, W) f32; mask
// (N, G*M, H, W) f32; weight (O, C, KH, KW) f32; grad_out (N, O, H, W) in
// x's type. Outputs, every element written: dx (N, C, H, W) in x's type,
// d_offset and d_mask in the layouts of offset and mask (f32), dw (O, C,
// KH, KW) f32. Scratch: x_packed, N*C*padded(H)*padded(W) elements of x's
// type; acc, f32: the packed dx accumulator (as many elements), then
// grid*O*C*K2 for the blocks' dW partials. All contiguous. crfp_dcn_bwd
// takes the tuned widths, 3x3 weights: O in {2, 4, 16, 32}, C/G in {2, 4},
// G in {1, 2, 4, 8}. The plan (tile_h, tile_w, pad, smem_bytes, grid,
// patch, branch = 0), the last arguments, is ops/cuda/dcn.py::bwd_plan's. Three
// launches, no synchronisation, no allocation.
//
// Anchored (anchor not NULL, shared taps or per-tap): the table that the forward's
// pre-pass wrote (crfp_dcn_fwd's `anchor`), f32 [N][G][ceil(H / band)]
// [ceil(W / xtile)][2]; the geometry arguments are crfp_dcn_fwd's (the
// quanta sub_tile and lane_q are not read here): a_y, a_x the anchors' range
// and dl_r, dl_c the residual margins; D the anchored reach max(a_y + dl_r,
// a_x + dl_c), which bounds every displacement and so sizes the padding
// (pad >= ceil(D) + 1). NULL: zeros in band ... dl_c.
extern "C" int crfp_dcn_bwd(CRFP_DCN_BWD_ARGS) { return entry(false, CRFP_DCN_BWD_PASS); }

// The general route (see "the general route" above): any C % G == 0, O and
// KH x KW, per-tap or shared taps, clamped or anchored; pad 0, no patch, the
// plan's branch (crfp::GenBranch: pixel or chunked) with that branch's tile
// and smem_bytes (check_general_plan). x_packed holds N*G*H*W*cpgp elements
// (cpgp = crfp::gen_cpgp(C/G)); acc the dx accumulator (as many), the dW
// partials (grid*O*C*KH*KW) and, for the chunked branch under shared taps or
// a shared mask, the per-tap sums (N*G*KH*KW*3*H*W).
extern "C" int crfp_dcn_bwd_general(CRFP_DCN_BWD_ARGS) {
  return entry(true, CRFP_DCN_BWD_PASS);
}
