// Kernels G and H: the serving step's full-resolution few-channel chains
// around the HR alignment (dcn_3) of the runtime models, each in one launch.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (crfp_tpu/nn/align.py's heads, crfp_tpu/models/runtime.py's
// forward_resblocks_3). They were added because cuDNN serves convolutions of
// 1-10 channels at 4 x 1080 x 1920 with its CUDA-core implicit GEMM and a
// layout conversion on each side, and PyTorch runs a full-frame pass for
// every pixel shuffle, activation, concatenation, bias and residual add
// between them: a served step of the deployment moved some 1.3 GB through
// device memory for them.
//
//  - hr_conv_head_kernel (G): dcn_3's offset and mask head. From
//    upsample_post's conv output u (N, 16 L, H/4, W/4), read through the
//    depth-to-space index and leaky_relu'd (the ROI of full_lv3), the
//    warped HR state hw (N, L, Hr, Wr), the f32 flow (N, 2, Hr, Wr) (rounded
//    to T for the concatenation, as DCNAlign.forward does) and dcn_3's
//    upsample conv output p (N, 16 L, Hr/4, Wr/4) (its depth-to-space x 2):
//    conv1 (2L+2 -> L) -> lrelu -> conv2 (L -> L) -> lrelu -> cat(., 2 P) ->
//    conv_fuse (2L -> L) -> lrelu -> the offset (L -> 2) and mask (L -> 1)
//    heads, then off_y = mag tanh(raw_y) + flow_y, off_x = mag tanh(raw_x) +
//    flow_x and sigmoid(mask), written as kernel A's f32 offset (N, 2, Hr,
//    Wr) and mask (N, 1, Hr, Wr). Every convolution pads the ROI with zeros,
//    as the module path's ROI-sized tensors do.
//  - hr_conv_tail_kernel (H): forward_resblocks_3 (ResidualBlocksWithInputConvV2
//    with one residual block). x = lrelu(conv1(cat(roi, aligned[, hw]))) in
//    the ROI, lrelu(conv2(full_lv3)) outside it (chosen per pixel: the
//    module patches conv1's ROI result into conv2's full-frame one), then
//    x + conv2'(relu(conv1'(x))) over the frame, written as lv3 (N, L, H, W).
//    NIN (2 for v18 and v13, 3 for v15) inputs of L channels to conv1.
//
// Precision: f32 sums of T values; every intermediate that the module path
// stores is rounded to T where it does (the convolutions' outputs, each
// activation, the concatenated flow, the residual sum), so the f32 kernels
// compute the module chain in f32 (cuDNN's TF32 rounds more) and the bf16
// ones round where the bf16 module chain rounds.
//
// What bounds it on the H100: operations on the CUDA cores. A deployment
// step (4 x 1080 x 1920, L = 4) reads u, hw, the flow and p and writes the
// offsets, the mask and lv3: ~0.5 GB in bf16, ~0.17 ms at 3.35 TB/s; G
// computes 900 FMA a pixel, 0.22 ms at the f32 peak of 67 TFLOP/s (~1,200
// with its tiles' halos); H 576, 0.14 ms.
//
// Design: a block of 512 threads is a tile of th x kTW output pixels of one
// image (th the largest of 32, 24, 16, 12, 8 that fits kBudget: G 12, H 16
// at L = 4, two blocks an SM; of th 4-32 these measured the fastest). It
// stages its inputs with the chain's halo (4 pixels for G, 3 for H) in
// shared memory as f32 (common.cuh's hc_fill), then runs each stage of the
// chain over the region the next stage needs with hc_conv3x3, into shared
// memory. Only the last stage writes device memory. Buffers a later stage
// no longer reads are reused (G's 2 P and conv_fuse's output, H's block
// conv1 output).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; 4 x 1080 x 1920, L = 4; device
// time, 20 calls replayed from a CUDA graph): G 1.60 ms bf16, 1.42 f32; H
// 0.82 / 0.75 (the module chains they replace: 6.51 / 8.55 and 4.75 / 5.10).
// 6-7x the bound. Split by removing one part at a time: the fill alone G 0.82
// / H 0.47 ms, the stages alone 0.80 / 0.47; with two blocks an SM neither
// hides the other. Tried and not kept: 256 threads a block (G 2.30, H 1.16; a
// stage's items then take two rounds); the weights as FFMA constant-bank
// operands with the input channels unrolled (128 registers and a stack: G
// 2.48, H 1.41); 4, 6 or 8 fill rows a warp in flight (G 1.67-1.86,
// spilling); tiles 96 wide (G 2.04 or more); a fill of one element a thread
// at a time with a flat index (G 2.07-2.31 at 256 threads).
#include "common.cuh"

namespace {

using namespace crfp;

// two blocks an SM also by registers (64 a thread): a build at 80 registers,
// one block an SM, measured G 2.48 ms against 1.69
constexpr int kThreads = 512;
constexpr int kTW = 64;
constexpr int kMaxSmem = 227 * 1024;
// the default tile's budget: two blocks an SM where the chain's buffers allow
constexpr int kBudget = 112 * 1024;

// Shared memory of kernel G for L channels and tile height th, in f32
// words from the base: the four stages' weights, then IN0 (conv1's inputs,
// later 2 P), A (conv1's output, later conv_fuse's) and B (conv2's output).
struct HeadSmem {
  int w1, w2, wf, wh, in0, a, b, words;
};

__host__ __device__ inline HeadSmem head_smem(int L, int th) {
  HeadSmem s;
  s.w1 = 0;
  s.w2 = s.w1 + hc_weight_words(2 * L + 2, L);
  s.wf = s.w2 + hc_weight_words(L, L);
  s.wh = s.wf + hc_weight_words(2 * L, L);
  s.in0 = s.wh + hc_weight_words(L, 3);
  s.a = s.in0 + (2 * L + 2) * hc_in_rows(th + 6) * (kTW + 8);
  s.b = s.a + L * hc_in_rows(th + 4) * (kTW + 6);
  s.words = s.b + L * hc_in_rows(th + 2) * (kTW + 4);
  return s;
}

// Shared memory of kernel H: weights of conv1, conv2 and the block's two,
// then Q (conv1's inputs, later the block conv1's output), FULL (conv2's
// input) and X.
struct TailSmem {
  int w1, w2, wa, wb, q, full, x, words;
};

__host__ __device__ inline TailSmem tail_smem(int L, int nin, int th) {
  TailSmem s;
  s.w1 = 0;
  s.w2 = s.w1 + hc_weight_words(nin * L, L);
  s.wa = s.w2 + hc_weight_words(L, L);
  s.wb = s.wa + hc_weight_words(L, L);
  s.q = s.wb + hc_weight_words(L, L);
  const int plane0 = hc_in_rows(th + 4) * (kTW + 6);
  s.full = s.q + nin * L * plane0;
  s.x = s.full + L * plane0;
  s.words = s.x + L * hc_in_rows(th + 2) * (kTW + 4);
  return s;
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads, 2)
hr_conv_head_kernel(const T* __restrict__ u, const T* __restrict__ hw,
                    const float* __restrict__ flow, const T* __restrict__ p,
                    const T* __restrict__ w1, const T* __restrict__ b1,
                    const T* __restrict__ w2, const T* __restrict__ b2,
                    const T* __restrict__ wf, const T* __restrict__ bf,
                    const T* __restrict__ wo, const T* __restrict__ bo,
                    const T* __restrict__ wm, const T* __restrict__ bm,
                    float* __restrict__ off, float* __restrict__ mask,
                    int hq, int wq, int Hr, int Wr, int th, float mag) {
  extern __shared__ __align__(16) float sm[];
  const HeadSmem s = head_smem(L, th);
  const int n = blockIdx.z, ty0 = blockIdx.y * th, tx0 = blockIdx.x * kTW;
  constexpr int CIN = 2 * L + 2;
  hc_stage_weights(sm + s.w1, w1, b1, 0, L, CIN, hc_cpad(L));
  hc_stage_weights(sm + s.w2, w2, b2, 0, L, L, hc_cpad(L));
  hc_stage_weights(sm + s.wf, wf, bf, 0, L, 2 * L, hc_cpad(L));
  hc_stage_weights(sm + s.wh, wo, bo, 0, 2, L, hc_cpad(3));
  hc_stage_weights(sm + s.wh, wm, bm, 2, 1, L, hc_cpad(3));

  const int plane = Hr * Wr;
  auto in_roi = [&](int y, int x) { return y >= 0 && y < Hr && x >= 0 && x < Wr; };
  // this image's planes
  const T* un = u + (long long)n * 16 * L * hq * wq;
  const T* hwn = hw + (long long)n * L * plane;
  const float* fln = flow + (long long)n * 2 * plane;

  // IN0: cat(roi, hw, flow in T) over the tile and a 4-pixel halo, zero
  // outside the ROI
  float* in0 = sm + s.in0;
  constexpr int p0w = kTW + 8;
  const int p0 = hc_in_rows(th + 6) * p0w, r0 = th + 8;
  hc_fill<p0w>(in0, CIN, r0, p0, [&](int c, int r, int col) {
    const int y = ty0 - 4 + r, x = tx0 - 4 + col;
    if (!in_roi(y, x)) return 0.f;
    if (c < L) return hc_lrelu<T>(hc_d2s4(un, c, y, x, hq, wq));
    if (c < 2 * L) return load_f(hwn + (c - L) * plane + y * Wr + x);
    return hc_round<T>(__ldg(fln + (c - 2 * L) * plane + y * Wr + x));
  });
  __syncthreads();

  // conv1 -> lrelu over the tile and a 3-pixel halo, into A
  float* A = sm + s.a;
  constexpr int paw = kTW + 6;
  const int pa = hc_in_rows(th + 4) * paw;
  {
    const int oh = th + 6;
    hc_conv3x3<CIN, 0, L>(in0, p0, in0, 0, p0w, sm + s.w1, oh, paw,
                          [&](int x, int y0, const auto& acc) {
#pragma unroll
                            for (int q = 0; q < kHcRows; ++q) {
                              if (y0 + q >= oh) break;
                              const bool in = in_roi(ty0 - 3 + y0 + q, tx0 - 3 + x);
#pragma unroll
                              for (int co = 0; co < L; ++co)
                                A[co * pa + (y0 + q) * paw + x] =
                                    in ? hc_lrelu<T>(hc_round<T>(acc[co][q])) : 0.f;
                            }
                          });
  }
  __syncthreads();

  // conv2 -> lrelu over a 2-pixel halo, into B; meanwhile 2 P into IN0's space
  float* B = sm + s.b;
  float* P2 = in0;
  constexpr int pbw = kTW + 4;
  const int pb = hc_in_rows(th + 2) * pbw;
  {
    const int oh = th + 4;
    const int hp = Hr >> 2, wp = Wr >> 2;
    const T* pn = p + (long long)n * 16 * L * hp * wp;
    hc_fill<pbw>(P2, L, oh, pb, [&](int c, int r, int col) {
      const int y = ty0 - 2 + r, x = tx0 - 2 + col;
      return in_roi(y, x) ? hc_d2s4(pn, c, y, x, hp, wp) * 2.f : 0.f;
    });
    hc_conv3x3<L, 0, L>(A, pa, A, 0, paw, sm + s.w2, oh, pbw,
                        [&](int x, int y0, const auto& acc) {
#pragma unroll
                          for (int q = 0; q < kHcRows; ++q) {
                            if (y0 + q >= oh) break;
                            const bool in = in_roi(ty0 - 2 + y0 + q, tx0 - 2 + x);
#pragma unroll
                            for (int co = 0; co < L; ++co)
                              B[co * pb + (y0 + q) * pbw + x] =
                                  in ? hc_lrelu<T>(hc_round<T>(acc[co][q])) : 0.f;
                          }
                        });
  }
  __syncthreads();

  // conv_fuse over cat(B, 2 P) -> lrelu over a 1-pixel halo, into A's space
  float* Fu = A;
  constexpr int pfw = kTW + 2;
  const int pf = hc_in_rows(th) * pfw;
  {
    const int oh = th + 2;
    hc_conv3x3<L, L, L>(B, pb, P2, pb, pbw, sm + s.wf, oh, pfw,
                        [&](int x, int y0, const auto& acc) {
#pragma unroll
                          for (int q = 0; q < kHcRows; ++q) {
                            if (y0 + q >= oh) break;
                            const bool in = in_roi(ty0 - 1 + y0 + q, tx0 - 1 + x);
#pragma unroll
                            for (int co = 0; co < L; ++co)
                              Fu[co * pf + (y0 + q) * pfw + x] =
                                  in ? hc_lrelu<T>(hc_round<T>(acc[co][q])) : 0.f;
                          }
                        });
  }
  __syncthreads();

  // the heads over the tile: offsets and mask as kernel A takes them
  hc_conv3x3<L, 0, 3>(Fu, pf, Fu, 0, pfw, sm + s.wh, th, kTW,
                      [&](int x, int y0, const auto& acc) {
                        const int xx = tx0 + x;
#pragma unroll
                        for (int q = 0; q < kHcRows; ++q) {
                          const int y = ty0 + y0 + q;
                          if (y0 + q >= th || !in_roi(y, xx)) continue;
                          const int o = y * Wr + xx;
                          const float ry = hc_round<T>(acc[0][q]), rx = hc_round<T>(acc[1][q]);
                          const float rm = hc_round<T>(acc[2][q]);
                          float* of = off + (long long)n * 2 * plane;
                          of[o] = __fadd_rn(__fmul_rn(mag, tanhf(ry)), __ldg(fln + plane + o));
                          of[plane + o] = __fadd_rn(__fmul_rn(mag, tanhf(rx)), __ldg(fln + o));
                          mask[(long long)n * plane + o] =
                              __fdiv_rn(1.f, __fadd_rn(1.f, expf(-rm)));
                        }
                      });
}

template <typename T, int L, int NIN>
__global__ void __launch_bounds__(kThreads, 2)
hr_conv_tail_kernel(const T* __restrict__ u, const T* __restrict__ aligned,
                    const T* __restrict__ hw, const T* __restrict__ w1,
                    const T* __restrict__ b1, const T* __restrict__ w2,
                    const T* __restrict__ b2, const T* __restrict__ wa,
                    const T* __restrict__ ba, const T* __restrict__ wb,
                    const T* __restrict__ bb, T* __restrict__ out, int hq, int wq, int Hr,
                    int Wr, int th) {
  extern __shared__ __align__(16) float sm[];
  const TailSmem s = tail_smem(L, NIN, th);
  const int n = blockIdx.z, ty0 = blockIdx.y * th, tx0 = blockIdx.x * kTW;
  const int H = 4 * hq, W = 4 * wq;
  hc_stage_weights(sm + s.w1, w1, b1, 0, L, NIN * L, hc_cpad(L));
  if (w2 != nullptr) hc_stage_weights(sm + s.w2, w2, b2, 0, L, L, hc_cpad(L));
  hc_stage_weights(sm + s.wa, wa, ba, 0, L, L, hc_cpad(L));
  hc_stage_weights(sm + s.wb, wb, bb, 0, L, L, hc_cpad(L));

  auto in_roi = [&](int y, int x) { return y >= 0 && y < Hr && x >= 0 && x < Wr; };
  auto in_frame = [&](int y, int x) { return y >= 0 && y < H && x >= 0 && x < W; };
  // x's region (the tile and a 2-pixel halo) against the ROI: conv1 where
  // it meets the ROI, conv2 where it meets the frame outside the ROI
  const int ry0 = ty0 - 2, rx0 = tx0 - 2, ry1 = ty0 + th + 2, rx1 = tx0 + kTW + 2;
  const bool need_roi = ry0 < Hr && rx0 < Wr;
  const bool need_full = (ry1 > Hr && Hr < H) || (rx1 > Wr && Wr < W);

  // Q: cat(roi, aligned[, hw]), zero outside the ROI; FULL: full_lv3, zero
  // outside the frame; both over the tile and a 3-pixel halo
  float* Q = sm + s.q;
  float* FULL = sm + s.full;
  constexpr int p0w = kTW + 6;
  const int p0 = hc_in_rows(th + 4) * p0w, r0 = th + 6;
  const int plane = Hr * Wr;
  // this image's planes
  const T* un = u + (long long)n * 16 * L * hq * wq;
  const T* an = aligned + (long long)n * L * plane;
  const T* hwn = NIN == 3 ? hw + (long long)n * L * plane : nullptr;
  if (need_roi) {
    hc_fill<p0w>(Q, NIN * L, r0, p0, [&](int c, int r, int col) {
      const int y = ty0 - 3 + r, x = tx0 - 3 + col;
      if (!in_roi(y, x)) return 0.f;
      if (c < L) return hc_lrelu<T>(hc_d2s4(un, c, y, x, hq, wq));
      const T* src = c < 2 * L ? an + (c - L) * plane : hwn + (c - 2 * L) * plane;
      return load_f(src + y * Wr + x);
    });
  }
  if (need_full) {
    hc_fill<p0w>(FULL, L, r0, p0, [&](int c, int r, int col) {
      const int y = ty0 - 3 + r, x = tx0 - 3 + col;
      return in_frame(y, x) ? hc_lrelu<T>(hc_d2s4(un, c, y, x, hq, wq)) : 0.f;
    });
  }
  __syncthreads();

  // x = lrelu(conv1 in the ROI, conv2 outside it) over a 2-pixel halo; the
  // same thread writes a pixel in both passes
  float* X = sm + s.x;
  constexpr int pxw = kTW + 4;
  const int px = hc_in_rows(th + 2) * pxw, ohx = th + 4;
  if (need_roi) {
    hc_conv3x3<NIN * L, 0, L>(Q, p0, Q, 0, p0w, sm + s.w1, ohx, pxw,
                              [&](int x, int y0, const auto& acc) {
#pragma unroll
                                for (int q = 0; q < kHcRows; ++q) {
                                  if (y0 + q >= ohx) break;
                                  const bool in = in_roi(ry0 + y0 + q, rx0 + x);
#pragma unroll
                                  for (int co = 0; co < L; ++co)
                                    X[co * px + (y0 + q) * pxw + x] =
                                        in ? hc_lrelu<T>(hc_round<T>(acc[co][q])) : 0.f;
                                }
                              });
  }
  if (need_full) {
    hc_conv3x3<L, 0, L>(FULL, p0, FULL, 0, p0w, sm + s.w2, ohx, pxw,
                        [&](int x, int y0, const auto& acc) {
#pragma unroll
                          for (int q = 0; q < kHcRows; ++q) {
                            if (y0 + q >= ohx) break;
                            const int y = ry0 + y0 + q, xx = rx0 + x;
                            if (in_roi(y, xx)) continue;
                            const bool in = in_frame(y, xx);
#pragma unroll
                            for (int co = 0; co < L; ++co)
                              X[co * px + (y0 + q) * pxw + x] =
                                  in ? hc_lrelu<T>(hc_round<T>(acc[co][q])) : 0.f;
                          }
                        });
  }
  __syncthreads();

  // the block's conv1 -> relu over a 1-pixel halo, into Q's space
  float* Y = Q;
  constexpr int pyw = kTW + 2;
  const int py = hc_in_rows(th) * pyw, ohy = th + 2;
  hc_conv3x3<L, 0, L>(X, px, X, 0, pxw, sm + s.wa, ohy, pyw,
                      [&](int x, int y0, const auto& acc) {
#pragma unroll
                        for (int q = 0; q < kHcRows; ++q) {
                          if (y0 + q >= ohy) break;
                          const bool in = in_frame(ty0 - 1 + y0 + q, tx0 - 1 + x);
#pragma unroll
                          for (int co = 0; co < L; ++co)
                            Y[co * py + (y0 + q) * pyw + x] =
                                in ? fmaxf(hc_round<T>(acc[co][q]), 0.f) : 0.f;
                        }
                      });
  __syncthreads();

  // lv3 = x + the block's conv2 over the tile
  const long long fplane = (long long)H * W;
  hc_conv3x3<L, 0, L>(Y, py, Y, 0, pyw, sm + s.wb, th, kTW,
                      [&](int x, int y0, const auto& acc) {
                        const int xx = tx0 + x;
#pragma unroll
                        for (int q = 0; q < kHcRows; ++q) {
                          const int y = ty0 + y0 + q;
                          if (y0 + q >= th || !in_frame(y, xx)) continue;
#pragma unroll
                          for (int co = 0; co < L; ++co) {
                            const float r = hc_round<T>(acc[co][q]);
                            out[((long long)n * L + co) * fplane + (long long)y * W + xx] =
                                store_f<T>(X[co * px + (y0 + q + 2) * pxw + x + 2] + r);
                          }
                        }
                      });
}

// the tile height: the largest of 32, 24, 16, 12, 8 whose shared memory
// fits kBudget, else 4
template <typename F>
int pick_th(F words) {
  constexpr int kHeights[] = {32, 24, 16, 12, 8};
  for (int t : kHeights)
    if (words(t) * 4 <= kBudget) return t;
  return 4;
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int L>
cudaError_t launch_head(const void* u, const void* hw, const float* flow, const void* p,
                        const void* const* w, float* off, float* mask, int N, int hq, int wq,
                        int Hr, int Wr, float mag, cudaStream_t st) {
  const int th = pick_th([](int t) { return head_smem(L, t).words; });
  const int smem = head_smem(L, th).words * 4;
  auto kernel = hr_conv_head_kernel<T, L>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const T* const* wt = reinterpret_cast<const T* const*>(w);
  dim3 grid((unsigned)((Wr + kTW - 1) / kTW), (unsigned)((Hr + th - 1) / th), (unsigned)N);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(u), static_cast<const T*>(hw), flow,
                                       static_cast<const T*>(p), wt[0], wt[1], wt[2], wt[3],
                                       wt[4], wt[5], wt[6], wt[7], wt[8], wt[9], off, mask, hq,
                                       wq, Hr, Wr, th, mag);
  return cudaGetLastError();
}

template <typename T, int L, int NIN>
cudaError_t launch_tail(const void* u, const void* aligned, const void* hw,
                        const void* const* w, void* out, int N, int hq, int wq, int Hr, int Wr,
                        cudaStream_t st) {
  const int th = pick_th([](int t) { return tail_smem(L, NIN, t).words; });
  const int smem = tail_smem(L, NIN, th).words * 4;
  auto kernel = hr_conv_tail_kernel<T, L, NIN>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const T* const* wt = reinterpret_cast<const T* const*>(w);
  const int H = 4 * hq, W = 4 * wq;
  dim3 grid((unsigned)((W + kTW - 1) / kTW), (unsigned)((H + th - 1) / th), (unsigned)N);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(u), static_cast<const T*>(aligned),
                                       static_cast<const T*>(hw), wt[0], wt[1], wt[2], wt[3],
                                       wt[4], wt[5], wt[6], wt[7], static_cast<T*>(out), hq, wq,
                                       Hr, Wr, th);
  return cudaGetLastError();
}

template <typename T>
cudaError_t head_by_width(int L, const void* u, const void* hw, const float* flow, const void* p,
                          const void* const* w, float* off, float* mask, int N, int hq, int wq,
                          int Hr, int Wr, float mag, cudaStream_t st) {
  switch (L) {
    case 2: return launch_head<T, 2>(u, hw, flow, p, w, off, mask, N, hq, wq, Hr, Wr, mag, st);
    case 3: return launch_head<T, 3>(u, hw, flow, p, w, off, mask, N, hq, wq, Hr, Wr, mag, st);
    case 4: return launch_head<T, 4>(u, hw, flow, p, w, off, mask, N, hq, wq, Hr, Wr, mag, st);
    case 8: return launch_head<T, 8>(u, hw, flow, p, w, off, mask, N, hq, wq, Hr, Wr, mag, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int NIN>
cudaError_t tail_by_width(int L, const void* u, const void* aligned, const void* hw,
                          const void* const* w, void* out, int N, int hq, int wq, int Hr, int Wr,
                          cudaStream_t st) {
  switch (L) {
    case 2: return launch_tail<T, 2, NIN>(u, aligned, hw, w, out, N, hq, wq, Hr, Wr, st);
    case 3: return launch_tail<T, 3, NIN>(u, aligned, hw, w, out, N, hq, wq, Hr, Wr, st);
    case 4: return launch_tail<T, 4, NIN>(u, aligned, hw, w, out, N, hq, wq, Hr, Wr, st);
    case 8: return launch_tail<T, 8, NIN>(u, aligned, hw, w, out, N, hq, wq, Hr, Wr, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t tail_by_inputs(int L, int nin, const void* u, const void* aligned, const void* hw,
                           const void* const* w, void* out, int N, int hq, int wq, int Hr, int Wr,
                           cudaStream_t st) {
  if (nin == 2) return tail_by_width<T, 2>(L, u, aligned, hw, w, out, N, hq, wq, Hr, Wr, st);
  if (nin == 3) return tail_by_width<T, 3>(L, u, aligned, hw, w, out, N, hq, wq, Hr, Wr, st);
  return cudaErrorInvalidValue;
}

}  // namespace

CRFP_EXPORT_ERROR_STRING

// Kernel G. u (N, 16 L, hq, wq), hw (N, L, Hr, Wr), p (N, 16 L, Hr/4, Wr/4)
// and the weights in one type (is_bf16), flow f32 (N, 2, Hr, Wr); w: conv1,
// conv2, conv_fuse, the offset head and the mask head as (weight, bias)
// pairs, 10 pointers; off (N, 2, Hr, Wr) and mask (N, 1, Hr, Wr) f32 out.
// L in 2, 3, 4, 8.
extern "C" int crfp_hr_conv_head(const void* u, const void* hw, const void* flow,
                                 const void* p, const void* w1, const void* b1, const void* w2,
                                 const void* b2, const void* wf, const void* bf, const void* wo,
                                 const void* bo, const void* wm, const void* bm, void* off,
                                 void* mask, int N, int L, int hq, int wq, int Hr, int Wr,
                                 float mag, int is_bf16, void* stream) {
  const void* w[10] = {w1, b1, w2, b2, wf, bf, wo, bo, wm, bm};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fl = static_cast<const float*>(flow);
  float* o = static_cast<float*>(off);
  float* m = static_cast<float*>(mask);
  return (int)(is_bf16 ? head_by_width<__nv_bfloat16>(L, u, hw, fl, p, w, o, m, N, hq, wq, Hr,
                                                      Wr, mag, s)
                       : head_by_width<float>(L, u, hw, fl, p, w, o, m, N, hq, wq, Hr, Wr, mag,
                                              s));
}

// Kernel H. u (N, 16 L, hq, wq), aligned and hw (v15's third input; NULL
// with nin 2) (N, L, Hr, Wr), the weights (conv1, conv2 (NULL where the ROI
// is the frame), the block's conv1 and conv2, as (weight, bias) pairs) and
// out (N, L, 4 hq, 4 wq) in one type. L in 2, 3, 4, 8; nin 2 or 3.
extern "C" int crfp_hr_conv_tail(const void* u, const void* aligned, const void* hw,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 const void* wa, const void* ba, const void* wb, const void* bb,
                                 void* out, int N, int L, int nin, int hq, int wq, int Hr, int Wr,
                                 int is_bf16, void* stream) {
  const void* w[8] = {w1, b1, w2, b2, wa, ba, wb, bb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((nin == 3) != (hw != nullptr) || (w2 == nullptr && (Hr < 4 * hq || Wr < 4 * wq)))
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? tail_by_inputs<__nv_bfloat16>(L, nin, u, aligned, hw, w, out, N, hq, wq,
                                                       Hr, Wr, s)
                       : tail_by_inputs<float>(L, nin, u, aligned, hw, w, out, N, hq, wq, Hr, Wr,
                                               s));
}
