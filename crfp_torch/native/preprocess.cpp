// Native host-side preprocessing for the data pipeline (a copy of
// crfp_tpu/native/preprocess.cpp; the port imports nothing of the JAX
// package).
//
// The reference's data path is pure Python: PIL bicubic resizes, numpy
// crops/normalization and mask fills per frame per worker. At 15-frame
// clips x batch 8 that is the host cost of feeding the card. This library
// provides the hot host kernels in C++ with OpenMP over frames:
//
//   - resize_bicubic_u8: separable antialiased bicubic (PIL-compatible
//     a=-0.5 kernel with support scaling on downscale)
//   - crop_normalize_flip_f32: fused uint8 crop -> /255 float -> h/v flip
//   - fill_fovea_f32: fovea patch + mask fill (fovea_generator inner loop)
//
// Exposed as extern "C" for ctypes; built with g++ by
// crfp_torch/native/bindings.py into crfp_torch/build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// PIL-style bicubic kernel, a = -0.5, support = 2
inline double bicubic(double x) {
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Taps {
  std::vector<int> bounds;     // (xmin, xsize) per output pixel
  std::vector<double> coeffs;  // ksize weights per output pixel
  int ksize = 0;
};

// PIL ImagingPrecomputeCoeffs equivalent (antialias: kernel widened by the
// downscale factor), double-precision weights.
Taps precompute(int in_size, int out_size) {
  Taps t;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 2.0 * filterscale;
  t.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.bounds.resize(out_size * 2);
  t.coeffs.assign(static_cast<size_t>(out_size) * t.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &t.coeffs[static_cast<size_t>(xx) * t.ksize];
    for (int x = 0; x < xmax; ++x) {
      double w = bicubic((x + xmin - center + 0.5) / filterscale);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    t.bounds[xx * 2] = xmin;
    t.bounds[xx * 2 + 1] = xmax;
  }
  return t;
}

inline uint8_t clip8(double v) {
  if (v <= 0.0) return 0;
  if (v >= 255.0) return 255;
  return static_cast<uint8_t>(v + 0.5);
}

}  // namespace

extern "C" {

// src: (T, sh, sw, c) uint8; dst: (T, dh, dw, c) uint8
void resize_bicubic_u8(const uint8_t* src, int t, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw, int nthreads) {
  Taps h_taps = precompute(sw, dw);
  Taps v_taps = precompute(sh, dh);
  if (nthreads < 1) nthreads = 1;

#pragma omp parallel for schedule(static) num_threads(nthreads)
  for (int f = 0; f < t; ++f) {
    const uint8_t* sp = src + static_cast<size_t>(f) * sh * sw * c;
    uint8_t* dp = dst + static_cast<size_t>(f) * dh * dw * c;
    // horizontal pass into a uint8 temp — PIL's 8bpc pipeline clips the
    // intermediate to bytes between passes (bicubic under/overshoot is
    // saturated mid-pipeline), and byte-parity with the reference's PIL
    // loader requires reproducing that
    std::vector<uint8_t> tmp(static_cast<size_t>(sh) * dw * c);
    for (int y = 0; y < sh; ++y) {
      for (int x = 0; x < dw; ++x) {
        int xmin = h_taps.bounds[x * 2];
        int xmax = h_taps.bounds[x * 2 + 1];
        const double* k = &h_taps.coeffs[static_cast<size_t>(x) * h_taps.ksize];
        for (int ch = 0; ch < c; ++ch) {
          double acc = 0.0;
          for (int i = 0; i < xmax; ++i)
            acc += sp[(static_cast<size_t>(y) * sw + xmin + i) * c + ch] * k[i];
          tmp[(static_cast<size_t>(y) * dw + x) * c + ch] = clip8(acc);
        }
      }
    }
    // vertical pass
    for (int y = 0; y < dh; ++y) {
      int ymin = v_taps.bounds[y * 2];
      int ymax = v_taps.bounds[y * 2 + 1];
      const double* k = &v_taps.coeffs[static_cast<size_t>(y) * v_taps.ksize];
      for (int x = 0; x < dw; ++x) {
        for (int ch = 0; ch < c; ++ch) {
          double acc = 0.0;
          for (int i = 0; i < ymax; ++i)
            acc += tmp[(static_cast<size_t>(ymin + i) * dw + x) * c + ch] * k[i];
          dp[(static_cast<size_t>(y) * dw + x) * c + ch] = clip8(acc);
        }
      }
    }
  }
}

// src: (T, H, W, C) uint8 -> dst: (T, ch_, cw, C) float32 in [0,1],
// cropped at (y0, x0), optionally flipped.
void crop_normalize_flip_f32(const uint8_t* src, int t, int h, int w, int c,
                             float* dst, int y0, int x0, int ch_, int cw,
                             int hflip, int vflip, int nthreads) {
  const float inv = 1.0f / 255.0f;
  if (nthreads < 1) nthreads = 1;
#pragma omp parallel for schedule(static) num_threads(nthreads)
  for (int f = 0; f < t; ++f) {
    const uint8_t* sp = src + static_cast<size_t>(f) * h * w * c;
    float* dp = dst + static_cast<size_t>(f) * ch_ * cw * c;
    for (int y = 0; y < ch_; ++y) {
      int sy = y0 + (vflip ? (ch_ - 1 - y) : y);
      for (int x = 0; x < cw; ++x) {
        int sx = x0 + (hflip ? (cw - 1 - x) : x);
        const uint8_t* s = sp + (static_cast<size_t>(sy) * w + sx) * c;
        float* d = dp + (static_cast<size_t>(y) * cw + x) * c;
        for (int k = 0; k < c; ++k) d[k] = s[k] * inv;
      }
    }
  }
}

// gt: (T, H, W, C) float32; fv/mask outputs same layout (mask C=1).
// coords: (T, 2) int32 top-left (y, x); fovea window fh x fw.
void fill_fovea_f32(const float* gt, int t, int h, int w, int c,
                    const int32_t* coords, int fh, int fw, float* fv,
                    float* mask, int nthreads) {
  std::memset(fv, 0, sizeof(float) * static_cast<size_t>(t) * h * w * c);
  std::memset(mask, 0, sizeof(float) * static_cast<size_t>(t) * h * w);
  if (nthreads < 1) nthreads = 1;
#pragma omp parallel for schedule(static) num_threads(nthreads)
  for (int f = 0; f < t; ++f) {
    int y0 = std::max(coords[f * 2], 0);
    int x0 = std::max(coords[f * 2 + 1], 0);
    int y1 = std::min(coords[f * 2] + fh, h);
    int x1 = std::min(coords[f * 2 + 1] + fw, w);
    const float* gp = gt + static_cast<size_t>(f) * h * w * c;
    float* fp = fv + static_cast<size_t>(f) * h * w * c;
    float* mp = mask + static_cast<size_t>(f) * h * w;
    for (int y = y0; y < y1; ++y) {
      std::memcpy(fp + (static_cast<size_t>(y) * w + x0) * c,
                  gp + (static_cast<size_t>(y) * w + x0) * c,
                  sizeof(float) * static_cast<size_t>(x1 - x0) * c);
      for (int x = x0; x < x1; ++x) mp[static_cast<size_t>(y) * w + x] = 1.0f;
    }
  }
}

}  // extern "C"
