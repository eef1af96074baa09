"""MATLAB-compatible numpy PSNR/SSIM (crfp_tpu/eval/matlab_metrics.py;
numpy and scipy only, copied).

These are the reference's offline metrics: Y-channel PSNR with the
65.738/129.057/25.064 coefficients on [0,255] images, and the
valid-cropped 11x11 Gaussian SSIM identical to MATLAB's, plus the
``calc_psnr_and_ssim`` wrapper operating on [-1,1]-ranged tensors.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage


def calc_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """img1/img2: (H, W, C) in [0, 255]. Y-channel MSE -> PSNR."""
    diff = (img1.astype(np.float64) - img2.astype(np.float64)) / 255.0
    coeffs = np.array([65.738, 129.057, 25.064]) / 256.0
    diff = (diff * coeffs).sum(axis=2)
    mse = np.mean(diff**2)
    return -10 * math.log10(mse)


def _gaussian_window_2d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    # cv2.getGaussianKernel parity
    half = (size - 1) / 2
    g = np.exp(-(((np.arange(size) - half) ** 2) / (2 * sigma**2)))
    g = g / g.sum()
    return np.outer(g, g)


def _ssim_plane(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window_2d()

    def filt(x):
        # cv2.filter2D correlate with reflect border, then valid crop [5:-5]
        return ndimage.correlate(x, window, mode="reflect")[5:-5, 5:-5]

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    s1 = filt(img1**2) - mu1_sq
    s2 = filt(img2**2) - mu2_sq
    s12 = filt(img1 * img2) - mu1_mu2
    m = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(m.mean())


def calc_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """(H, W, C) in [0, 255]; MATLAB-compatible Y-channel SSIM."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    y1 = np.dot(img1, [65.738, 129.057, 25.064]) / 256.0 + 16.0
    y2 = np.dot(img2, [65.738, 129.057, 25.064]) / 256.0 + 16.0
    return _ssim_plane(y1, y2)


def calc_psnr_and_ssim(sr: np.ndarray, hr: np.ndarray) -> tuple[float, float]:
    """sr/hr: (1, H, W, C) or (H, W, C) NHWC in [-1, 1] ."""
    sr = np.asarray(sr)
    hr = np.asarray(hr)
    if sr.ndim == 4:
        sr, hr = sr[0], hr[0]
    sr = np.round((sr + 1.0) * 127.5)
    hr = np.round((hr + 1.0) * 127.5)
    h = min(sr.shape[0], hr.shape[0])
    w = min(sr.shape[1], hr.shape[1])
    sr, hr = sr[:h, :w], hr[:h, :w]
    return calc_psnr(sr, hr), calc_ssim(sr, hr)
