"""Kernel F dispatcher: the SSIM map.

Replaces ``crfp_tpu/ops/pallas/ssim.py::_ssim_kernel`` (:55, ``pallas_call``
in ``ssim_map_pallas`` :142) with ``crfp_torch/csrc/ssim.cu``: the five
moments under the 11x11 Gaussian window (sigma 1.5, zero 'same' padding)
over a tile staged in shared memory by ``cp.async``: a vertical pass (each
input row read once, its products formed once, a strip of output rows
summed in registers) and a horizontal pass (a run of 8 outputs a thread),
then the SSIM formula (C1 1e-4, C2 9e-4) in registers. A block walks the
C channels of its tile, so the kernel reads an NHWC image in place. Each
operand is read through its own element strides: the dispatcher takes an
NCHW-contiguous tensor, an NCHW view of NHWC memory
(``nhwc.permute(0, 3, 1, 2)``) or any other strided view, x and y each in
its own, and writes the map NCHW-contiguous. :func:`ssim_plan` mirrors the
launch geometry (64 x 16 output tiles, 8-row strips). The masked mean
stays a PyTorch reduction (``crfp_torch/ops/metrics.py``), as the TPU
computes it outside its kernel too (``ssim.py:165-169``). Forward only: a
metric.

Bound on the H100 (bytes and f32 operations, see the source note): the
training step's two calls on (14, 3, 192, 192) and (14, 1, 192, 192) move
24.8 MB, 7.4 us at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from crfp_torch.ops.cuda import _build
from crfp_torch.trace import span

# launches of the CUDA kernel (not of the plain version)
launches = 0

WINDOW = 11
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 8
             + [ctypes.c_void_p] * 2)
_F32 = torch.float32

# csrc/ssim.cu's tile geometry: output tile width and height, output rows
# per vertical-pass strip, outputs per thread of the horizontal pass
TILE_W, TILE_H, STRIP, RUN = 64, 16, 8, 8


@functools.lru_cache(maxsize=1)
def gaussian_1d(sigma: float = 1.5) -> tuple[float, ...]:
    """The 1-D taps, normalised in float64 and rounded to float32 (the
    reference's order, crfp_tpu/ops/metrics.py:25-34); the 2-D window is
    their outer product."""
    g = np.array([math.exp(-((x - WINDOW // 2) ** 2) / (2.0 * sigma ** 2))
                  for x in range(WINDOW)], dtype=np.float64)
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


# the taps as a C float array, built once (the C entry copies them into the
# launch's parameters)
_TAPS = (ctypes.c_float * WINDOW)(*gaussian_1d())
_TAPS_ADDRESS = ctypes.addressof(_TAPS)


def ssim_map_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version: the five moments by depthwise ``F.conv2d`` with zero
    'same' padding, the 11-tap column then the 11-tap row of the separable
    window (the order of kernel F and of the TPU kernel), then the SSIM
    formula; float32."""
    c = x.shape[1]
    g = torch.tensor(gaussian_1d(), dtype=torch.float32, device=x.device)
    wv = g.view(1, 1, WINDOW, 1).repeat(c, 1, 1, 1)
    wh = g.view(1, 1, 1, WINDOW).repeat(c, 1, 1, 1)
    x, y = x.float(), y.float()

    def conv(a):
        a = F.conv2d(a, wv, padding=(WINDOW // 2, 0), groups=c)
        return F.conv2d(a, wh, padding=(0, WINDOW // 2), groups=c)

    mu1, mu2 = conv(x), conv(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(x * x) - mu1_sq
    sigma2_sq = conv(y * y) - mu2_sq
    sigma12 = conv(x * y) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


@dataclass(frozen=True)
class SsimPlan:
    """Launch geometry of ``csrc/ssim.cu`` for one call: a block per
    (column tile, row tile, image) of ``TILE_W`` x ``TILE_H`` outputs,
    walking the image's channels. Its vertical pass has ``items`` (a halo
    column and a strip of ``STRIP`` rows each), its horizontal pass
    ``runs`` (``RUN`` outputs of a row each), and the block a thread for
    each of the more numerous."""
    items: int
    runs: int
    threads: int
    grid: tuple[int, int, int]

    def vertical_item(self, t: int) -> tuple[int, int] | None:
        """(first tile row, halo column) of the vertical-pass item of thread
        ``t``, which sums rows first .. first + STRIP - 1 of that column;
        None for a thread without one (the kernel's index math)."""
        cols = TILE_W + WINDOW - 1
        return ((t // cols) * STRIP, t % cols) if t < self.items else None

    def run(self, t: int) -> tuple[int, int]:
        """(tile row, first tile column) of the ``RUN`` outputs that thread
        ``t`` < ``runs`` forms and stores in the horizontal pass (the
        kernel's index math: a warp takes 8 rows x 4 runs)."""
        warp, lane = divmod(t, 32)
        return (warp // 2) * 8 + lane % 8, ((warp % 2) * 4 + lane // 8) * RUN


def ssim_plan(n: int, c: int, h: int, w: int) -> SsimPlan:
    """The plan of kernel F for an (n, c, h, w) call. The tile was chosen
    on the card from 64 x 16 with 8-row strips, 64 x 32 with 8 and 64 x 32
    with 16: the fastest at the gate's frame and within 4 % of the fastest
    at the training step's two calls (PERF.md, kernel F's designs)."""
    items = (TILE_W + WINDOW - 1) * (TILE_H // STRIP)
    runs = TILE_H * TILE_W // RUN
    grid = (-(-w // TILE_W), -(-h // TILE_H), n)
    return SsimPlan(items, runs, max(items, runs), grid)


def _span(t: torch.Tensor) -> int:
    """The largest element offset inside one image of an (N, C, H, W) view."""
    return sum((d - 1) * s for d, s in zip(t.shape[1:], t.stride()[1:]))


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    """Raise ``ValueError`` unless (x, y) is what kernel F takes. One pass
    for a correct caller; :func:`_reject` names the fault otherwise, the
    device last, so that every other fault is named on CPU tensors too."""
    shape = x.shape
    if not (len(shape) == 4 and y.shape == shape and x.dtype is _F32 and y.dtype is _F32
            and x.is_cuda and y.device == x.device
            and _span(x) < 2 ** 31 and _span(y) < 2 ** 31
            and not (x.requires_grad or y.requires_grad)):
        _reject(x, y)


def _reject(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 4 or y.shape != x.shape:
        raise ValueError(f"ssim: x {tuple(x.shape)} and y {tuple(y.shape)} must "
                         "share one (N, C, H, W) shape")
    if x.dtype != _F32 or y.dtype != _F32:
        raise ValueError(f"ssim: x {x.dtype} and y {y.dtype} must be float32")
    for name, t in (("x", x), ("y", y)):
        if _span(t) >= 2 ** 31:
            raise ValueError(f"ssim: {name}'s image of {tuple(t.shape[1:])} at strides "
                             f"{t.stride()[1:]} spans more than 2^31 elements")
    if x.requires_grad or y.requires_grad:
        raise ValueError("ssim: kernel F has no backward; pass detached tensors")
    if y.device != x.device:
        raise ValueError(f"ssim: y on {y.device}, x on {x.device}")
    raise ValueError(f"ssim: x must be a CUDA tensor, got {x.device}")


def ssim_map(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM map of ``x`` against ``y`` (N, C, H, W), float32, NCHW-contiguous.

    x and y are read in place, each in its own layout (NCHW-contiguous, an
    NCHW view of NHWC memory, any strided view). CPU tensors take the plain
    version; CUDA tensors launch kernel F (float32, no gradient) or raise."""
    if x.device.type == "cpu":
        return ssim_map_ref(x, y)
    global launches
    with span("crfp.kernel.F", {"x": x, "y": y}):
        _check(x, y)
        n, c, h, w = x.shape
        out = torch.empty((n, c, h, w), dtype=_F32, device=x.device)
        _build.launch("ssim", "crfp_ssim", _ARGTYPES, x.device,
                      x.data_ptr(), y.data_ptr(), out.data_ptr(), n, c, h, w,
                      *x.stride(), *y.stride(), _TAPS_ADDRESS)
        launches += 1
    return out
