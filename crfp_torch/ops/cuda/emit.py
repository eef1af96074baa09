"""Kernel C dispatcher: final-frame emission.

Replaces ``crfp_tpu/ops/pallas/emit.py::_emit_kernel`` (:55,
``pallas_call`` in ``depth_to_space_add_chw`` :172; entry
``emit_frame_nhwc`` :185) with ``crfp_torch/csrc/emit.cu``: the frame is
``pixel_shuffle(y, r)`` plus the bilinear upsample of the LR frame to the
output size (the model's x8 base), written NHWC in y's dtype. The TPU
kernel interleaves the r^2 phase planes with a 0/1 matrix on its matrix
unit; on Hopper each thread reads its phase directly.

Bound on the H100 at 1080p (bytes, see the source note): y (1, 3, 1080,
1920) bf16 in and the frame out move 25 MB (~7.5 us at 3.35 TB/s). The
kernel reads y and writes the frame once.
"""

from __future__ import annotations

import ctypes

import torch

from crfp_torch.ops.cuda import _build
from crfp_torch.ops.resize import resize_bilinear
from crfp_torch.ops.shuffle import pixel_shuffle

# launches of the CUDA kernel (not of the plain version)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def emit_frame_ref(y: torch.Tensor, lr: torch.Tensor, r: int = 1) -> torch.Tensor:
    """Plain version: ``pixel_shuffle(y, r) + resize_bilinear(lr)`` to the
    frame size, summed in float32, returned NHWC in y's dtype.

    y: (N, C*r*r, H/r, W/r); lr: (N, C, h, w)."""
    frame = pixel_shuffle(y, r).float() if r > 1 else y.float()
    base = resize_bilinear(lr.float(), tuple(frame.shape[-2:]))
    return (frame + base).to(y.dtype).permute(0, 2, 3, 1).contiguous()


def _check(y: torch.Tensor, lr: torch.Tensor, r: int) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"emit: y must be a CUDA tensor, got {y.device}")
    if y.dim() != 4 or lr.dim() != 4:
        raise ValueError(f"emit: y {tuple(y.shape)} and lr {tuple(lr.shape)} "
                         "must be 4-D")
    if r < 1 or y.shape[1] != lr.shape[1] * r * r or y.shape[0] != lr.shape[0]:
        raise ValueError(f"emit: y {tuple(y.shape)} is not the s2d({r}) form of "
                         f"a frame with lr's {lr.shape[1]} channels")
    if y.dtype not in (torch.float32, torch.bfloat16) or lr.dtype != y.dtype:
        raise ValueError(f"emit: y {y.dtype} and lr {lr.dtype} must share "
                         "float32 or bfloat16")
    if lr.device != y.device:
        raise ValueError(f"emit: lr on {lr.device}, y on {y.device}")
    if not (y.is_contiguous() and lr.is_contiguous()):
        raise ValueError("emit: y and lr must be contiguous")


def emit_frame(y: torch.Tensor, lr: torch.Tensor, r: int = 1) -> torch.Tensor:
    """``pixel_shuffle(y, r)`` + the bilinear base of ``lr``, as an NHWC
    frame (N, H, W, C) in y's dtype.

    CPU tensors take the plain version; CUDA tensors launch kernel C or
    raise."""
    if y.device.type == "cpu":
        return emit_frame_ref(y, lr, r)
    _check(y, lr, r)
    n, _, hs, ws = y.shape
    c, h, w = lr.shape[1:]
    big_h, big_w = hs * r, ws * r
    out = torch.empty((n, big_h, big_w, c), dtype=y.dtype, device=y.device)
    _build.launch("emit", "crfp_emit", _ARGTYPES, y.device,
                  y.data_ptr(), lr.data_ptr(), out.data_ptr(), n, c, big_h, big_w,
                  r, h, w, int(y.dtype == torch.bfloat16))
    global launches
    launches += 1
    return out
