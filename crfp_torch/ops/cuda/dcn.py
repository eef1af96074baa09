"""Kernel A dispatcher: windowed modulated deformable conv forward.

Replaces ``crfp_tpu/ops/pallas/dcn.py::_dcn_kernel`` (:59, ``pallas_call``
in ``_fwd_call`` :493; entries ``deform_conv2d_pallas`` :716 and
``deform_conv2d_pallas_vjp`` :1359) with ``crfp_torch/csrc/dcn_fwd.cu``.
The TPU kernel builds 2-sparse interpolation matrices per window so that
its matrix unit does the gathers; Hopper gathers natively, so the CUDA
kernel samples directly and contracts with the weight in registers.

Bound on the H100 at the main-path shapes (bytes, see the source note):
per-tap dcn_0/1/2 at (1, 32, 180, 180) bf16 with f32 offsets and masks
moves 32 MB (~9.6 us at 3.35 TB/s); shared-tap dcn_3 at (1, 4, 720, 720)
moves 14.5 MB (~4.3 us). The design reads every offset, mask and output
once, coalesced, and keeps the weight in shared memory.

Layouts are those of :func:`crfp_torch.ops.dcn_windowed.deform_conv2d_windowed_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from crfp_torch.ops.cuda import _build
from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

# launches of the CUDA kernel (not of the plain version)
launches = 0

# the instantiations of csrc/dcn_fwd.cu: dcn_3 (4) and dcn_0/1/2 (32) at mid 32
SUPPORTED_OUT_CHANNELS = (4, 32)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(x, offset, mask, weight, bias, shared_taps, shared_mask) -> int:
    """Validate the kernel's operands; returns the group count G."""
    if x.device.type != "cuda":
        raise ValueError(f"dcn_fwd: x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"dcn_fwd: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} must be 4-D")
    n, c, h, w = x.shape
    o, wc, kh, kw = weight.shape
    k2 = kh * kw
    taps = 1 if shared_taps else k2
    mtaps = 1 if shared_mask else k2
    if wc != c or o not in SUPPORTED_OUT_CHANNELS:
        raise ValueError(f"dcn_fwd: weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)} (O must be one of {SUPPORTED_OUT_CHANNELS})")
    g = offset.shape[1] // (2 * taps) if offset.dim() == 4 else 0
    if g < 1 or c % g or offset.shape != (n, g * taps * 2, h, w):
        raise ValueError(f"dcn_fwd: offset {tuple(offset.shape)} does not fit x "
                         f"{tuple(x.shape)} with {taps} tap(s) per group")
    if mask.shape != (n, g * mtaps, h, w):
        raise ValueError(f"dcn_fwd: mask {tuple(mask.shape)} != {(n, g * mtaps, h, w)}")
    if bias is not None and bias.shape != (o,):
        raise ValueError(f"dcn_fwd: bias {tuple(bias.shape)} != ({o},)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dcn_fwd: x dtype {x.dtype} (float32 or bfloat16)")
    for name, t in (("offset", offset), ("mask", mask), ("weight", weight),
                    ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"dcn_fwd: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"dcn_fwd: {name} on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("offset", offset), ("mask", mask),
                    ("weight", weight), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"dcn_fwd: {name} must be contiguous")
    return g


def deform_conv2d_windowed(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    max_displacement: int | None = None,
    shared_taps: bool = False,
    shared_mask: bool = False,
) -> torch.Tensor:
    """Windowed DCNv2 forward, NCHW; (N, O, H, W) in x's dtype.

    CPU tensors take the plain version; CUDA tensors launch kernel A
    (x float32 or bfloat16, offset/mask/weight/bias float32, f32
    accumulation) or raise."""
    if x.device.type == "cpu":
        return deform_conv2d_windowed_ref(
            x, offset, mask, weight, bias, max_displacement=max_displacement,
            shared_taps=shared_taps, shared_mask=shared_mask)
    g = _check(x, offset, mask, weight, bias, shared_taps, shared_mask)
    n, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    out = torch.empty((n, o, h, w), dtype=x.dtype, device=x.device)
    fn = _build.function("dcn_fwd", "crfp_dcn_fwd", _ARGTYPES)
    d = -1.0 if max_displacement is None else float(max_displacement)
    with torch.cuda.device(x.device):
        rc = fn(_build.ptr(x), _build.ptr(offset), _build.ptr(mask),
                _build.ptr(weight), _build.ptr(bias), _build.ptr(out),
                n, c, h, w, o, g, kh, kw, d, int(shared_taps), int(shared_mask),
                int(x.dtype == torch.bfloat16), _build.stream(x.device))
    _build.check(rc, "dcn_fwd", "crfp_dcn_fwd")
    global launches
    launches += 1
    return out
