"""Kernel A and D dispatcher: windowed modulated deformable conv, forward
and backward.

Forward: replaces ``crfp_tpu/ops/pallas/dcn.py::_dcn_kernel`` (:59,
``pallas_call`` in ``_fwd_call`` :493; entries ``deform_conv2d_pallas`` :716
and ``deform_conv2d_pallas_vjp`` :1359) with ``crfp_torch/csrc/dcn_fwd.cu``.
The TPU kernel builds 2-sparse interpolation matrices per window so that
its matrix unit does the gathers; Hopper gathers natively, so the CUDA
kernel samples directly and contracts with the weight in registers. The
corner sampling, the window clamp and the weight tile in shared memory are
device code in ``crfp_torch/csrc/common.cuh``, which kernel E
(``csrc/dcn_fused.cu``, ``ops/cuda/dcn_fused.py``) includes too.

Backward: replaces ``_dcn_bwd_kernel`` (:219, ``pallas_call`` in
``_bwd_call`` :593, reached through ``deform_conv2d_pallas_vjp``'s custom
VJP :1412-1418) with ``crfp_torch/csrc/dcn_bwd.cu``, behind a
``torch.autograd.Function``: dx, d-offset, d-mask and dW from the kernel,
db as a reduction of the output gradient (the TPU adds it outside the
kernel body too, :1139). The Function survives recomputation under
``torch.utils.checkpoint(use_reentrant=False)``; it has no second
derivative.

Bound on the H100 at the main-path shapes (bytes, see the source notes):
per-tap dcn_0/1/2 at (1, 32, 180, 180) bf16 with f32 offsets and masks
moves 32 MB forward (~9.6 us at 3.35 TB/s); shared-tap dcn_3 at (1, 4,
720, 720) 14.5 MB (~4.3 us). At the training shapes (B 2, GT 192) the
backward moves 8.8 MB per per-tap call and 3.5 MB per dcn_3 call.

Layouts are those of :func:`crfp_torch.ops.dcn_windowed.deform_conv2d_windowed_ref`.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from crfp_torch.ops.cuda import _build
from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

# launches of the CUDA kernels (not of the plain version): A forward, D backward
launches = 0
bwd_launches = 0

# the instantiations of csrc/dcn_fwd.cu and dcn_bwd.cu: dcn_3 (4) and
# dcn_0/1/2 (32) at mid 32
SUPPORTED_OUT_CHANNELS = (4, 32)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float] + \
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


def _forward(x, offset, mask, weight, bias, max_displacement, shared_taps,
             shared_mask) -> torch.Tensor:
    g = _check(x, offset, mask, weight, bias, shared_taps, shared_mask)
    n, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    out = torch.empty((n, o, h, w), dtype=x.dtype, device=x.device)
    _build.launch("dcn_fwd", "crfp_dcn_fwd", _ARGTYPES, x.device,
                  x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  n, c, h, w, o, g, kh, kw, _build.window(max_displacement),
                  int(shared_taps), int(shared_mask), int(x.dtype == torch.bfloat16))
    global launches
    launches += 1
    return out


def dcn_backward(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    max_displacement: int | None = None,
    shared_taps: bool = False,
    shared_mask: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel D for the DCN stages: (dx in x's dtype, d-offset, d-mask, dW
    float32) of :func:`deform_conv2d_windowed` for the output gradient
    ``grad_out`` (N, O, H, W) in x's dtype. CUDA tensors only."""
    g = _check(x, offset, mask, weight, None, shared_taps, shared_mask)
    n, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    if grad_out.shape != (n, o, h, w) or grad_out.dtype != x.dtype \
            or grad_out.device != x.device or not grad_out.is_contiguous():
        raise ValueError(f"dcn_bwd: grad_out {tuple(grad_out.shape)} {grad_out.dtype} "
                         f"must be a contiguous {(n, o, h, w)} {x.dtype} on {x.device}")
    dx = torch.zeros((n, c, h, w), dtype=torch.float32, device=x.device)
    d_off = torch.empty_like(offset)
    d_mask = torch.empty_like(mask)
    dw = torch.zeros_like(weight)
    _build.launch("dcn_bwd", "crfp_dcn_bwd", _BWD_ARGTYPES, x.device,
                  x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                  grad_out.data_ptr(), dx.data_ptr(), d_off.data_ptr(),
                  d_mask.data_ptr(), dw.data_ptr(),
                  n, c, h, w, o, g, kh, kw, _build.window(max_displacement),
                  int(shared_taps), int(shared_mask), int(x.dtype == torch.bfloat16))
    global bwd_launches
    bwd_launches += 1
    return dx.to(x.dtype), d_off, d_mask, dw


class _DeformConv2dWindowed(torch.autograd.Function):
    """Kernel A forward, kernel D backward; db is the sum of the output
    gradient over (N, H, W)."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, max_displacement,
                shared_taps, shared_mask):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.kw = dict(max_displacement=max_displacement, shared_taps=shared_taps,
                      shared_mask=shared_mask)
        ctx.has_bias = bias is not None
        return _forward(x, offset, mask, weight, bias, max_displacement,
                        shared_taps, shared_mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        grad_out = grad_out.to(x.dtype).contiguous()
        dx, d_off, d_mask, dw = dcn_backward(x, offset, mask, weight, grad_out,
                                             **ctx.kw)
        db = grad_out.float().sum((0, 2, 3)) if ctx.has_bias else None
        return dx, d_off, d_mask, dw, db, None, None, None


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
    """Windowed DCNv2, NCHW; (N, O, H, W) in x's dtype; differentiable in
    x, offset, mask, weight and bias.

    CPU tensors take the plain version (autograd of plain PyTorch); CUDA
    tensors launch kernel A forward and kernel D backward (x float32 or
    bfloat16, offset/mask/weight/bias float32, f32 accumulation) or
    raise."""
    if x.device.type == "cpu":
        return deform_conv2d_windowed_ref(
            x, offset, mask, weight, bias, max_displacement=max_displacement,
            shared_taps=shared_taps, shared_mask=shared_mask)
    return _DeformConv2dWindowed.apply(x, offset, mask, weight, bias,
                                       max_displacement, shared_taps, shared_mask)
