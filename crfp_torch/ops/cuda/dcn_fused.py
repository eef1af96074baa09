"""Kernel E dispatcher: the per-tap windowed DCN from the raw offset and
mask head outputs, in one launch.

Replaces ``crfp_tpu/ops/pallas/dcn.py::_dcn_kernel_fusedprep`` (:1468,
``pallas_call`` :1659, entry ``deform_conv2d_pallas_fusedprep`` :1667) and
the XLA-side epilogue around it (``crfp_tpu/nn/align.py:281``, :292-296)
with ``crfp_torch/csrc/dcn_fused.cu``: ``mag * tanh(raw) + flow``, the
±window clip and the mask's sigmoid are computed per (pixel, group, tap) in
registers, then sampled and contracted by kernel A's tiled routine
(``csrc/common.cuh``, with the tile plan of
:func:`crfp_torch.ops.cuda.dcn.tile_plan`); the same offsets give the same
bits as the PyTorch prologue followed by kernel A. Inference only, like the TPU kernel: there is no
backward, and the dispatcher raises when autograd would record the call.

Bound on the H100 (bytes, see the source note): x and heads in bf16 at the
gate shape (1, 32, 180, 320) move 32.8 MB (~9.8 us at 3.35 TB/s), at the
serving shape (1, 32, 180, 180) 18.4 MB (~5.5 us).

Layouts are those of
:func:`crfp_torch.ops.dcn_windowed.deform_conv2d_fusedprep_ref`.
"""

from __future__ import annotations

import ctypes

import torch
from torch.overrides import handle_torch_function, has_torch_function

from crfp_torch.ops.cuda import _build
from crfp_torch.ops.cuda.dcn import (
    FUSED_OUT_CHANNELS,
    TilePlan,
    _plan,
    check_route,
    sm_count,
    width_route,
)
from crfp_torch.ops.dcn_windowed import deform_conv2d_fusedprep_ref
from crfp_torch.trace import span

# launches of the CUDA kernel (not of the plain version); general_launches:
# those of its general route, also in `launches`
launches = 0
general_launches = 0

# the tuned route's instantiations in csrc/dcn_fused.cu: dcn_0/1/2 at mid 16
# and mid 32; every other width takes the general route (the rule is
# ops/cuda/dcn.py::width_fault and width_route)
SUPPORTED_OUT_CHANNELS = FUSED_OUT_CHANNELS
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + \
    [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check(x, raw_offset, raw_mask, flow, weight, bias) -> int:
    """Validate the kernel's operands; returns the group count G."""
    if x.device.type != "cuda":
        raise ValueError(f"dcn_fused: x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"dcn_fused: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} must be 4-D")
    n, c, h, w = x.shape
    o, wc, kh, kw = weight.shape
    k2 = kh * kw
    if wc != c:
        raise ValueError(f"dcn_fused: weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    g = raw_offset.shape[1] // (2 * k2) if raw_offset.dim() == 4 else 0
    if g < 1 or c % g or raw_offset.shape != (n, g * k2 * 2, h, w):
        raise ValueError(f"dcn_fused: offset head {tuple(raw_offset.shape)} does not "
                         f"fit x {tuple(x.shape)} with {k2} taps per group")
    if raw_mask.shape != (n, g * k2, h, w):
        raise ValueError(f"dcn_fused: mask head {tuple(raw_mask.shape)} != "
                         f"{(n, g * k2, h, w)}")
    if flow.shape != (n, 2, h, w):
        raise ValueError(f"dcn_fused: flow {tuple(flow.shape)} != {(n, 2, h, w)}")
    if bias is not None and bias.shape != (o,):
        raise ValueError(f"dcn_fused: bias {tuple(bias.shape)} != ({o},)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dcn_fused: x dtype {x.dtype} (float32 or bfloat16)")
    for name, t in (("offset head", raw_offset), ("mask head", raw_mask)):
        if t.dtype != x.dtype:
            raise ValueError(f"dcn_fused: {name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("flow", flow), ("weight", weight), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"dcn_fused: {name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("offset head", raw_offset), ("mask head", raw_mask),
                    ("flow", flow), ("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"dcn_fused: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"dcn_fused: {name} must be contiguous")
    return g


def deform_conv2d_fusedprep(
    x: torch.Tensor,
    raw_offset: torch.Tensor,
    raw_mask: torch.Tensor,
    flow: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    max_residue_magnitude: float = 10.0,
    max_displacement: int | None = None,
    plan: TilePlan | None = None,
) -> torch.Tensor:
    """Per-tap windowed DCNv2 from the heads' raw outputs, NCHW; (N, O, H,
    W) in x's dtype. No gradient: raises if an operand requires grad while
    autograd records. ``plan``: a tile plan other than the default one
    (:func:`crfp_torch.ops.cuda.dcn.tile_plan` with ``kernel="dcn_fused"``,
    for measurements; ``route="general"`` at a tuned width).

    CPU tensors take the plain version; CUDA tensors launch kernel E (x and
    heads float32 or bfloat16 alike, flow/weight/bias float32; bf16 x at O =
    32 contracted on the tensor cores with f32 sums, f32 x and O = 16 on the
    CUDA cores, every other width on the general route) or raise.
    Overridable (``torch.overrides``), as the warp's dispatcher."""
    if has_torch_function((x, raw_offset, raw_mask, flow)):
        return handle_torch_function(
            deform_conv2d_fusedprep, (x, raw_offset, raw_mask, flow), x, raw_offset,
            raw_mask, flow, weight, bias, max_residue_magnitude=max_residue_magnitude,
            max_displacement=max_displacement, plan=plan)
    operands = (x, raw_offset, raw_mask, flow, weight, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in operands):
        raise ValueError("dcn_fused: kernel E has no backward (inference only); "
                         "call under torch.no_grad() or take the structured path")
    if x.device.type == "cpu":
        return deform_conv2d_fusedprep_ref(
            x, raw_offset, raw_mask, flow, weight, bias,
            max_residue_magnitude=max_residue_magnitude,
            max_displacement=max_displacement)
    global launches, general_launches
    with span("crfp.kernel.E", {"x": x, "weight": weight}) as s:
        g = _check(*operands)
        n, c, h, w = x.shape
        o, _, kh, kw = weight.shape
        bf16 = x.dtype == torch.bfloat16
        if plan is None:
            plan = _plan(n, c, h, w, o, g, max_displacement, bf16, False, sm_count(x.device),
                         None, width_route("dcn_fused", c, o, g, kh, kw, bf16=bf16), kh * kw)
        entry = check_route("dcn_fused", plan.route, c, g, kh, kw, o, False, bf16,
                            branch=plan.branch)
        s.note(route=plan.route, branch=plan.branch)
        out = torch.empty((n, o, h, w), dtype=x.dtype, device=x.device)
        # the pre-pass's zero-padded, pixel-major copy of x
        packed = torch.empty(plan.packed_numel(n, c, h, w), dtype=x.dtype, device=x.device)
        _build.launch("dcn_fused", entry, _ARGTYPES, x.device,
                      x.data_ptr(), raw_offset.data_ptr(), raw_mask.data_ptr(),
                      flow.data_ptr(), weight.data_ptr(),
                      None if bias is None else bias.data_ptr(), out.data_ptr(),
                      packed.data_ptr(),
                      n, c, h, w, o, g, kh, kw, _build.window(max_displacement),
                      float(max_residue_magnitude), int(bf16), *plan.args())
        launches += 1
        if plan.route == "general":
            general_launches += 1
    return out
