"""Kernel B and D (k=1) dispatcher: windowed backward flow warp, forward
and backward.

Forward: replaces ``crfp_tpu/ops/pallas/warp.py::flow_warp_windowed_pallas`` (:29)
and ``flow_warp_windowed_pallas_s2d`` (:55), which on the TPU run the DCN
kernel ``crfp_tpu/ops/pallas/dcn.py::_dcn_kernel`` (:59) at k=1 with an
identity weight, with ``crfp_torch/csrc/flow_warp.cu``: a warp kernel of
its own, since a k=1 DCN spends a C x C contraction per pixel.

Backward: replaces ``crfp_tpu/ops/pallas/dcn.py::_dcn_bwd_kernel`` (:219,
``_bwd_call`` :593) at k=1 with no mask, which is how the TPU
differentiates the windowed warp, with ``crfp_torch/csrc/flow_warp_bwd.cu``
behind a ``torch.autograd.Function``: dx and d-flow, 0 where the flow is
clamped. No second derivative.

Bound on the H100 at the main-path shapes (bytes, see the source note):
the HR state (1, 4, 720, 720) bf16 with its f32 flow moves 12.4 MB
(~3.7 us at 3.35 TB/s); the lv states (1, 24, 180, 180) 3.4 MB (~1.0 us).
One thread per (pixel, channel block) reads the flow and builds the
corner weights once for the block. At the training shapes the backward
moves 2.9 MB for the HR state (2, 4, 192, 192) and 1.0 MB for lv3_state
(2, 32, 48, 48).

Layouts: x (N, C, H, W); flow (N, 2, H, W), channels (dx, dy) in pixels.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from crfp_torch.ops.cuda import _build
from crfp_torch.ops.warp import flow_warp_windowed_ref

# launches of the CUDA kernels (not of the plain version): B forward, D backward
launches = 0
bwd_launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                          ctypes.c_int,
                                                          ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                              ctypes.c_int,
                                                              ctypes.c_void_p]


def _check(x: torch.Tensor, flow: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"flow_warp: x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"flow_warp: x {tuple(x.shape)} must be (N, C, H, W)")
    n, _, h, w = x.shape
    if flow.shape != (n, 2, h, w):
        raise ValueError(f"flow_warp: flow {tuple(flow.shape)} != {(n, 2, h, w)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flow_warp: x dtype {x.dtype} (float32 or bfloat16)")
    if flow.dtype != torch.float32:
        raise ValueError(f"flow_warp: flow must be float32, got {flow.dtype}")
    if flow.device != x.device:
        raise ValueError(f"flow_warp: flow on {flow.device}, x on {x.device}")
    if not (x.is_contiguous() and flow.is_contiguous()):
        raise ValueError("flow_warp: x and flow must be contiguous")


def _forward(x: torch.Tensor, flow: torch.Tensor,
             max_displacement: int | None) -> torch.Tensor:
    _check(x, flow)
    n, c, h, w = x.shape
    out = torch.empty_like(x)
    fn = _build.function("flow_warp", "crfp_flow_warp", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(_build.ptr(x), _build.ptr(flow), _build.ptr(out), n, c, h, w,
                _build.window(max_displacement), int(x.dtype == torch.bfloat16),
                _build.stream(x.device))
    _build.check(rc, "flow_warp", "crfp_flow_warp")
    global launches
    launches += 1
    return out


def flow_warp_backward(x: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor,
                       max_displacement: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D at k=1: (dx in x's dtype, d-flow float32) of
    :func:`flow_warp_windowed` for ``grad_out`` (N, C, H, W) in x's dtype.
    CUDA tensors only."""
    _check(x, flow)
    if grad_out.shape != x.shape or grad_out.dtype != x.dtype \
            or grad_out.device != x.device or not grad_out.is_contiguous():
        raise ValueError(f"flow_warp_bwd: grad_out {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} must be a contiguous {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    n, c, h, w = x.shape
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    d_flow = torch.empty_like(flow)
    fn = _build.function("flow_warp_bwd", "crfp_flow_warp_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(_build.ptr(x), _build.ptr(flow), _build.ptr(grad_out),
                _build.ptr(dx), _build.ptr(d_flow), n, c, h, w,
                _build.window(max_displacement), int(x.dtype == torch.bfloat16),
                _build.stream(x.device))
    _build.check(rc, "flow_warp_bwd", "crfp_flow_warp_bwd")
    global bwd_launches
    bwd_launches += 1
    return dx.to(x.dtype), d_flow


class _FlowWarpWindowed(torch.autograd.Function):
    """Kernel B forward, kernel D at k=1 backward."""

    @staticmethod
    def forward(ctx, x, flow, max_displacement):
        ctx.save_for_backward(x, flow)
        ctx.max_displacement = max_displacement
        return _forward(x, flow, max_displacement)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, flow = ctx.saved_tensors
        dx, d_flow = flow_warp_backward(x, flow, grad_out.to(x.dtype).contiguous(),
                                        ctx.max_displacement)
        return dx, d_flow, None


def flow_warp_windowed(x: torch.Tensor, flow: torch.Tensor,
                       max_displacement: int | None) -> torch.Tensor:
    """Warp ``x`` by ``flow`` clamped to ``±max_displacement`` (None: no
    clamp), zeros padding; x's dtype; differentiable in x and flow.

    CPU tensors take the plain version (autograd of plain PyTorch); CUDA
    tensors launch kernel B forward and kernel D at k=1 backward (x float32
    or bfloat16, flow float32) or raise."""
    if x.device.type == "cpu":
        return flow_warp_windowed_ref(x, flow, max_displacement)
    return _FlowWarpWindowed.apply(x, flow, max_displacement)
