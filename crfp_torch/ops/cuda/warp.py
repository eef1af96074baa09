"""Kernel B and D (k=1) dispatcher: windowed backward flow warp, forward
and backward.

Forward: replaces ``crfp_tpu/ops/pallas/warp.py::flow_warp_windowed_pallas`` (:29)
and ``flow_warp_windowed_pallas_s2d`` (:55), which on the TPU run the DCN
kernel ``crfp_tpu/ops/pallas/dcn.py::_dcn_kernel`` (:59) at k=1 with an
identity weight, with ``crfp_torch/csrc/flow_warp.cu``: a warp kernel of
its own, since a k=1 DCN spends a C x C contraction per pixel.

Backward: replaces ``crfp_tpu/ops/pallas/dcn.py::_dcn_bwd_kernel`` (:219,
``_bwd_call`` :593; anchored :581) at k=1 with no mask, which is how the TPU
differentiates the windowed warp, with ``crfp_torch/csrc/flow_warp_bwd.cu``
behind a ``torch.autograd.Function``: dx and d-flow, 0 where the flow is
clamped. No second derivative.

What bounds them on the H100 (see the source notes): bytes, and so little
of them that a launch lasts microseconds. The HR state (1, 4, 720, 720)
bf16 with its f32 flow moves 12.4 MB (3.7 us at 3.35 TB/s), the lv states
(1, 24, 180, 180) 3.4 MB (1.0 us); at the training shapes the backward
moves 2.9 MB for the HR state (2, 4, 192, 192) and 1.0 MB for lv3_state
(2, 32, 48, 48). A call of this module therefore costs what the host
spends on it, and the dispatcher is written for that:

- outside autograd (no operand requires grad, or grad mode is off, as in
  serving and in the quality gate) the forward launches kernel B directly,
  without a ``torch.autograd.Function``;
- the operands are checked in one boolean pass; only a failed pass walks
  the single checks to name the fault. Nothing is dropped: a wrong device,
  type, shape or layout raises ``ValueError``, a CUDA tensor launches the
  kernel or raises, and there is no fallback to the plain version;
- one ``torch.empty`` per output (plus the f32 accumulator of a bf16 dx)
  and one foreign call per direction: the backward's zeroing, scatter and
  cast back to bf16 are one C entry;
- the launch itself is ``_build.launch`` (entry configured once, no device
  context for the current card, plain ints for pointers and stream).

Measured on an NVIDIA H100 80GB HBM3 (700.00 W), ``chip_smoke.py`` phases 2
and 5 and ``python -m crfp_torch.bench.launch_path``, bf16, before -> after
in one run: a forward call reads 10-19 us in an eager loop (27-40 before;
PyTorch's own sampler call 9-23), of which the foreign call is 5-9; through the
``autograd.Function`` 18-35. The card needs 4.3-17.5 us for it (see
``csrc/flow_warp.cu``). A backward call reads 21-39 us (40-110 before;
PyTorch's own sampler backward 26-57, device-bound) and the card needs
7.5-15.4 us (17.5-24.4 before). The host's speed on a shared machine varies by 1.5x
between runs; the device times repeat to 2 %.

Anchored (``anchor``, an :class:`crfp_torch.ops.anchor.AnchorGeometry`):
the per-cell anchored windows of the TPU warp (``anchor=True``,
crfp_tpu/ops/pallas/warp.py:29-102), trained as JAX's ``anchor_vjp``
trains them. A pre-pass of the forward call writes the anchor table (one
(dy, dx) a cell, ``csrc/common.cuh::anchor_table_kernel``; plain version
:func:`crfp_torch.ops.anchor.anchor_table`, as JAX computes the table
outside its kernel) into a tensor from the wrapper, and kernel B reads it:
each pixel samples at its cell's anchor plus the flow's residual clipped
to ±dl. The autograd Function saves that table (``save_for_backward``), and
kernel D at k=1 in anchored mode reads it: dx scattered from the same
sample points, each d-flow component passed only where its residual lies
within ±dl.

Layouts: x (N, C, H, W); flow (N, 2, H, W), channels (dx, dy) in pixels.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable
from torch.overrides import handle_torch_function, has_torch_function

from crfp_torch.ops.anchor import AnchorGeometry, kernel_args
from crfp_torch.ops.cuda import _build
from crfp_torch.ops.warp import flow_warp_windowed_ref
from crfp_torch.trace import span

# launches of the CUDA kernels (not of the plain version): B forward, D
# backward; anchor_launches and bwd_anchor_launches: B's and D's anchored
# launches, also in `launches` and `bwd_launches`
launches = 0
bwd_launches = 0
anchor_launches = 0
bwd_anchor_launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p] + \
    [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                              ctypes.c_int,
                                                              ctypes.c_void_p] + \
    [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
_F32, _BF16 = torch.float32, torch.bfloat16


def _check(x: torch.Tensor, flow: torch.Tensor) -> torch.Size:
    """Raise ``ValueError`` unless (x, flow) is what the kernels take;
    returns x's shape. One pass for a correct caller; :func:`_reject` names
    the fault otherwise."""
    shape = x.shape
    if not (len(shape) == 4 and flow.shape == (shape[0], 2, shape[2], shape[3])
            and (x.dtype is _F32 or x.dtype is _BF16) and flow.dtype is _F32
            and x.is_contiguous() and flow.is_contiguous()
            and x.is_cuda and flow.device == x.device):
        _reject(x, flow)
    return shape


def _reject(x: torch.Tensor, flow: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"flow_warp: x {tuple(x.shape)} must be (N, C, H, W)")
    n, _, h, w = x.shape
    if flow.shape != (n, 2, h, w):
        raise ValueError(f"flow_warp: flow {tuple(flow.shape)} != {(n, 2, h, w)}")
    if x.dtype not in (_F32, _BF16):
        raise ValueError(f"flow_warp: x dtype {x.dtype} (float32 or bfloat16)")
    if flow.dtype != _F32:
        raise ValueError(f"flow_warp: flow must be float32, got {flow.dtype}")
    if not (x.is_contiguous() and flow.is_contiguous()):
        raise ValueError("flow_warp: x and flow must be contiguous")
    if flow.device != x.device:
        raise ValueError(f"flow_warp: flow on {flow.device}, x on {x.device}")
    raise ValueError(f"flow_warp: x must be a CUDA tensor, got {x.device}")


def _forward(x: torch.Tensor, flow: torch.Tensor, max_displacement: int | None,
             anchor: AnchorGeometry | None = None):
    """Kernel B on checked operands: (output, the anchor table its pre-pass
    wrote, or None unanchored)."""
    global launches, anchor_launches
    with span("crfp.kernel.B", {"x": x, "window": max_displacement,
                                "anchored": anchor is not None}):
        n, c, h, w = _check(x, flow)
        out = torch.empty_like(x)
        # an anchored call's table, written by its own pre-pass
        table = None if anchor is None else torch.empty(
            (n, 1, *anchor.cells(h, w), 2), dtype=_F32, device=x.device)
        _build.launch("flow_warp", "crfp_flow_warp", _ARGTYPES, x.device,
                      x.data_ptr(), flow.data_ptr(), out.data_ptr(), n, c, h, w,
                      _build.window(max_displacement), int(x.dtype is _BF16),
                      None if table is None else table.data_ptr(),
                      *kernel_args(anchor))
        launches += 1
        if anchor is not None:
            anchor_launches += 1
    return out, table


def _backward(x: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor,
              max_displacement: int | None, anchor: AnchorGeometry | None = None,
              table: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D at k=1 on checked operands (anchored: on the forward's
    ``table``). dx is summed in float32 (the
    scatter adds up to four corner terms per source pixel, and a bf16 sum
    would round each): for float32 x the accumulator is the result, for
    bfloat16 x the C entry casts it into ``dx`` after the scatter."""
    global bwd_launches, bwd_anchor_launches
    with span("crfp.kernel.D_warp", {"x": x, "window": max_displacement,
                                     "anchored": anchor is not None}):
        n, c, h, w = x.shape
        # acc may be freed on return: PyTorch's allocator reuses a block only
        # after the work queued on this stream before the free
        if x.dtype is _F32:
            acc = dx = torch.empty_like(x)
        else:
            acc, dx = torch.empty_like(x, dtype=_F32), torch.empty_like(x)
        d_flow = torch.empty_like(flow)
        _build.launch("flow_warp_bwd", "crfp_flow_warp_bwd", _BWD_ARGTYPES, x.device,
                      x.data_ptr(), flow.data_ptr(), grad_out.data_ptr(), acc.data_ptr(),
                      dx.data_ptr(), d_flow.data_ptr(), n, c, h, w,
                      _build.window(max_displacement), int(x.dtype is _BF16),
                      None if table is None else table.data_ptr(), *kernel_args(anchor))
        bwd_launches += 1
        if anchor is not None:
            bwd_anchor_launches += 1
    return dx, d_flow


def flow_warp_forward_table(x: torch.Tensor, flow: torch.Tensor, max_displacement: int | None,
                            anchor: AnchorGeometry) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B in anchored mode, no autograd: (output, the anchor table its
    pre-pass wrote, f32 (N, 1, bands, tiles, 2)), the table that
    :func:`flow_warp_backward` takes. CUDA tensors only."""
    return _forward(x, flow, max_displacement, anchor)


def flow_warp_backward(x: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor,
                       max_displacement: int | None, anchor: AnchorGeometry | None = None,
                       table: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D at k=1: (dx in x's dtype, d-flow float32) of
    :func:`flow_warp_windowed` for ``grad_out`` (N, C, H, W) in x's dtype.
    CUDA tensors only. ``anchor`` with ``table``: the anchored mode, on the
    table of the anchored forward (:func:`flow_warp_forward_table`). d-flow
    is reduced in a fixed order: the same inputs give the same bits."""
    n, _, h, w = _check(x, flow)
    if grad_out.shape != x.shape or grad_out.dtype != x.dtype \
            or grad_out.device != x.device or not grad_out.is_contiguous():
        raise ValueError(f"flow_warp_bwd: grad_out {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} must be a contiguous {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    if (anchor is None) != (table is None):
        raise ValueError("flow_warp_bwd: an anchored call takes the anchor geometry and the "
                         "table of its forward, both")
    if table is not None and (table.shape != (n, 1, *anchor.cells(h, w), 2)
                              or table.dtype is not _F32 or table.device != x.device
                              or not table.is_contiguous()):
        raise ValueError(f"flow_warp_bwd: anchor table {tuple(table.shape)} {table.dtype} "
                         f"must be a contiguous float32 {(n, 1, *anchor.cells(h, w), 2)} "
                         f"on {x.device}")
    return _backward(x, flow, grad_out, max_displacement, anchor, table)


class _FlowWarpWindowed(torch.autograd.Function):
    """Kernel B forward, kernel D at k=1 backward; anchored, the forward's
    table is saved with the operands, and the backward reads it."""

    @staticmethod
    def forward(ctx, x, flow, max_displacement, anchor):
        out, table = _forward(x, flow, max_displacement, anchor)
        ctx.save_for_backward(x, flow, table)
        ctx.max_displacement, ctx.anchor = max_displacement, anchor
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        # x and flow passed _check in forward; autograd gives grad_out the
        # output's shape and device
        x, flow, table = ctx.saved_tensors
        if grad_out.dtype is not x.dtype or not grad_out.is_contiguous():
            grad_out = grad_out.to(x.dtype).contiguous()
        dx, d_flow = _backward(x, flow, grad_out, ctx.max_displacement, ctx.anchor, table)
        return dx, d_flow, None, None


def flow_warp_windowed(x: torch.Tensor, flow: torch.Tensor,
                       max_displacement: int | None,
                       anchor: AnchorGeometry | None = None) -> torch.Tensor:
    """Warp ``x`` by ``flow`` clamped to ``±max_displacement`` (None: no
    clamp), zeros padding; x's dtype; differentiable in x and flow. With
    ``anchor`` the per-cell anchored warp of that geometry instead
    (:func:`crfp_torch.ops.anchor.warp_geometry`; ``fullgrad=True`` for
    the training grid), differentiable as well.

    CPU tensors take the plain version (autograd of plain PyTorch); CUDA
    tensors launch kernel B forward and kernel D at k=1 backward (x float32
    or bfloat16, flow float32) or raise. Where autograd would record
    nothing the kernel is launched without the ``autograd.Function``.
    Overridable (``torch.overrides``): a ``TorchFunctionMode`` such as the
    height-sharded runner's sees the call whole."""
    if has_torch_function((x, flow)):
        return handle_torch_function(flow_warp_windowed, (x, flow), x, flow,
                                     max_displacement, anchor=anchor)
    recorded = torch.is_grad_enabled() and (x.requires_grad or flow.requires_grad)
    if x.is_cpu:
        return flow_warp_windowed_ref(x, flow, max_displacement, anchor)
    if recorded:
        return _FlowWarpWindowed.apply(x, flow, max_displacement, anchor)
    return _forward(x, flow, max_displacement, anchor)[0]
