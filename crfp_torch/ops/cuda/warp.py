"""Kernel B dispatcher: windowed backward flow warp.

Replaces ``crfp_tpu/ops/pallas/warp.py::flow_warp_windowed_pallas`` (:29)
and ``flow_warp_windowed_pallas_s2d`` (:55), which on the TPU run the DCN
kernel ``crfp_tpu/ops/pallas/dcn.py::_dcn_kernel`` (:59) at k=1 with an
identity weight, with ``crfp_torch/csrc/flow_warp.cu``: a warp kernel of
its own, since a k=1 DCN spends a C x C contraction per pixel.

Bound on the H100 at the main-path shapes (bytes, see the source note):
the HR state (1, 4, 720, 720) bf16 with its f32 flow moves 12.4 MB
(~3.7 us at 3.35 TB/s); the lv states (1, 24, 180, 180) 3.4 MB (~1.0 us).
One thread per (pixel, channel block) reads the flow and builds the
corner weights once for the block.

Layouts: x (N, C, H, W); flow (N, 2, H, W), channels (dx, dy) in pixels.
"""

from __future__ import annotations

import ctypes

import torch

from crfp_torch.ops.cuda import _build
from crfp_torch.ops.warp import flow_warp_windowed_ref

# launches of the CUDA kernel (not of the plain version)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float,
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


def flow_warp_windowed(x: torch.Tensor, flow: torch.Tensor,
                       max_displacement: int | None) -> torch.Tensor:
    """Warp ``x`` by ``flow`` clamped to ``±max_displacement`` (None: no
    clamp), zeros padding; x's dtype.

    CPU tensors take the plain version; CUDA tensors launch kernel B
    (x float32 or bfloat16, flow float32) or raise."""
    if x.device.type == "cpu":
        return flow_warp_windowed_ref(x, flow, max_displacement)
    _check(x, flow)
    n, c, h, w = x.shape
    out = torch.empty_like(x)
    fn = _build.function("flow_warp", "crfp_flow_warp", _ARGTYPES)
    d = -1.0 if max_displacement is None else float(max_displacement)
    with torch.cuda.device(x.device):
        rc = fn(_build.ptr(x), _build.ptr(flow), _build.ptr(out), n, c, h, w, d,
                int(x.dtype == torch.bfloat16), _build.stream(x.device))
    _build.check(rc, "flow_warp", "crfp_flow_warp")
    global launches
    launches += 1
    return out
