"""Backward warp by optical flow, NCHW (crfp_tpu/ops/warp.py).

The sample position of output pixel ``(y, x)`` is ``(y + dy, x + dx)`` in
pixel units (``grid_sample`` with ``align_corners=True``); bilinear, zeros
outside the frame, or with ``padding_mode="border"`` (SPyNet's warp,
crfp_tpu/ops/warp.py:38-41) the position clamped into the frame first.
Flow channels are ``(dx, dy)``. The border mode has no kernel: it runs in
SPyNet's LR flow pyramid, in plain PyTorch.

:func:`flow_warp_windowed_ref` is the plain version beside kernel B
(``crfp_torch/ops/cuda/warp.py``): the same warp with the flow clamped to
``±max_displacement``, which is what the TPU's windowed warp computes
(crfp_tpu/ops/pallas/warp.py:89-102), or with per-cell anchored windows
(``anchor``): the exact warp at the k = 1 DCN's effective offsets
(crfp_torch/ops/anchor.py).
"""

from __future__ import annotations

import torch

from crfp_torch.ops.anchor import AnchorGeometry, effective_offsets, flow_as_offset


def bilinear_sample_zeros(x: torch.Tensor, sy: torch.Tensor,
                          sx: torch.Tensor) -> torch.Tensor:
    """Sample ``x`` (B, C, H, W) at float pixel coordinates ``sy``/``sx``
    (B, *S); zeros outside the frame. Returns (B, C, *S) in float32.

    Four flat gathers and the blend ``v00*w00 + v01*w01 + v10*w10 +
    v11*w11`` in the order of crfp_tpu/ops/warp.py::bilinear_sample."""
    b, c, h, w = x.shape
    spatial = sy.shape[1:]
    sy = sy.reshape(b, 1, -1).float()
    sx = sx.reshape(b, 1, -1).float()
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = sy - y0
    fx = sx - x0
    y0i = y0.long()
    x0i = x0.long()
    flat = x.reshape(b, c, h * w).float()
    out = None
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yi = y0i + dy
            xi = x0i + dx
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).expand(b, c, -1)
            term = torch.gather(flat, 2, idx) * (wy * wx * valid)
            out = term if out is None else out + term
    return out.reshape(b, c, *spatial)


def bilinear_sample_border(x: torch.Tensor, sy: torch.Tensor,
                           sx: torch.Tensor) -> torch.Tensor:
    """:func:`bilinear_sample_zeros` with ``padding_mode="border"``: the
    coordinates clamped to [0, H-1] x [0, W-1], then blended from the
    clipped corners (crfp_tpu/ops/warp.py::bilinear_sample, :38-41)."""
    b, c, h, w = x.shape
    spatial = sy.shape[1:]
    sy = sy.reshape(b, 1, -1).float().clamp(0.0, h - 1)
    sx = sx.reshape(b, 1, -1).float().clamp(0.0, w - 1)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = sy - y0
    fx = sx - x0
    y0i = y0.long()
    x0i = x0.long()
    flat = x.reshape(b, c, h * w).float()
    out = None
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            idx = ((y0i + dy).clamp(0, h - 1) * w + (x0i + dx).clamp(0, w - 1))
            term = torch.gather(flat, 2, idx.expand(b, c, -1)) * (wy * wx)
            out = term if out is None else out + term
    return out.reshape(b, c, *spatial)


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              padding_mode: str = "zeros") -> torch.Tensor:
    """Warp ``x`` (N, C, H, W) by ``flow`` (N, 2, H, W), channels (dx, dy)
    in pixels, ``padding_mode`` "zeros" or "border". Returns x's dtype."""
    n, _, h, w = x.shape
    assert flow.shape == (n, 2, h, w), (x.shape, flow.shape)
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    gy = torch.arange(h, device=x.device, dtype=torch.float32).view(1, h, 1)
    gx = torch.arange(w, device=x.device, dtype=torch.float32).view(1, 1, w)
    flow = flow.float()
    sx = gx + flow[:, 0]
    sy = gy + flow[:, 1]
    sample = bilinear_sample_zeros if padding_mode == "zeros" else bilinear_sample_border
    return sample(x, sy, sx).to(x.dtype)


def flow_warp_windowed_ref(x: torch.Tensor, flow: torch.Tensor,
                           max_displacement: int | None,
                           anchor: AnchorGeometry | None = None) -> torch.Tensor:
    """:func:`flow_warp` with the flow clamped to ``±max_displacement``
    (None: unclamped), or anchored by ``anchor``'s cell grid."""
    if anchor is not None:
        return flow_warp(x, anchored_flow(flow, anchor))
    if max_displacement is not None:
        d = float(max_displacement)
        flow = flow.float().clamp(-d, d)
    return flow_warp(x, flow)


def anchored_flow(flow: torch.Tensor, anchor: AnchorGeometry) -> torch.Tensor:
    """The flow (N, 2, H, W) as (dx, dy) that the anchored warp samples at:
    the k = 1 DCN's effective offsets, flipped back to (dx, dy)."""
    return effective_offsets(flow_as_offset(flow), anchor, 1).flip(1)
