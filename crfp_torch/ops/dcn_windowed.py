"""Windowed modulated deformable conv (DCNv2), plain PyTorch, NCHW.

The plain version beside kernel A (``crfp_torch/ops/cuda/dcn.py``), with
the semantics of crfp_tpu/ops/dcn_windowed.py:40-177: each offset
component is clamped to ``±max_displacement`` (None: unclamped, the exact
DCN), then every tap ``k`` of output pixel ``p`` takes an exact bilinear
sample of ``x`` at ``p + p_k + offset`` with zeros outside the frame, is
scaled by its mask, contracted with the weight, and the bias is added last.

Layouts (the packed channel order of torchvision / DCNv2):
- x: (N, C, H, W); channels split into G contiguous groups of C/G.
- offset: (N, G*T*2, H, W), channel ``(g*T + k)*2 + {0: dy, 1: dx}``, with
  T = 1 when ``shared_taps`` (one displacement for all taps) else kh*kw.
- mask: (N, G*M, H, W), channel ``g*M + k``, M = 1 when ``shared_mask``.
- weight: (O, C, kh, kw); bias: (O,) or None. Stride 1, 'same' padding.

``anchor`` (an :class:`crfp_torch.ops.anchor.AnchorGeometry`): per-cell
anchored windows instead of the ±D clamp; the exact DCN at the effective
offsets of :func:`crfp_torch.ops.anchor.effective_offsets`, which reach
past ±D (crfp_tpu/ops/pallas/dcn.py:771-780).
"""

from __future__ import annotations

import torch

from crfp_torch.ops.anchor import AnchorGeometry, effective_offsets
from crfp_torch.ops.warp import bilinear_sample_zeros


def deform_conv2d_windowed_ref(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    max_displacement: int | None = None,
    shared_taps: bool = False,
    shared_mask: bool = False,
    anchor: AnchorGeometry | None = None,
) -> torch.Tensor:
    """Returns (N, O, H, W) in x's dtype; computes in float32."""
    n, c, h, w = x.shape
    o, wc, kh, kw = weight.shape
    assert wc == c, (x.shape, weight.shape)
    k2 = kh * kw
    taps = 1 if shared_taps else k2
    mtaps = 1 if shared_mask else k2
    g = offset.shape[1] // (2 * taps)
    assert offset.shape == (n, g * taps * 2, h, w), offset.shape
    assert mask.shape == (n, g * mtaps, h, w), mask.shape
    cpg = c // g

    if anchor is not None:
        offset = effective_offsets(offset, anchor, g)
    off = offset.float().reshape(n, g, taps, 2, h, w)
    if anchor is None and max_displacement is not None:
        d = float(max_displacement)
        off = off.clamp(-d, d)
    dev = x.device
    ky = (torch.arange(kh, device=dev, dtype=torch.float32) - (kh - 1) // 2
          ).repeat_interleave(kw).view(1, 1, k2, 1, 1)
    kx = (torch.arange(kw, device=dev, dtype=torch.float32) - (kw - 1) // 2
          ).repeat(kh).view(1, 1, k2, 1, 1)
    gy = torch.arange(h, device=dev, dtype=torch.float32).view(1, 1, 1, h, 1)
    gx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, 1, 1, w)
    sy = (gy + ky) + off[:, :, :, 0]  # (n, g, k2, h, w)
    sx = (gx + kx) + off[:, :, :, 1]

    samp = bilinear_sample_zeros(
        x.reshape(n * g, cpg, h, w),
        sy.expand(n, g, k2, h, w).reshape(n * g, k2, h, w),
        sx.expand(n, g, k2, h, w).reshape(n * g, k2, h, w),
    ).reshape(n, g, cpg, k2, h, w)
    samp = samp * mask.float().reshape(n, g, 1, mtaps, h, w)
    w2 = weight.float().reshape(o, g, cpg, k2)
    out = torch.einsum("ngckhw,ogck->nohw", samp, w2)
    if bias is not None:
        out = out + bias.float().view(1, o, 1, 1)
    return out.to(x.dtype)


def fusedprep_offsets_and_mask(
    raw_offset: torch.Tensor,
    raw_mask: torch.Tensor,
    flow: torch.Tensor,
    max_residue_magnitude: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-tap prologue in plain PyTorch (crfp_tpu/nn/align.py:281,
    :292-296, before the clip): float32 offsets ``mag * tanh(raw) + flow``
    in the packed layout (dy takes ``flow[:, 1]``, dx ``flow[:, 0]``) and
    the sigmoid mask, from the heads' raw outputs (N, G*K2*2, H, W) and
    (N, G*K2, H, W) and the (N, 2, H, W) flow (dx, dy)."""
    n, _, h, w = raw_offset.shape
    raw = raw_offset.float().reshape(n, -1, 2, h, w)  # (n, g*k2, {dy, dx}, h, w)
    flow = flow.float()
    off_y = max_residue_magnitude * torch.tanh(raw[:, :, 0]) + flow[:, 1:2]
    off_x = max_residue_magnitude * torch.tanh(raw[:, :, 1]) + flow[:, 0:1]
    off = torch.stack([off_y, off_x], dim=2).reshape(n, -1, h, w)
    return off, torch.sigmoid(raw_mask.float())


def deform_conv2d_fusedprep_ref(
    x: torch.Tensor,
    raw_offset: torch.Tensor,
    raw_mask: torch.Tensor,
    flow: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    max_residue_magnitude: float = 10.0,
    max_displacement: int | None = None,
) -> torch.Tensor:
    """The plain version beside kernel E (``crfp_torch/ops/cuda/dcn_fused.py``):
    the prologue above, then :func:`deform_conv2d_windowed_ref` per tap,
    which clamps ``mag * tanh + flow`` once, after the flow is added
    (crfp_tpu/ops/pallas/dcn.py::deform_conv2d_pallas_fusedprep with its
    XLA-side epilogue). Returns (N, O, H, W) in x's dtype."""
    off, mask = fusedprep_offsets_and_mask(raw_offset, raw_mask, flow,
                                           max_residue_magnitude)
    return deform_conv2d_windowed_ref(x, off, mask, weight.float(),
                                      None if bias is None else bias.float(),
                                      max_displacement=max_displacement)
