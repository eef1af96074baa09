"""Kernels G and H dispatchers: the runtime models' full-resolution chains
around the HR alignment, each in one launch (``crfp_torch/csrc/hr_conv.cu``).

They replace no TPU kernel: the JAX package leaves these convolutions to
XLA. At the serving step's full resolution (4 x 1080 x 1920 in the
deployment) the chains have 1-10 channels, which cuDNN serves with its
CUDA-core implicit GEMM between layout conversions, and PyTorch runs a
full-frame pass for every shuffle, activation, concatenation and add
between them. Each kernel keeps the chain's intermediates in shared memory
(see the source note for the bound and the design).

- :func:`hr_conv_head` (kernel G): dcn_3's offset and mask head, from
  ``upsample_post``'s conv output ``u`` and dcn_3's upsample conv output
  ``p``; returns kernel A's f32 offset and mask.
- :func:`hr_conv_tail` (kernel H): ``forward_resblocks_3`` over
  ``cat(roi, aligned[, hr_warped])`` and the full frame; returns lv3.

Inference only, as kernel E: the runtime models call them with grad off,
``offset_prop`` on and ``last_channels`` in :data:`CHANNELS`, and the plain
versions (``*_ref``, which call the modules) for every other call. The
dispatchers send CPU tensors to the plain versions; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from crfp_torch.nn.layers import lrelu
from crfp_torch.ops.cuda import _build
from crfp_torch.ops.cuda.emit import CONV_CHANNELS
from crfp_torch.ops.shuffle import pixel_shuffle
from crfp_torch.trace import span

# launches of the CUDA kernels (not of the plain versions)
head_launches = 0
tail_launches = 0

# the HR level's channel counts the kernels are instantiated for, those of
# kernel C's conv route (last_channels = mid / 8: mid 16, 24, 32, 64)
CHANNELS = CONV_CHANNELS
_HEAD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p]
_TAIL_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_TYPES = (torch.float32, torch.bfloat16)


def hr_conv_head_ref(dcn, u: torch.Tensor, hr_warped: torch.Tensor, flow: torch.Tensor,
                     p: torch.Tensor | None, roi_hw: tuple[int, int]):
    """Plain version of kernel G: the ROI of ``lrelu(pixel_shuffle(u, 4))``,
    ``dcn``'s (a repeat-mode :class:`~crfp_torch.nn.align.DCNAlign`, with a
    pixel-shuffled pre-offset unless ``p`` is None) features over it,
    ``hr_warped``, ``flow`` and ``pixel_shuffle(p, 4) * 2``, and its offsets
    and mask: the module calls of ``DCNAlign.forward``. Returns (offset (N,
    2, *roi_hw), mask (N, 1, *roi_hw)), float32."""
    wph, wpw = roi_hw
    roi = lrelu(pixel_shuffle(u, 4))[:, :, :wph, :wpw]
    feat = dcn.features(roi, hr_warped, flow, None if p is None else pixel_shuffle(p, 4) * 2.0)
    return dcn.offsets(feat, flow)


def hr_conv_tail_ref(rb, u: torch.Tensor, aligned: torch.Tensor,
                     hr_warped: torch.Tensor | None, roi_hw: tuple[int, int]) -> torch.Tensor:
    """Plain version of kernel H: ``rb`` (``forward_resblocks_3``) over
    ``cat(roi, aligned[, hr_warped])`` and the full frame ``lrelu(
    pixel_shuffle(u, 4))``, whose top-left ``roi_hw`` is the ROI."""
    wph, wpw = roi_hw
    full = lrelu(pixel_shuffle(u, 4))
    parts = [full[:, :, :wph, :wpw], aligned] + ([] if hr_warped is None else [hr_warped])
    return rb(torch.cat(parts, dim=1), full)


def _weights(convs) -> list[torch.Tensor]:
    return [t for c in convs for t in (c.conv.weight, c.conv.bias)]


def _check(kernel: str, u: torch.Tensor, tensors: dict, convs: dict, last: int) -> None:
    """Raise ``ValueError`` unless the operands are what the kernel takes:
    ``u`` (N, 16 L, hq, wq) and every tensor of ``tensors`` (name -> (tensor,
    shape, dtype or None for u's)) contiguous on u's card, ``convs`` (name ->
    (Conv, (out, in))) 3x3 with bias, padding 1, in u's dtype."""
    if u.device.type != "cuda":
        raise ValueError(f"hr_conv {kernel}: u must be a CUDA tensor, got {u.device}")
    if u.dtype not in _TYPES or last not in CHANNELS:
        raise ValueError(f"hr_conv {kernel}: u {u.dtype} with {last} channels (float32 or "
                         f"bfloat16, {CHANNELS})")
    if u.dim() != 4 or u.shape[1] != 16 * last or not u.is_contiguous():
        raise ValueError(f"hr_conv {kernel}: u {tuple(u.shape)} is not a contiguous "
                         f"(N, {16 * last}, hq, wq)")
    for name, (t, shape, dtype) in tensors.items():
        if (tuple(t.shape) != tuple(shape) or t.dtype != (dtype or u.dtype)
                or t.device != u.device or not t.is_contiguous()):
            raise ValueError(f"hr_conv {kernel}: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} (contiguous {t.is_contiguous()}) is not a "
                             f"contiguous {tuple(shape)} {dtype or u.dtype} on {u.device}")
    for name, (c, (o, i)) in convs.items():
        w, b = c.conv.weight, c.conv.bias
        if (w.shape != (o, i, 3, 3) or b is None or c.conv.padding != (1, 1)
                or c.conv.stride != (1, 1)
                or any(t.dtype != u.dtype or t.device != u.device or not t.is_contiguous()
                       for t in (w, b))):
            raise ValueError(f"hr_conv {kernel}: {name} {tuple(w.shape)} {w.dtype} is not a "
                             f"3x3 conv {i} -> {o} with bias, padding 1, in {u.dtype} on "
                             f"{u.device}")


def hr_conv_head(dcn, u: torch.Tensor, hr_warped: torch.Tensor, flow: torch.Tensor,
                 p: torch.Tensor, roi_hw: tuple[int, int]):
    """dcn_3's offset and mask over the ROI (kernel G): (offset (N, 2,
    *roi_hw), mask (N, 1, *roi_hw)), float32, what :func:`hr_conv_head_ref`
    returns. ``u``: ``upsample_post``'s conv output (N, 16 L, H/4, W/4);
    ``hr_warped`` (N, L, *roi_hw) in u's dtype; ``flow`` (N, 2, *roi_hw)
    float32 (dx, dy); ``p``: ``dcn.upsample``'s conv output (N, 16 L,
    *roi_hw / 4).

    CPU tensors take the plain version; CUDA tensors launch kernel G or
    raise. ``hr_warped``, ``flow`` and ``p`` may have any strides (copied
    where they are not contiguous)."""
    if u.device.type == "cpu":
        return hr_conv_head_ref(dcn, u, hr_warped, flow, p, roi_hw)
    global head_launches
    hr_warped, flow, p = hr_warped.contiguous(), flow.contiguous(), p.contiguous()
    with span("crfp.kernel.G", {"u": u, "roi": tuple(roi_hw)}):
        last = dcn.mid_channels
        n, wph, wpw = u.shape[0], *roi_hw
        if not (dcn.repeat and dcn.deform_groups == 1 and dcn.pre_offset
                and dcn.interpolate == "pixelshuffle"):
            raise ValueError("hr_conv head: dcn must be a repeat-mode DCNAlign with a "
                             "pixel-shuffled pre-offset (dcn_3)")
        if wph % 4 or wpw % 4 or u.dim() != 4 or not (
                0 < wph <= 4 * u.shape[2] and 0 < wpw <= 4 * u.shape[3]):
            raise ValueError(f"hr_conv head: roi {tuple(roi_hw)} must be a multiple of 4 "
                             f"inside u's frame {tuple(u.shape)} x 4")
        _check("head", u, {"hr_warped": (hr_warped, (n, last, wph, wpw), None),
                           "flow": (flow, (n, 2, wph, wpw), torch.float32),
                           "p": (p, (n, 16 * last, wph // 4, wpw // 4), None)},
               {"dcn_block_conv1": (dcn.dcn_block_conv1, (last, 2 * last + 2)),
                "dcn_block_conv2": (dcn.dcn_block_conv2, (last, last)),
                "conv_fuse": (dcn.conv_fuse, (last, 2 * last)),
                "dcn_offset": (dcn.dcn_offset, (2, last)),
                "dcn_mask": (dcn.dcn_mask, (1, last))}, last)
        off = torch.empty((n, 2, wph, wpw), dtype=torch.float32, device=u.device)
        mask = torch.empty((n, 1, wph, wpw), dtype=torch.float32, device=u.device)
        w = _weights((dcn.dcn_block_conv1, dcn.dcn_block_conv2, dcn.conv_fuse, dcn.dcn_offset,
                      dcn.dcn_mask))
        _build.launch("hr_conv", "crfp_hr_conv_head", _HEAD_ARGTYPES, u.device,
                      u.data_ptr(), hr_warped.data_ptr(), flow.data_ptr(), p.data_ptr(),
                      *(t.data_ptr() for t in w), off.data_ptr(), mask.data_ptr(),
                      n, last, u.shape[2], u.shape[3], wph, wpw,
                      float(dcn.max_residue_magnitude), int(u.dtype is torch.bfloat16))
        head_launches += 1
    return off, mask


def hr_conv_tail(rb, u: torch.Tensor, aligned: torch.Tensor, hr_warped: torch.Tensor | None,
                 roi_hw: tuple[int, int]) -> torch.Tensor:
    """``forward_resblocks_3`` (kernel H): lv3 (N, L, H, W) in u's dtype, what
    :func:`hr_conv_tail_ref` returns. ``rb``: a ResidualBlocksWithInputConvV2
    of one residual block, conv1 over 2 L or 3 L channels; ``u``:
    ``upsample_post``'s conv output (N, 16 L, H/4, W/4); ``aligned`` and
    ``hr_warped`` (v15's third input, else None) (N, L, *roi_hw).

    CPU tensors take the plain version; CUDA tensors launch kernel H or
    raise. ``aligned`` and ``hr_warped`` may have any strides (copied where
    they are not contiguous)."""
    if u.device.type == "cpu":
        return hr_conv_tail_ref(rb, u, aligned, hr_warped, roi_hw)
    global tail_launches
    aligned = aligned.contiguous()
    hr_warped = None if hr_warped is None else hr_warped.contiguous()
    with span("crfp.kernel.H", {"u": u, "roi": tuple(roi_hw)}):
        last = aligned.shape[1] if aligned.dim() == 4 else 0
        nin = 2 if hr_warped is None else 3
        n, wph, wpw = u.shape[0], *roi_hw
        if u.dim() != 4 or not (0 < wph <= 4 * u.shape[2] and 0 < wpw <= 4 * u.shape[3]):
            raise ValueError(f"hr_conv tail: roi {tuple(roi_hw)} must lie inside u's frame "
                             f"{tuple(u.shape)} x 4")
        full = (wph, wpw) != (4 * u.shape[2], 4 * u.shape[3])
        if rb.num_blocks != 1 or (full and not hasattr(rb, "conv2")):
            raise ValueError("hr_conv tail: rb must have one residual block, and a conv2 "
                             "where the ROI is not the frame")
        tensors = {"aligned": (aligned, (n, last, wph, wpw), None)}
        if hr_warped is not None:
            tensors["hr_warped"] = (hr_warped, (n, last, wph, wpw), None)
        convs = {"conv1": (rb.conv1, (last, nin * last)),
                 "block0.conv1": (rb.block0.conv1, (last, last)),
                 "block0.conv2": (rb.block0.conv2, (last, last))}
        if full:
            convs["conv2"] = (rb.conv2, (last, last))
        _check("tail", u, tensors, convs, last)
        out = torch.empty((n, last, 4 * u.shape[2], 4 * u.shape[3]), dtype=u.dtype,
                          device=u.device)
        w1, b1, wa, ba, wb, bb = _weights((rb.conv1, rb.block0.conv1, rb.block0.conv2))
        w2, b2 = _weights((rb.conv2,)) if full else (None, None)
        _build.launch("hr_conv", "crfp_hr_conv_tail", _TAIL_ARGTYPES, u.device,
                      u.data_ptr(), aligned.data_ptr(),
                      None if hr_warped is None else hr_warped.data_ptr(),
                      w1.data_ptr(), b1.data_ptr(),
                      None if w2 is None else w2.data_ptr(),
                      None if b2 is None else b2.data_ptr(),
                      wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(),
                      out.data_ptr(), n, last, nin, u.shape[2], u.shape[3], wph, wpw,
                      int(u.dtype is torch.bfloat16))
        tail_launches += 1
    return out
