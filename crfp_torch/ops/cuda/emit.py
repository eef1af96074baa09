"""Kernel C dispatcher: final-frame emission.

Replaces ``crfp_tpu/ops/pallas/emit.py::_emit_kernel`` (:55,
``pallas_call`` in ``depth_to_space_add_chw`` :172; entry
``emit_frame_nhwc`` :185) with ``crfp_torch/csrc/emit.cu``: the frame is
``pixel_shuffle(y, r)`` plus the bilinear upsample of the LR frame to the
output size (the model's x8 base), written NHWC in y's dtype. The TPU
kernel interleaves the r^2 phase planes with a 0/1 matrix on its matrix
unit; on Hopper :func:`emit_plan` picks one of two routes of the same
arithmetic: the main path's call (r = 1, W % 8 == 0, 1 or 3 channels,
16-byte aligned y and frame) takes a block per output row with 8 columns
a thread, 16-byte loads, the vertical step done once a row and the row
stored through shared memory in 512-byte warp stores; every other call
takes a thread per output pixel.

Bound on the H100 at 1080p (bytes, see the source note): y (1, 3, 1080,
1920) bf16 in and the frame out move 25 MB (~7.5 us at 3.35 TB/s). The
kernel reads y and writes the frame once.

:func:`emit_frame_conv` is kernel C's conv route, the runtime models'
frame finish in one launch: leaky_relu of lv3 (the new HR state over the
ROI) and ``conv_last`` (a 3x3 convolution of L <= 8 channels to the
frame's) before the same emission, so that neither the activation nor
``conv_last``'s output goes to device memory.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from crfp_torch.ops.cuda import _build
from crfp_torch.ops.resize import resize_bilinear
from crfp_torch.ops.shuffle import pixel_shuffle
from crfp_torch.trace import span

# launches of the CUDA kernel (not of the plain version); conv_launches:
# those of its conv route, also in `launches`
launches = 0
conv_launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_CONV_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_F32, _BF16 = torch.float32, torch.bfloat16
# lv3's channel counts the conv route is instantiated for (mid 16, 24, 32, 64)
CONV_CHANNELS = (2, 3, 4, 8)

# csrc/emit.cu's geometry: output columns per thread and the largest block
# of the row route; the pixel route's block
VEC, MAX_ROW_THREADS, PIXEL_THREADS = 8, 512, 256
_SMEM_LIMIT = 48 * 1024


def emit_frame_ref(y: torch.Tensor, lr: torch.Tensor, r: int = 1) -> torch.Tensor:
    """Plain version: ``pixel_shuffle(y, r) + resize_bilinear(lr)`` to the
    frame size, summed in float32, returned NHWC in y's dtype.

    y: (N, C*r*r, H/r, W/r); lr: (N, C, h, w)."""
    frame = pixel_shuffle(y, r).float() if r > 1 else y.float()
    base = resize_bilinear(lr.float(), tuple(frame.shape[-2:]))
    return (frame + base).to(y.dtype).permute(0, 2, 3, 1).contiguous()


@dataclass(frozen=True)
class EmitPlan:
    """Launch geometry of ``csrc/emit.cu`` for one (height, width) frame.
    ``vector``: the row route, a block per (output row, image) whose thread
    t writes columns ``VEC * t`` .. ``VEC * t + VEC - 1``; otherwise the
    pixel route, a block of ``PIXEL_THREADS`` per run of output pixels of
    one image."""
    vector: bool
    threads: int
    grid: tuple[int, int]
    height: int
    width: int

    def outputs(self, block, t) -> np.ndarray:
        """Flat pixel indices (Y * width + X) within its image that thread
        ``t`` of block ``block`` writes (the kernel's index math), -1 where
        it writes nothing; ``block`` and ``t`` broadcast as numpy arrays,
        with a last axis of ``VEC`` (row route) or 1 (pixel route)."""
        block, t = np.asarray(block)[..., None], np.asarray(t)[..., None]
        if self.vector:
            x = VEC * t + np.arange(VEC)
            return np.where(x < self.width, block * self.width + x, -1)
        p = block * self.threads + t
        return np.where(p < self.height * self.width, p, -1)


def emit_plan(n: int, c: int, h: int, w: int, r: int, dtype: torch.dtype, y_ptr: int,
              out_ptr: int, lr_w: int) -> EmitPlan:
    """The route and geometry of kernel C for a frame (n, h, w, c) of
    ``dtype`` from s2d(r) operands at ``y_ptr`` into ``out_ptr``, from an
    LR frame ``lr_w`` wide. The row route needs r = 1, w % 8 == 0, c in
    (1, 3), both pointers 16-byte aligned, at most ``MAX_ROW_THREADS``
    threads a row, and the row's staged LR values (c * lr_w f32, padded to
    16 bytes) and output (w * c values) inside 48 KB of shared memory;
    every other call takes the pixel route."""
    threads = -(-(w // VEC) // 32) * 32
    smem = -(-(c * lr_w) // 4) * 16 + w * c * dtype.itemsize
    if (r == 1 and w % VEC == 0 and c in (1, 3) and y_ptr % 16 == 0
            and out_ptr % 16 == 0 and 0 < threads <= MAX_ROW_THREADS
            and smem <= _SMEM_LIMIT):
        return EmitPlan(True, threads, (h, n), h, w)
    return EmitPlan(False, PIXEL_THREADS, (-(-(h * w) // PIXEL_THREADS), n), h, w)


def _check(y: torch.Tensor, lr: torch.Tensor, r: int) -> None:
    """Raise ``ValueError`` unless (y, lr, r) is what kernel C takes. One
    pass for a correct caller; :func:`_reject` names the fault otherwise,
    the device last, so that every other fault is named on CPU tensors
    too."""
    ys, ls = y.shape, lr.shape
    if not (len(ys) == 4 and len(ls) == 4 and r >= 1 and ys[1] == ls[1] * r * r
            and ys[0] == ls[0] and (y.dtype is _F32 or y.dtype is _BF16)
            and lr.dtype is y.dtype and y.is_contiguous() and lr.is_contiguous()
            and y.is_cuda and lr.device == y.device):
        _reject(y, lr, r)


def _reject(y: torch.Tensor, lr: torch.Tensor, r: int) -> None:
    if y.dim() != 4 or lr.dim() != 4:
        raise ValueError(f"emit: y {tuple(y.shape)} and lr {tuple(lr.shape)} "
                         "must be 4-D")
    if r < 1 or y.shape[1] != lr.shape[1] * r * r or y.shape[0] != lr.shape[0]:
        raise ValueError(f"emit: y {tuple(y.shape)} is not the s2d({r}) form of "
                         f"a frame with lr's {lr.shape[1]} channels")
    if y.dtype not in (_F32, _BF16) or lr.dtype != y.dtype:
        raise ValueError(f"emit: y {y.dtype} and lr {lr.dtype} must share "
                         "float32 or bfloat16")
    if not (y.is_contiguous() and lr.is_contiguous()):
        raise ValueError("emit: y and lr must be contiguous")
    if lr.device != y.device:
        raise ValueError(f"emit: lr on {lr.device}, y on {y.device}")
    raise ValueError(f"emit: y must be a CUDA tensor, got {y.device}")


def emit_frame(y: torch.Tensor, lr: torch.Tensor, r: int = 1) -> torch.Tensor:
    """``pixel_shuffle(y, r)`` + the bilinear base of ``lr``, as an NHWC
    frame (N, H, W, C) in y's dtype.

    CPU tensors take the plain version; CUDA tensors launch kernel C or
    raise."""
    if y.device.type == "cpu":
        return emit_frame_ref(y, lr, r)
    global launches
    with span("crfp.kernel.C", {"y": y, "lr": lr, "r": r}):
        _check(y, lr, r)
        n, _, hs, ws = y.shape
        c, h, w = lr.shape[1:]
        big_h, big_w = hs * r, ws * r
        out = torch.empty((n, big_h, big_w, c), dtype=y.dtype, device=y.device)
        plan = emit_plan(n, c, big_h, big_w, r, y.dtype, y.data_ptr(), out.data_ptr(), w)
        _build.launch("emit", "crfp_emit", _ARGTYPES, y.device,
                      y.data_ptr(), lr.data_ptr(), out.data_ptr(), n, c, big_h, big_w,
                      r, h, w, int(y.dtype is _BF16), int(plan.vector), plan.threads)
        launches += 1
    return out


def emit_frame_conv_ref(lv3: torch.Tensor, conv, lr: torch.Tensor, roi_hw: tuple[int, int],
                        emit=emit_frame_ref) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the conv route: ``lv3 = leaky_relu(lv3)``, its
    top-left ``roi_hw`` as a new contiguous state, and ``emit`` (the plain
    :func:`emit_frame_ref`; the runtime models' calls outside the conv route
    pass :func:`emit_frame`, kernel C's row route on a card) of ``conv(lv3)``
    (the model's ``conv_last``, a ``Conv``) on ``lr``. Returns (state (N, L,
    *roi_hw), frame (N, H, W, C))."""
    lv3 = F.leaky_relu(lv3, negative_slope=0.1)
    wph, wpw = roi_hw
    return (lv3[:, :, :wph, :wpw].contiguous(),
            emit(conv(lv3).contiguous(), lr.contiguous(), r=1))


def emit_frame_conv(lv3: torch.Tensor, conv, lr: torch.Tensor,
                    roi_hw: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """The frame finish of the runtime models: (state, frame) of
    :func:`emit_frame_conv_ref`. lv3 (N, L, H, W) after the fovea blend;
    ``conv``: ``conv_last`` (L -> C, 3x3, padding 1, bias); lr (N, C, h, w)
    of lv3's dtype.

    CPU tensors take the plain version; CUDA tensors launch kernel C's conv
    route (float32 or bfloat16, L in :data:`CONV_CHANNELS`, C 1 or 3) or
    raise."""
    if lv3.device.type == "cpu":
        return emit_frame_conv_ref(lv3, conv, lr, roi_hw)
    global launches, conv_launches
    w, b = conv.conv.weight, conv.conv.bias
    with span("crfp.kernel.C", {"y": lv3, "lr": lr, "r": 1}) as s:
        n, nl, big_h, big_w = lv3.shape
        c, h, wl = lr.shape[1:]
        wph, wpw = roi_hw
        if not (lv3.is_cuda and lv3.dtype in (_F32, _BF16) and nl in CONV_CHANNELS
                and c in (1, 3) and lr.shape[0] == n and w.shape == (c, nl, 3, 3) and b is not None
                and conv.conv.padding == (1, 1) and conv.conv.stride == (1, 1)
                and 0 < wph <= big_h and 0 < wpw <= big_w
                and all(t.dtype == lv3.dtype and t.device == lv3.device and t.is_contiguous()
                        for t in (lv3, lr, w, b))):
            raise ValueError(f"emit conv route: lv3 {tuple(lv3.shape)} {lv3.dtype}, conv "
                             f"{tuple(w.shape)} {w.dtype}, lr {tuple(lr.shape)} {lr.dtype}, "
                             f"roi {tuple(roi_hw)}: needs lv3 of {CONV_CHANNELS} channels, "
                             "a 3x3 conv with bias to 1 or 3 channels, one float32 or "
                             "bfloat16 type on one card, contiguous, the ROI inside the frame")
        s.note(route="conv")
        out = torch.empty((n, big_h, big_w, c), dtype=lv3.dtype, device=lv3.device)
        state = torch.empty((n, nl, wph, wpw), dtype=lv3.dtype, device=lv3.device)
        _build.launch("emit", "crfp_emit_conv", _CONV_ARGTYPES, lv3.device,
                      lv3.data_ptr(), w.data_ptr(), b.data_ptr(), lr.data_ptr(),
                      out.data_ptr(), state.data_ptr(), n, nl, c, big_h, big_w, h, wl,
                      wph, wpw, int(lv3.dtype is _BF16))
        launches += 1
        conv_launches += 1
    return state, out
