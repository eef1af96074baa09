"""4-zone streaming evaluation: whole / fovea / outskirt / past-fovea
(crfp_tpu/eval/zones.py).

- gaze position per frame: ``x = sigma*randn + W/2, y = sigma*randn + H/2``
  (the reference's Gaussian eye-tracker noise model);
- fovea mask: fv_size^2 window at the gaze (clipped slice semantics);
- outskirt: the fovea mask dilated 10x by a 3x3 kernel, minus the mask;
- past: union of the last 3 outskirt masks;
- regional-DCN gate fg: dcn_size^2 window centred on the fovea.

The mask geometry (:class:`ZoneMasks`, :func:`zone_masks_step`,
:func:`_rect_bounds`) is numpy and scipy, copied from the JAX package; the
two evaluators compute their metrics with ``crfp_torch.ops.metrics`` and
kernel F (``crfp_torch/ops/cuda/ssim.py``) on the device they are given.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from scipy import ndimage

from crfp_torch.ops.cuda.ssim import ssim_map
from crfp_torch.ops.metrics import masked_psnr, masked_ssim

ZONES = ("whole", "fovea", "outskirt", "past")


@dataclasses.dataclass
class ZoneMasks:
    fovea: np.ndarray  # (H, W, 1) float
    mask: np.ndarray  # model input mask (zeros before fv_start)
    outskirt: np.ndarray
    fg: np.ndarray  # regional-computation gate
    top_left: tuple[int, int]


def zone_masks_step(
    h: int,
    w: int,
    gaze_yx: tuple[float, float],
    fv_size: int,
    active: bool = True,
    regional_dcn: bool = False,
    dcn_size: int = 720,
) -> ZoneMasks:
    cy = int(gaze_yx[0]) - fv_size // 2
    cx = int(gaze_yx[1]) - fv_size // 2
    mask = np.zeros((h, w, 1), np.float32)
    if active:
        y0, x0 = max(cy, 0), max(cx, 0)
        mask[y0 : cy + fv_size, x0 : cx + fv_size] = 1.0
    mk_fv = mask.copy()
    y0, x0 = max(cy, 0), max(cx, 0)
    mk_fv[y0 : cy + fv_size, x0 : cx + fv_size] = 1.0

    dil = _dilate(mk_fv[..., 0] > 0, 10)
    outskirt = (dil & ~(mask[..., 0] > 0)).astype(np.float32)[..., None]

    if regional_dcn:
        fg = np.zeros((h, w, 1), np.float32)
        st_x = max(cx + fv_size // 2 - dcn_size // 2, 0)
        ed_x = min(cx + fv_size // 2 + dcn_size // 2, w)
        st_y = max(cy + fv_size // 2 - dcn_size // 2, 0)
        ed_y = min(cy + fv_size // 2 + dcn_size // 2, h)
        fg[st_y:ed_y, st_x:ed_x] = 1.0
    else:
        fg = np.ones((h, w, 1), np.float32)
    return ZoneMasks(fovea=mk_fv, mask=mask, outskirt=outskirt, fg=fg, top_left=(cy, cx))


def _dilate(m: np.ndarray, r: int) -> np.ndarray:
    """``ndimage.binary_dilation(m, 3x3, iterations=r)``, computed over the
    bounding box of ``m`` grown by ``r``, which the dilation does not pass
    (at 720p with a 96-pixel fovea, ~70x fewer pixels than the frame)."""
    out = np.zeros_like(m)
    rows, cols = np.flatnonzero(m.any(1)), np.flatnonzero(m.any(0))
    if rows.size == 0:
        return out
    y0, y1 = max(rows[0] - r, 0), min(rows[-1] + r + 1, m.shape[0])
    x0, x1 = max(cols[0] - r, 0), min(cols[-1] + r + 1, m.shape[1])
    out[y0:y1, x0:x1] = ndimage.binary_dilation(m[y0:y1, x0:x1], np.ones((3, 3), bool),
                                                iterations=r)
    return out


def _rect_bounds(c0: int, size: int, n: int) -> tuple[int, int]:
    """Clipped-Python-slice bounds of ``arr[max(c0,0) : c0+size]`` along an
    axis of length ``n`` (the reference's mask-painting idiom): negative
    stops wrap like Python slices do."""
    start = max(c0, 0)
    stop = c0 + size
    if stop < 0:
        stop = n + stop
    return start, max(min(stop, n), start)


def _new_results() -> dict[str, list[float]]:
    return {f"{m}_{z}": [] for z in ZONES for m in ("psnr", "ssim")}


def _summary(results: dict[str, list[float]]) -> dict[str, float]:
    return {k: float(np.mean(v)) if v else float("nan") for k, v in results.items()}


def _frame(a, device) -> torch.Tensor:
    return torch.as_tensor(a).to(device, torch.float32)


class OnChipZoneEval:
    """4-zone masked PSNR/SSIM of one frame from one pass on the device.

    The masks are rebuilt on the device from scalar rectangle bounds (the
    fovea zone is always a clipped rectangle and its 10x-dilated ring is
    the same rectangle expanded by 10 px and clipped: exact for
    rectangles), the squared error and the SSIM map (one call of kernel
    F's dispatcher) are computed once, and the four zones' masked means
    come back in one transfer. An all-zero mask (``past`` on a clip's
    first frame) is replaced by ones before the division and its values
    dropped, so no 0/0 is ever formed (crfp_tpu/eval/zones.py:134-141).
    ``update`` returns nothing; ``summary`` matches
    :class:`StreamingZoneEval`'s dict shape."""

    MAX_PAST = 3

    def __init__(self, fv_size: int, device: str | torch.device = "cuda"):
        self.fv_size = fv_size
        self.device = torch.device(device)
        self._past: list[np.ndarray] = []  # (4,) int32 outskirt rects y0,y1,x0,x1
        self._inner: list[np.ndarray] = []  # matching model-input-mask rects
        self.results = _new_results()

    def _rects(self, zones: ZoneMasks, h: int, w: int):
        cy, cx = zones.top_left
        f = self.fv_size
        y0, y1 = _rect_bounds(cy, f, h)
        x0, x1 = _rect_bounds(cx, f, w)
        fv_r = np.array([y0, y1, x0, x1], np.int32)
        # dilation of the clipped fovea rect by 10 iterations of 3x3: the
        # rect expanded 10 px per side (empty rects stay empty)
        if y1 > y0 and x1 > x0:
            ring = np.array([max(y0 - 10, 0), min(y1 + 10, h),
                             max(x0 - 10, 0), min(x1 + 10, w)], np.int32)
        else:
            ring = np.zeros((4,), np.int32)
        # the subtracted model-input mask (zeros when inactive)
        inner = fv_r if zones.mask.any() else np.zeros((4,), np.int32)
        return fv_r, ring, inner

    def _metrics(self, sr, gt, fv_r, ring_r, inner_r, past):
        """(8,) tensor: psnr, ssim of whole, fovea, outskirt, past."""
        _, h, w, c = sr.shape
        ys = torch.arange(h, device=sr.device).view(h, 1)
        xs = torch.arange(w, device=sr.device).view(1, w)

        def rect_mask(r):
            y0, y1, x0, x1 = (int(v) for v in r)
            return ((ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)).float()

        ones = torch.ones(h, w, device=sr.device)
        fovea = rect_mask(fv_r)
        outskirt = rect_mask(ring_r) * (1.0 - rect_mask(inner_r))
        past_m = torch.zeros_like(ones)
        for ring, inner in past:
            past_m = torch.maximum(past_m, rect_mask(ring) * (1.0 - rect_mask(inner)))
        masks = torch.stack([ones, fovea, outskirt, past_m])  # (4, h, w)
        nz = masks.sum((1, 2)) > 0
        safe = torch.where(nz.view(4, 1, 1), masks, ones)
        den = safe.sum((1, 2)) * c

        err = ((sr - gt) ** 2).sum(-1)[0]
        smap = ssim_map(sr.permute(0, 3, 1, 2), gt.permute(0, 3, 1, 2)).sum(1)[0]
        mse = (safe * err).sum((1, 2)) / den
        zero_floor = -20.0 * math.log10(math.sqrt((1.0 / 255.0) ** 2 / math.prod(sr.shape)))
        psnr = torch.where(mse == 0, torch.full_like(mse, zero_floor),
                           -20.0 * torch.log10(torch.sqrt(mse)))
        ssim = (safe * smap).sum((1, 2)) / den
        zero = torch.zeros_like(psnr)
        return torch.stack([torch.where(nz, psnr, zero),
                            torch.where(nz, ssim, zero)], dim=1).reshape(-1)

    @torch.no_grad()
    def update(self, sr, gt, zones: ZoneMasks) -> None:
        """sr/gt: (1, H, W, 3) tensors or arrays in [0, 1]."""
        h, w = zones.fovea.shape[:2]
        fv_r, ring, inner = self._rects(zones, h, w)
        n_past = len(self._past)
        vals = self._metrics(_frame(sr, self.device), _frame(gt, self.device),
                             fv_r, ring, inner,
                             list(zip(self._past, self._inner))).cpu().numpy()
        for i, z in enumerate(ZONES):
            if z == "past" and n_past == 0:
                continue
            self.results[f"psnr_{z}"].append(float(vals[2 * i]))
            self.results[f"ssim_{z}"].append(float(vals[2 * i + 1]))
        self._past.append(ring)
        self._inner.append(inner)
        if len(self._past) > self.MAX_PAST:
            self._past.pop(0)
            self._inner.pop(0)

    def new_clip(self) -> None:
        self._past.clear()
        self._inner.clear()

    def summary(self) -> dict[str, float]:
        return _summary(self.results)


class StreamingZoneEval:
    """Accumulates 4-zone PSNR/SSIM over a streamed clip from the host
    masks of :func:`zone_masks_step`: one masked PSNR and one masked SSIM
    per zone and frame."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.results = _new_results()
        self._past: list[np.ndarray] = []

    @torch.no_grad()
    def update(self, sr, gt, zones: ZoneMasks) -> None:
        """sr/gt: (1, H, W, 3) in [0, 1]."""
        sr, gt = _frame(sr, self.device), _frame(gt, self.device)
        ones = np.ones_like(zones.fovea)[None]
        pairs = [("whole", ones), ("fovea", zones.fovea[None]),
                 ("outskirt", zones.outskirt[None])]
        if self._past:
            past = np.clip(np.sum(np.stack(self._past), axis=0), 0, 1)[None]
            pairs.append(("past", past))
        for name, m in pairs:
            m = _frame(m, self.device)
            self.results[f"psnr_{name}"].append(float(masked_psnr(sr, gt, m)))
            self.results[f"ssim_{name}"].append(float(masked_ssim(sr, gt, m)))
        self._past.append(zones.outskirt)
        if len(self._past) > 3:
            self._past.pop(0)

    def new_clip(self) -> None:
        self._past.clear()

    def summary(self) -> dict[str, float]:
        return _summary(self.results)
