"""Plain operations of the reference: resize, shuffle, bilinear sampling,
the flow warp, the modulated deformable conv (DCNv2) by bilinear gather,
the per-cell anchored geometry, and the frame emission.

A frozen copy of the mathematics the benchmarked program computes, in
plain PyTorch, NCHW, float32 sampling. It imports nothing of the program:
the anchored geometry below is a copy of the program's pure-Python
resolution of the cell grid, which is part of the model's mathematics
(which pixels an anchored window samples), not of its implementation.

:func:`recording` collects the shapes and dtypes of every DCN and warp
call made while it is active, so that the benchmark's byte and operation
counts (``benchmark/reference/counts.py``) follow the model's own stage
shapes at a cell's sizes.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

_RECORDER: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "bench_reference_recorder", default=None)


@contextlib.contextmanager
def recording():
    """Collect ``(kind, dict of shapes and dtypes)`` of each DCN and warp
    call inside the block into the yielded list."""
    calls: list = []
    token = _RECORDER.set(calls)
    try:
        yield calls
    finally:
        _RECORDER.reset(token)


def _record(kind: str, **info) -> None:
    calls = _RECORDER.get()
    if calls is not None:
        calls.append((kind, info))


def lrelu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=align_corners)


def upsample(x: torch.Tensor, scale) -> torch.Tensor:
    """``nn.Upsample(scale_factor=scale)``: output size ``floor(in * scale)``."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (math.floor(h * scale), math.floor(w * scale)))


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2, 2)


def bilinear_sample_zeros(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Sample ``x`` (B, C, H, W) at float pixel coordinates ``sy``/``sx``
    (B, *S), zeros outside the frame; (B, C, *S) in float32."""
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


# ---- the anchored geometry (per-cell windows) --------------------------

_VMEM_LIMIT = 15_500_000


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclass(frozen=True)
class Anchor:
    """One anchored call's cell grid: cells of ``band`` x ``xtile`` pixels,
    anchors quantized to ``sub_tile`` rows and ``lane_q`` columns within
    ``±a_y`` / ``±a_x``, residuals clipped to ``±dl_r`` / ``±dl_c``."""

    band: int
    xtile: int
    sub_tile: int
    lane_q: int
    a_y: int
    a_x: int
    dl_r: float
    dl_c: float


def anchor_grid(c: int, o: int, g: int, k: int, window: int, *, bf16: bool,
                shared_taps: bool, has_mask: bool = True, shared_mask: bool = False,
                s2d: int = 1, band: int = 8, xtile: int = 32,
                fullgrad: bool = False) -> Anchor:
    """The cell grid that the model's anchored ops resolve for x of ``c``
    channels in ``g`` groups, an O = ``o``, k x k weight, window ``window``,
    for the requested ``band`` x ``xtile`` (quantized, then shrunk while a
    working-set estimate exceeds a fixed budget); ``bf16``: the activations'
    precision, which sets the row quantum."""
    r, d = s2d, window
    k2 = k * k
    k_off = 1 if shared_taps else k2
    k_mask = 1 if shared_mask else k2
    cpg = c // g
    pad = (k - 1) // 2
    sub_tile = 16 if bf16 else 8
    lane_q = 128 // math.gcd(cpg, 128)
    band_q = sub_tile if r == 1 else math.lcm(sub_tile, r)
    xtile_q = lane_q if r == 1 else math.lcm(lane_q, r)
    band = _round_up(band, band_q)
    xtile = _round_up(xtile, xtile_q)
    a_y = _round_up(d, sub_tile)
    a_x = _round_up(d, lane_q)
    dl_r = max(12, sub_tile // 2 + 8)
    dl_c = max(12, lane_q // 2 + 8)
    halo_r = _round_up(dl_r + pad + 2, sub_tile // 2)
    halo_c = _round_up(dl_c + pad + 2, max(1, lane_q // 2))
    dl_r, dl_c = float(halo_r - pad - 2), float(halo_c - pad - 2)
    item = 2 if bf16 else 4
    l_est = _round_up(2 * k_off + (k_mask if has_mask else 0), sub_tile)

    def estimate(band_e: int, xtile_e: int) -> float:
        p_est = band_e * xtile_e
        wcwin = (xtile_e + 2 * halo_c) * cpg
        hwin = band_e + 2 * halo_r
        cw_bufs = 4 * (k if shared_taps else 1)
        est = (p_est * wcwin * (4 + item + cw_bufs) + p_est * (l_est + o + 8) * 4
               + 2 * hwin * wcwin * item + 2 * k2 * o * wcwin * item)
        grad_f = (2.4 if shared_taps else 1.6) if fullgrad else 1.0
        est = est * (1.75 if shared_taps else 1.33) * grad_f
        if fullgrad:
            est += 2 * (hwin + 2 * a_y) * (wcwin + 2 * a_x * cpg) * 4
        return est

    while band > band_q and estimate(band, xtile) > _VMEM_LIMIT:
        band -= band_q
    xstep = math.lcm(xtile_q, 128 // math.gcd(band, 128))
    xtile = _round_up(xtile, xstep)
    while xtile > xstep and estimate(band, xtile) > _VMEM_LIMIT:
        xtile -= xstep
    return Anchor(band, xtile, sub_tile, lane_q, a_y, a_x, dl_r, dl_c)


def dcn_anchor_grid(c: int, o: int, g: int, k: int, window: int, *, bf16: bool,
                    shared: bool, fullgrad: bool = False) -> Anchor:
    """The anchored DCN's grid: band 32 for bf16 activations (8 for f32),
    xtile 32."""
    return anchor_grid(c, o, g, k, window, bf16=bf16, shared_taps=shared, shared_mask=shared,
                       band=32 if bf16 else 8, xtile=32, fullgrad=fullgrad)


def warp_anchor_grid(c: int, window: int, *, bf16: bool, s2d: int = 1,
                     fullgrad: bool = False) -> Anchor:
    """The anchored warp's grid: the k = 1 DCN with no mask, band 64 x xtile
    32 at full resolution, band 32 under the s2d(4) cell grid."""
    return anchor_grid(c, c, 1, 1, window, bf16=bf16, shared_taps=False, has_mask=False,
                       s2d=s2d, band=64 if s2d == 1 else 32, xtile=32, fullgrad=fullgrad)


def _components(offset: torch.Tensor, groups: int):
    n, ch, h, w = offset.shape
    off = offset.float().reshape(n, groups, ch // (2 * groups), 2, h, w)
    return off[:, :, :, 0], off[:, :, :, 1]


def effective_offsets(offset: torch.Tensor, grid: Anchor, groups: int) -> torch.Tensor:
    """``F + clip(off - F, ±dl)`` per tap, F the quantized mean displacement
    of the pixel's cell: each component clipped to ±(A + dl), averaged over
    the taps and the cell (edge cells over their zero padding), rounded
    half-to-even to its quantum and clipped to ±A. No gradient through F."""
    n, ch, h, w = offset.shape
    nb, nt = -(-h // grid.band), -(-w // grid.xtile)
    pad = (0, nt * grid.xtile - w, 0, nb * grid.band - h)
    dev = offset.device
    rows = torch.arange(h, device=dev) // grid.band
    cols = torch.arange(w, device=dev) // grid.xtile
    eff = []
    comps = _components(offset, groups)
    fixed = _components(offset.detach(), groups)
    for comp, det, a, quant, dl in zip(comps, fixed, (grid.a_y, grid.a_x),
                                       (grid.sub_tile, grid.lane_q), (grid.dl_r, grid.dl_c)):
        m = det.clamp(-(a + dl), a + dl).mean(dim=2)
        m = F.pad(m, pad).reshape(n, groups, nb, grid.band, nt, grid.xtile).mean(dim=(3, 5))
        steps = a // quant
        table = torch.round(m / quant).clamp(-steps, steps) * quant
        f = table.index_select(2, rows).index_select(3, cols)[:, :, None]
        eff.append(f + (comp - f).clamp(-dl, dl))
    return torch.stack(eff, dim=3).reshape(n, ch, h, w)


# ---- warp and DCN --------------------------------------------------------

def flow_warp(x: torch.Tensor, flow: torch.Tensor, window: int | None = None,
              anchor: Anchor | None = None) -> torch.Tensor:
    """Backward warp of ``x`` (N, C, H, W) by ``flow`` (N, 2, H, W), channels
    (dx, dy) in pixels, zeros outside; the flow clamped to ``±window``
    (None: unclamped) or taken at ``anchor``'s effective offsets."""
    n, c, h, w = x.shape
    _record("warp", n=n, c=c, h=h, w=w, x_dtype=x.dtype, grad=torch.is_grad_enabled() and (x.requires_grad or flow.requires_grad))
    flow = flow.float()
    if anchor is not None:
        flow = effective_offsets(flow.flip(1), anchor, 1).flip(1)
    elif window is not None:
        flow = flow.clamp(-float(window), float(window))
    gy = torch.arange(h, device=x.device, dtype=torch.float32).view(1, h, 1)
    gx = torch.arange(w, device=x.device, dtype=torch.float32).view(1, 1, w)
    return bilinear_sample_zeros(x, gy + flow[:, 1], gx + flow[:, 0]).to(x.dtype)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor | None, *,
                  window: int | None = None, shared: bool = False,
                  anchor: Anchor | None = None, fused: bool = False) -> torch.Tensor:
    """Modulated deformable conv, stride 1, 'same' padding. x (N, C, H, W);
    offset (N, G*T*2, H, W), channel ``(g*T + k)*2 + {dy, dx}``, T = 1 when
    ``shared`` (one displacement and one mask a pixel for every tap) else
    kh*kw; mask (N, G*T, H, W). Each tap of each output pixel takes an exact
    bilinear sample at ``p + p_k + offset`` (offset clamped to ``±window``,
    or anchored), scaled by its mask, contracted with the weight; the bias
    is added last. ``fused`` marks a call whose offsets and mask the program
    computes inside the kernel (for the byte count only). Returns x's
    dtype."""
    n, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    k2 = kh * kw
    taps = 1 if shared else k2
    g = offset.shape[1] // (2 * taps)
    _record("dcn", n=n, c=c, h=h, w=w, o=o, g=g, k2=k2, taps=taps, x_dtype=x.dtype,
            fused=fused, grad=torch.is_grad_enabled() and (x.requires_grad or offset.requires_grad))
    cpg = c // g
    if anchor is not None:
        offset = effective_offsets(offset, anchor, g)
    off = offset.float().reshape(n, g, taps, 2, h, w)
    if anchor is None and window is not None:
        off = off.clamp(-float(window), float(window))
    dev = x.device
    ky = (torch.arange(kh, device=dev, dtype=torch.float32) - (kh - 1) // 2
          ).repeat_interleave(kw).view(1, 1, k2, 1, 1)
    kx = (torch.arange(kw, device=dev, dtype=torch.float32) - (kw - 1) // 2
          ).repeat(kh).view(1, 1, k2, 1, 1)
    gy = torch.arange(h, device=dev, dtype=torch.float32).view(1, 1, 1, h, 1)
    gx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, 1, 1, w)
    sy = (gy + ky) + off[:, :, :, 0]
    sx = (gx + kx) + off[:, :, :, 1]
    samp = bilinear_sample_zeros(
        x.reshape(n * g, cpg, h, w),
        sy.expand(n, g, k2, h, w).reshape(n * g, k2, h, w),
        sx.expand(n, g, k2, h, w).reshape(n * g, k2, h, w)).reshape(n, g, cpg, k2, h, w)
    samp = samp * mask.float().reshape(n, g, 1, taps, h, w)
    out = torch.einsum("ngckhw,ogck->nohw", samp, weight.float().reshape(o, g, cpg, k2))
    if bias is not None:
        out = out + bias.float().view(1, o, 1, 1)
    return out.to(x.dtype)


def emit_frame(y: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
    """The output frame ``y + bilinear_upsample(lr)`` to y's size, summed in
    float32 and returned in y's dtype, NCHW."""
    base = resize_bilinear(lr.float(), tuple(y.shape[-2:]))
    return (y.float() + base).to(y.dtype)
