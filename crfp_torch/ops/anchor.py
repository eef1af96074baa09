"""Per-cell anchored windows: the geometry, the anchor table and the
effective offsets of the JAX package's anchored DCN and warp
(crfp_tpu/ops/pallas/dcn.py:816-909, :975-1014, :1261-1290).

Anchoring is math, not a layout. The TPU kernel covers the frame with a
grid of cells (``band`` rows x ``xtile`` columns); each (cell, group)
reads its window of x around the cell's quantized mean displacement, the
anchor, and samples exactly within ``±dl`` of it. For an offset field
``off`` (dy, dx) with window D:

1. each component is clipped to ``±(A + dl)``;
2. averaged over the taps, then over each cell of the grid (edge cells
   average over their zero padding, dividing by the full cell size);
3. rounded half-to-even to the row quantum ``sub_tile`` (16 for bf16 x, 8
   for f32) and the column quantum ``lane_q = 128 // gcd(cpg, 128)``, and
   clipped to ``±A``, ``A = round_up(D, quantum)``: the anchor ``F``;
4. the DCN samples exactly at ``eff = F + clip(off - F, ±dl)``, zeros
   outside the frame.

So the sample reaches up to ``A + dl`` pixels, past ``±D``, and which
pixels it samples depends on the cell grid: the resolved ``band`` and
``xtile`` of the TPU kernel (requested, quantized, then shrunk by its
scoped-VMEM guard), copied here as pure Python from
:func:`anchor_geometry`. Nothing here imports JAX: this is the port's own
copy.

Training resolves another grid: JAX's anchored backward (its
``anchor_vjp``, the model's ``dcn_anchor_vjp``) sizes the cells with the
backward's VMEM factors (``fullgrad``, crfp_tpu/ops/pallas/dcn.py:884-900),
and the forward takes that grid too. Where even the floor geometry is over
the guard, JAX differentiates the same math at the same resolved grid in
XLA (:909-931); the port needs only the grid.

Gradients follow JAX's mirror (:1261-1291): the anchor is flat (a rounded
mean), so :func:`anchor_table` is built without gradient, and
``F + clip(off - F, ±dl)`` passes the offset's gradient where the residual
lies within ±dl and stops it outside. At ``|off - F| == dl`` exactly the
port takes ``torch.clamp``'s convention: the gradient passes (kernel D's
anchored modes do the same); the tests keep their fields off that tie.

Offsets are in the port's packed layout (N, G*T*2, H, W), channel
``(g*T + k)*2 + {0: dy, 1: dx}``; T = 1 under shared taps.
:func:`anchor_table` and :func:`effective_offsets` are the plain versions:
on the card the kernels' anchored calls write the table with a pre-pass
of their own (crfp_torch/csrc/common.cuh::anchor_table_kernel), and the
backward reads the table its forward wrote.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

# the TPU kernel's scoped-VMEM limit that its guard sizes cells against
_VMEM_LIMIT = 15_500_000


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclass(frozen=True)
class AnchorGeometry:
    """The resolved cell grid and margins of one anchored call: cells of
    ``band`` x ``xtile`` full-resolution pixels, anchors quantized to
    ``sub_tile`` rows and ``lane_q`` columns within ``±a_y`` / ``±a_x``,
    residuals clipped to ``±dl_r`` / ``±dl_c``."""

    band: int
    xtile: int
    sub_tile: int
    lane_q: int
    a_y: int
    a_x: int
    dl_r: float
    dl_c: float

    @property
    def reach(self) -> float:
        """The largest |displacement| an anchored sample can take."""
        return max(self.a_y + self.dl_r, self.a_x + self.dl_c)

    def cells(self, h: int, w: int) -> tuple[int, int]:
        """(bands, tiles) of the grid over an h x w frame."""
        return -(-h // self.band), -(-w // self.xtile)



def kernel_args(geom: AnchorGeometry | None) -> tuple:
    """The geometry arguments of the anchored C entries (kernels A, B and
    D's two modes): band, xtile,
    sub_tile, lane_q, a_y, a_x (ints), dl_r, dl_c (floats); zeros for an
    unanchored call."""
    if geom is None:
        return (0, 0, 0, 0, 0, 0, 0.0, 0.0)
    return (geom.band, geom.xtile, geom.sub_tile, geom.lane_q, geom.a_y, geom.a_x,
            geom.dl_r, geom.dl_c)


def anchor_geometry(
    h: int, w: int, c: int, o: int, g: int, k: int, max_displacement: int, *,
    bf16: bool, shared_taps: bool, has_mask: bool = True, shared_mask: bool = False,
    s2d: int = 1, band: int = 8, xtile: int = 32, fullgrad: bool = False,
) -> AnchorGeometry:
    """The anchored geometry that crfp_tpu/ops/pallas/dcn.py:816-909
    resolves for x of ``c`` channels in ``g`` groups over an ``h`` x ``w``
    frame (logical, full resolution), an O = ``o``, ``k`` x ``k`` weight,
    window ``max_displacement``, for the requested ``band`` x ``xtile``;
    ``s2d``: the operands' space-to-depth factor r, which sets the quanta
    of the request; ``fullgrad``: the backward's VMEM factors (training)."""
    r, d = s2d, max_displacement
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

    def vmem_est(band_e: int, xtile_e: int) -> float:
        p_est = band_e * xtile_e
        wcwin_est = (xtile_e + 2 * halo_c) * cpg
        hwin_est = band_e + 2 * halo_r
        cw_bufs = 4 * (k if shared_taps else 1)
        est = (p_est * wcwin_est * (4 + item + cw_bufs)
               + p_est * (l_est + o + 8) * 4
               + 2 * hwin_est * wcwin_est * item
               + 2 * k2 * o * wcwin_est * item)
        grad_f = (2.4 if shared_taps else 1.6) if fullgrad else 1.0
        est = est * (1.75 if shared_taps else 1.33) * grad_f
        if fullgrad:
            est += 2 * (hwin_est + 2 * a_y) * (wcwin_est + 2 * a_x * cpg) * 4
        return est

    while band > band_q and vmem_est(band, xtile) > _VMEM_LIMIT:
        band -= band_q
    xstep = math.lcm(xtile_q, 128 // math.gcd(band, 128))
    xtile = _round_up(xtile, xstep)
    while xtile > xstep and vmem_est(band, xtile) > _VMEM_LIMIT:
        xtile -= xstep
    return AnchorGeometry(band, xtile, sub_tile, lane_q, a_y, a_x, dl_r, dl_c)


def dcn_geometry(h: int, w: int, c: int, o: int, g: int, k: int, max_displacement: int, *,
                 bf16: bool, shared_taps: bool, shared_mask: bool,
                 s2d: int = 1, fullgrad: bool = False) -> AnchorGeometry:
    """The anchored DCN's geometry for the request of
    crfp_tpu/nn/align.py:59: band 32 in bf16 (band 8 for f32 x), xtile 32;
    ``fullgrad``: the training grid (the backward's VMEM factors), else the
    inference one."""
    return anchor_geometry(h, w, c, o, g, k, max_displacement, bf16=bf16,
                           shared_taps=shared_taps, shared_mask=shared_mask, s2d=s2d,
                           band=32 if bf16 else 8, xtile=32, fullgrad=fullgrad)


def warp_geometry(h: int, w: int, c: int, max_displacement: int, *, bf16: bool,
                  s2d: int = 1, fullgrad: bool = False) -> AnchorGeometry:
    """The anchored warp's geometry: the k = 1 DCN with an identity weight
    and no mask, band 64 x xtile 32 at full resolution
    (crfp_tpu/ops/pallas/warp.py:48-52), band 32 x xtile 32 in the s2d(4)
    form (:84-86); ``s2d`` is 1 or that r; ``fullgrad``: the training
    grid."""
    return anchor_geometry(h, w, c, c, 1, 1, max_displacement, bf16=bf16, shared_taps=False,
                           has_mask=False, s2d=s2d, band=64 if s2d == 1 else 32, xtile=32,
                           fullgrad=fullgrad)


def _components(offset: torch.Tensor, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dy, dx) of ``offset`` (N, G*T*2, H, W), each float32 (N, G, T, H, W)."""
    n, ch, h, w = offset.shape
    off = offset.float().reshape(n, groups, ch // (2 * groups), 2, h, w)
    return off[:, :, :, 0], off[:, :, :, 1]


def hr_warp_geometry(x: torch.Tensor, window: int | None, anchor: bool,
                     s2d: int = 1, fullgrad: bool = False) -> AnchorGeometry | None:
    """The HR state warp's anchored geometry for x (N, C, H, W), or None for
    the ±window clamp: None unless ``anchor`` and a ``window``
    (crfp_tpu/models/runtime.py:190-205; ``s2d``: the JAX model's s2d(4)
    tail or its plain one; ``fullgrad``: the training grid,
    crfp_tpu/models/crfp.py:314-335)."""
    if not anchor or window is None:
        return None
    _, c, h, w = x.shape
    return warp_geometry(h, w, c, window, bf16=x.dtype == torch.bfloat16, s2d=s2d,
                         fullgrad=fullgrad)


def anchor_table(offset: torch.Tensor, geom: AnchorGeometry, groups: int) -> torch.Tensor:
    """The quantized anchors of ``offset`` (N, G*T*2, H, W), float32
    (N, G, bands, tiles, 2) as (dy, dx): each component clipped to
    ±(A + dl), averaged over the T taps and over each cell (edge cells over
    their zero padding), rounded half-to-even to its quantum and clipped to
    ±A (crfp_tpu/ops/pallas/dcn.py:975-994). PyTorch ops on the offset's
    device, with no host transfer (a CUDA graph may capture them); no
    gradient (the anchors are flat in the offsets)."""
    offset = offset.detach()
    n, _, h, w = offset.shape
    nb, nt = geom.cells(h, w)
    pad = (0, nt * geom.xtile - w, 0, nb * geom.band - h)
    out = []
    for comp, a, quant, dl in zip(_components(offset, groups), (geom.a_y, geom.a_x),
                                  (geom.sub_tile, geom.lane_q), (geom.dl_r, geom.dl_c)):
        m = comp.clamp(-(a + dl), a + dl).mean(dim=2)  # (n, g, h, w)
        m = torch.nn.functional.pad(m, pad)
        m = m.reshape(n, groups, nb, geom.band, nt, geom.xtile).mean(dim=(3, 5))
        steps = a // quant
        out.append(torch.round(m / quant).clamp(-steps, steps) * quant)
    return torch.stack(out, dim=-1)


def effective_offsets(offset: torch.Tensor, geom: AnchorGeometry, groups: int) -> torch.Tensor:
    """Where the anchored DCN samples: ``F + clip(off - F, ±dl)`` per tap,
    float32 in ``offset``'s packed layout (N, G*T*2, H, W), F the anchor of
    the cell that holds the pixel; the exact DCN at these offsets is the
    anchored DCN (crfp_tpu/ops/pallas/dcn.py:1261-1290,
    ``_anchored_effective_offsets``). Differentiable in ``offset``: 1 where
    ``|off - F| <= dl``, 0 outside (the module's note on the tie)."""
    n, ch, h, w = offset.shape
    table = anchor_table(offset, geom, groups)
    dev = offset.device
    rows = torch.arange(h, device=dev) // geom.band  # each pixel's cell
    cols = torch.arange(w, device=dev) // geom.xtile
    eff = []
    for i, (comp, dl) in enumerate(zip(_components(offset, groups), (geom.dl_r, geom.dl_c))):
        f = table[..., i].index_select(2, rows).index_select(3, cols)[:, :, None]
        eff.append(f + (comp - f).clamp(-dl, dl))
    return torch.stack(eff, dim=3).reshape(n, ch, h, w)


def flow_as_offset(flow: torch.Tensor) -> torch.Tensor:
    """A warp's flow (N, 2, H, W) as (dx, dy) -> the k = 1 DCN's offset (N,
    2, H, W) as (dy, dx), float32."""
    return flow.float().flip(1)
