"""Kernel A and D dispatcher: windowed modulated deformable conv, forward
and backward.

Forward: replaces ``crfp_tpu/ops/pallas/dcn.py::_dcn_kernel`` (:59,
``pallas_call`` in ``_fwd_call`` :493; entries ``deform_conv2d_pallas`` :716
and ``deform_conv2d_pallas_vjp`` :1359) with ``crfp_torch/csrc/dcn_fwd.cu``.
The TPU kernel builds 2-sparse interpolation matrices per window so that
its matrix unit does the gathers; Hopper gathers natively. The CUDA kernel
is one tiled routine (``crfp_torch/csrc/common.cuh``), shared with kernel E
(``csrc/dcn_fused.cu``, ``ops/cuda/dcn_fused.py``): a pre-pass packs x per
group, pixel-major (zero-padded for a clamped call), into scratch that the
wrapper allocates; then blocks own tiles of pixels with all O outputs on a
persistent grid, stage the weight once, and contract bf16 x on the tensor
cores (``mma.sync``), f32 x and dcn_3 on the CUDA cores. :func:`tile_plan`
picks the tile and the padding; both dispatchers pass it to their C entry.

Backward: replaces ``_dcn_bwd_kernel`` (:219, ``pallas_call`` in
``_bwd_call`` :593, reached through ``deform_conv2d_pallas_vjp``'s custom
VJP :1412-1418; anchored :581, through ``_core_op_anchored`` :673-713) with
``crfp_torch/csrc/dcn_bwd.cu``, behind a
``torch.autograd.Function``: dx, d-offset, d-mask and dW from the kernel,
db as a reduction of the output gradient (the TPU adds it outside the
kernel body too, :1139). Each call launches three kernels: the pre-pass
that packs x as kernel A's does and zeroes a packed f32 dx accumulator,
the tiled kernel (a thread per (pixel, group) of a tile, dx by one vector
atomic per corner, dW summed per block in registers), and an epilogue that
unpacks dx into x's dtype and sums the blocks' dW partials in a fixed
order. :func:`bwd_plan` picks the tile, the padding and the grid; the
wrapper allocates the scratch. The Function survives recomputation under
``torch.utils.checkpoint(use_reentrant=False)``; it has no second
derivative.

Bound on the H100 at the main-path shapes (bytes, see the source notes):
per-tap dcn_0/1/2 at (1, 32, 180, 180) bf16 with f32 offsets and masks
moves 32 MB forward (~9.6 us at 3.35 TB/s); shared-tap dcn_3 at (1, 4,
720, 720) 14.5 MB (~4.3 us). Its contraction, 0.6 GFLOP per per-tap call,
would take ~9 us on the CUDA cores in f32 and ~0.6 us on the tensor cores
in bf16. At the training shapes (B 2, GT 192) the backward moves 8.8 MB
per per-tap call and 3.5 MB per dcn_3 call.

The widths are two pure rules. :func:`width_fault` refuses only what the
JAX package refuses too: ``C % G != 0`` (crfp_tpu/ops/pallas/dcn.py:815,
:1705) and kernel E on shared taps (E is per-tap there as well). Every other
width runs on the card through one of two routes, which
:func:`width_route` picks and the plans record (``TilePlan.route``,
``BwdPlan.route``). The tuned routes keep the widths they were written for:
every DCN stage of the v18 models at mid 16 and mid 32 (A, D, E), and the
pyramids' and PCD's per-tap DCNs at O = 64 (A only). The general route
(``csrc/common.cuh::dcn_tiles_general``, ``csrc/dcn_bwd.cu``'s
``crfp_dcn_bwd_general``) takes all the others: any C with ``C % G == 0``,
any O, any kh x kw, per-tap, shared taps and anchored shared taps, f32 or
bf16 x, each size a runtime value; so ``--mid_channels``, ``--dg_num`` and
``--dcn_kernel`` run on the card at every value the JAX kernels take. It
packs x with each group's channels padded to whole 4-16 byte loads
(:func:`gen_cpgp`), checks each corner against the frame once, and runs
one of three branches (:data:`GEN_BRANCHES`), which the plan picks and
records: ``general/pixel`` (A and E at O <= 8, every dcn_3 of the flags: a
thread a pixel with its sums in registers; D at every width whose shared
memory fits: a thread a (pixel, group), the output gradient and the weight
staged, dx by one vector atomic a corner), ``general/mma`` (A and E on bf16
x at O > 8: the weight staged once per block in bf16, the modulated
samples rounded to bf16 as the TPU kernel rounds them into U, the
contraction on the tensor cores) and ``general/chunked`` (the rest: K in
chunks of 64 rows; A and E stage the weight once a block where it fits in
half the shared memory, else a chunk's rows a tile through at most 40 KB,
so nothing is refused for want of it). Its times stand
beside the tuned routes' in PERF.md. ``plan=`` may name it at a tuned width
(``tile_plan(..., route="general")``, and a branch with ``branch=``), which
is how the tests and ``chip_smoke.py`` hold the routes against each other.

At O = 64 bf16 x
(C = 64) runs on the tensor cores: tiles of 64 pixels a block of 8 warps,
the modulated samples of one tap at a time in U (a wide group's corner
one coalesced 32-128 byte copy across lanes, ``cp.async`` into shared
memory), each tap contracted with ``mma.sync`` while the next tap's
corners are in flight; 114,688 bytes of shared memory (the bf16 weight,
the corners' staging area and U), two blocks an SM. Its bound is
bytes (0.100 ms at (1, 64, 720, 1280)), its contraction 0.069 ms at the
bf16 tensor-core peak. f32 x at O = 64 stays on the CUDA cores: the
pixel's 64 sums in registers, each tap's corners read 16 bytes of
channels at a time; one block of 256 threads an SM, its f32 weight of
C x 9 x 64 x 4 = 147,456 bytes at C = 64 in shared memory.

Anchored (``anchor``, an :class:`crfp_torch.ops.anchor.AnchorGeometry`;
shared taps, dcn_3's mode, or per-tap, ``DCNAlign(anchor=True)`` as a
per-tap stage, which no model of the JAX package sets): the per-cell
anchored windows of the TPU kernel (``anchor=True``,
crfp_tpu/ops/pallas/dcn.py:771-780, :975-1014), trained as JAX's
``anchor_vjp`` trains them, on every route and width. A pre-pass of the
forward call (``csrc/common.cuh::anchor_table_kernel``, a block per cell;
its plain version is :func:`crfp_torch.ops.anchor.anchor_table`, as JAX
computes the table outside its kernel) writes the cells' anchors, each the
mean over its cell's pixels and their taps, into a table from the wrapper;
kernel A's prologue reads, per pixel, the anchor of the TPU cell that holds
it and clips each tap's residual to ±dl where it clamps to ±D otherwise.
Under shared taps the packed planes' zero border is sized from the anchored
reach ``A + dl`` (61 pixels for dcn_3 in bf16 at D = 32) instead of D; a
per-tap call's reach is as large at D = 8 (the column quantum of 4
channels a group is 32 pixels), and there the corners are frame-checked
(pad 0, :func:`border`). The backward
takes exactly the forward's anchors: the autograd Function saves the table
that the forward's pre-pass wrote (``save_for_backward``, so a
``torch.utils.checkpoint`` recomputation writes it again, with the same
bits) and kernel D's anchored mode reads it, samples where A sampled, and
passes each tap's d-offset only where ``|off_k - F| <= dl``. Its padding is
A's. The tuned routes run per-tap anchored calls in instantiations of their
own (the clamped calls keep their code) at the per-tap stages' widths, O >=
16 with per-tap masks; :func:`width_route` sends the others to the general
route.

Layouts are those of :func:`crfp_torch.ops.dcn_windowed.deform_conv2d_windowed_ref`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable
from torch.overrides import handle_torch_function, has_torch_function

from crfp_torch.ops.anchor import AnchorGeometry, kernel_args
from crfp_torch.ops.cuda import _build
from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref
from crfp_torch.trace import span

# launches of the CUDA kernels (not of the plain version): A forward, D
# backward; anchor_launches and bwd_anchor_launches: A's and D's anchored
# launches, general_launches and bwd_general_launches: their general
# route's, each also in `launches` and `bwd_launches`; tap_anchor_launches
# and bwd_tap_anchor_launches: the per-tap ones among the anchored launches;
# wide_launches: A's on its tuned O = 64 routes (the pyramids', PCD's), also
# in `launches`
launches = 0
bwd_launches = 0
anchor_launches = 0
bwd_anchor_launches = 0
general_launches = 0
bwd_general_launches = 0
tap_anchor_launches = 0
bwd_tap_anchor_launches = 0
wide_launches = 0

# The widths of the tuned routes of csrc/dcn_fwd.cu (A), dcn_bwd.cu (D) and
# dcn_fused.cu (E), each {O: channels a group}, 3x3 weights. Every DCN stage
# of the v18 models at mid 16 and mid 32 (dcn_0/1/2: O = mid, 8 groups;
# dcn_3: O = mid / 8, one group), 2 or 4 channels a group, in A, D and E (E
# runs dcn_0/1/2 only); and in A alone, per-tap, the pyramids' and PCD's
# DCNs at mid / nf 64: O = 64 with 4, 16 and 64 channels a group
# (deformable groups 16, 4 and 1) and 8 (PCD's 8 groups). Every other width
# takes the general route.
SUPPORTED_OUT_CHANNELS = (2, 4, 16, 32)
SUPPORTED_CHANNELS_PER_GROUP = (2, 4)
FUSED_OUT_CHANNELS = (16, 32)
WIDE_OUT_CHANNELS = 64
WIDE_CHANNELS_PER_GROUP = (4, 8, 16, 64)
_WIDTHS = {
    "dcn_fwd": {**{o: SUPPORTED_CHANNELS_PER_GROUP for o in SUPPORTED_OUT_CHANNELS},
                WIDE_OUT_CHANNELS: WIDE_CHANNELS_PER_GROUP},
    "dcn_bwd": {o: SUPPORTED_CHANNELS_PER_GROUP for o in SUPPORTED_OUT_CHANNELS},
    "dcn_fused": {o: SUPPORTED_CHANNELS_PER_GROUP for o in FUSED_OUT_CHANNELS},
}
# D's tuned block takes 256 / G pixels, a thread per (pixel, group)
BWD_GROUPS = (1, 2, 4, 8)
# the routes a plan records
ROUTES = ("tuned", "general")
# the C entries of each kernel's two routes
_ENTRIES = {"dcn_fwd": {"tuned": "crfp_dcn_fwd", "general": "crfp_dcn_fwd_general"},
            "dcn_bwd": {"tuned": "crfp_dcn_bwd", "general": "crfp_dcn_bwd_general"},
            "dcn_fused": {"tuned": "crfp_dcn_fused", "general": "crfp_dcn_fused_general"}}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float] + \
    [ctypes.c_int] * 8 + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + \
    [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + \
    [ctypes.c_int] * 7 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=256)
def width_fault(kernel: str, c: int, o: int, g: int, kh: int, kw: int, *,
                shared: bool = False) -> str | None:
    """Why ``kernel`` ("dcn_fwd": A, "dcn_bwd": D, "dcn_fused": E) does not
    take a DCN of ``c`` input and ``o`` output channels in ``g`` groups
    with a ``kh`` x ``kw`` weight (``shared``: one offset or mask per pixel
    and group, dcn_3), or None when it does. It refuses only what the JAX
    package refuses too: channels that the groups do not divide
    (crfp_tpu/ops/pallas/dcn.py:815, :1705: ``assert c % g == 0``) and
    kernel E on shared taps (the TPU's fused kernel takes 2 * kh * kw offset
    channels a group, per-tap, :1701). Every width it takes runs through
    :func:`width_route`'s route. Pure: it reads no tensor and no device, so
    its answers are cached."""
    if min(c, o, kh, kw) < 1:
        return f"C = {c}, O = {o}, {kh}x{kw} weight: every size must be at least 1"
    if g < 1 or c % g:
        return (f"{c} channels in {g} groups: the groups must divide the channels "
                f"(C % G == 0, as the TPU kernel asserts)")
    if shared and kernel == "dcn_fused":
        return "per-tap offsets and masks only (kernel E, as the TPU's fused kernel)"
    return None


@functools.lru_cache(maxsize=256)
def _tuned_fault(kernel: str, c: int, o: int, g: int, kh: int, kw: int,
                 shared: bool, bf16: bool, tap_anchor: bool = False) -> str | None:
    """Why the tuned route of ``kernel`` does not take this width for x of
    this dtype (the table above), or None when it does; ``tap_anchor``: a
    per-tap anchored call, which the tuned routes take at the per-tap
    stages' widths, O >= 16 with per-tap masks (their instantiations of
    their own; the O <= 4 widths are dcn_3's)."""
    if tap_anchor and (o < 16 or shared):
        return (f"per-tap anchored at O = {o}{' with a shared mask' if shared else ''} "
                f"(O >= 16, per-tap masks)")
    if (kh, kw) != (3, 3):
        return f"weight {kh}x{kw} (3x3 only)"
    widths = _WIDTHS[kernel]
    if o not in widths:
        return f"O = {o} output channels (one of {tuple(widths)})"
    if g < 1 or c % g or c // g not in widths[o]:
        return (f"{c} channels in {g} groups: {c / max(g, 1):g} channels per group "
                f"(one of {widths[o]} at O = {o})")
    if shared and (kernel == "dcn_fused" or o == WIDE_OUT_CHANNELS):
        return f"per-tap offsets and masks only (at O = {o})"
    if bf16 and o == WIDE_OUT_CHANNELS and c != _WIDE_C:
        return f"bf16 x at O = {o}: {_WIDE_C} input channels only (the tensor cores), not {c}"
    if kernel == "dcn_bwd":
        if g not in BWD_GROUPS:
            return f"{g} groups (one of {BWD_GROUPS})"
        if BWD_THREADS % _dw_blocks(c, o):
            return f"{_dw_blocks(c, o)} dW blocks do not divide {BWD_THREADS} threads"
        if _bwd_smem_bytes(c, o, g) > MAX_SMEM:
            return f"{_bwd_smem_bytes(c, o, g)} bytes of shared memory > {MAX_SMEM}"
    return None


# The route of every call whose plan names none: None, the rule's
# (width_route); "general" sends the tuned widths down the general route
# too, a whole model at once (chip_smoke.py's control at mid 32).
forced_route: str | None = None

def border(max_displacement: float | None, anchor: AnchorGeometry | None = None,
           shared_taps: bool = False) -> float | None:
    """The displacement that sizes a tuned route's zero border
    (:func:`tile_plan`, :func:`bwd_plan`): the clamp's ``max_displacement``,
    the anchored reach under shared taps, or None (no border, every corner
    checked) for a per-tap anchored call. At the per-tap stages' D = 8 the
    reach is 61 pixels at 4 channels a group (the columns' quantum is 32),
    which grows the packed planes 2.35x at (1, 32, 180, 180) and 6.7x at
    (2, 32, 48, 48); frame-checked corners read faster at every width
    measured on the H100 (PERF.md), and the tuned routes take no other
    per-tap anchored plan (:func:`check_route`)."""
    if anchor is None:
        return max_displacement
    return anchor.reach if shared_taps else None


def width_route(kernel: str, c: int, o: int, g: int, kh: int, kw: int, *,
                shared: bool = False, bf16: bool = False, tap_anchor: bool = False) -> str:
    """The route of ``kernel`` for this width and x's dtype (``bf16``):
    "tuned" where the tuned route's table has it, else "general" (or
    :data:`forced_route`); ``tap_anchor``: for a per-tap anchored call.
    Raises ValueError with :func:`width_fault`'s reason where the kernel
    does not take it. The one route rule: the dispatchers' default plans
    take their route from it."""
    check_tiled(kernel, c, g, kh, kw, o, shared)
    if forced_route is not None:
        return forced_route
    return "tuned" if _tuned_fault(kernel, c, o, g, kh, kw, bool(shared), bool(bf16),
                                   bool(tap_anchor)) is None else "general"


def _check(x, offset, mask, weight, bias, shared_taps, shared_mask) -> int:
    """Validate the kernel's operands; returns the group count G."""
    if x.device.type != "cuda":
        raise ValueError(f"dcn_fwd: x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"dcn_fwd: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} must be 4-D")
    n, c, h, w = x.shape
    o, wc, kh, kw = weight.shape
    k2 = kh * kw
    taps = 1 if shared_taps else k2
    mtaps = 1 if shared_mask else k2
    if wc != c:
        raise ValueError(f"dcn_fwd: weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    g = offset.shape[1] // (2 * taps) if offset.dim() == 4 else 0
    if g < 1 or c % g or offset.shape != (n, g * taps * 2, h, w):
        raise ValueError(f"dcn_fwd: offset {tuple(offset.shape)} does not fit x "
                         f"{tuple(x.shape)} with {taps} tap(s) per group")
    if mask.shape != (n, g * mtaps, h, w):
        raise ValueError(f"dcn_fwd: mask {tuple(mask.shape)} != {(n, g * mtaps, h, w)}")
    if bias is not None and bias.shape != (o,):
        raise ValueError(f"dcn_fwd: bias {tuple(bias.shape)} != ({o},)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dcn_fwd: x dtype {x.dtype} (float32 or bfloat16)")
    for name, t in (("offset", offset), ("mask", mask), ("weight", weight),
                    ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"dcn_fwd: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"dcn_fwd: {name} on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("offset", offset), ("mask", mask),
                    ("weight", weight), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"dcn_fwd: {name} must be contiguous")
    return g


# ---- the tile plan of kernels A and E ------------------------------------

# CUDA-core path (f32 x, dcn_3, a shared mask): tiles (rows, columns) of
# output pixels per block, one thread per pixel, largest first; the plan
# takes the first that fills every SM with its resident blocks
# (_min_blocks), else the last.
TILE_SHAPES = ((8, 32), (4, 32), (4, 16), (2, 16))
# the pixels a tile of the general route's pixel branch may hold (a thread
# each; TILE_SHAPES by default)
TILE_SHAPES_PIXELS = tuple(range(32, 257, 32))
# Tensor-core path (bf16 x, O = 32, per-tap mask): 32 pixels a block of 8
# warps (one per group); the plan takes the shape with the fewest tiles
# (the least ragged edge), (1, 32) on a tie: 48-wide planes take (2, 16).
MMA_TILE_SHAPES = ((1, 32), (2, 16))
# Tensor-core path at O = 64 (bf16 x, C = 64, per-tap): 64 pixels a block
# of 8 warps; the plan takes the shape with the fewest tiles, the first on
# a tie. (4, 16) first: the fastest at 16 and 64 channels a group and for
# PCD in `python -m crfp_torch.bench.dcn_tiles --wide` on the H100 (1-4 %
# over (2, 32), 3-5 % over (1, 64); PERF.md).
WIDE_MMA_TILE_SHAPES = ((4, 16), (2, 32), (1, 64))
SM_COUNT = 132  # H100 SXM
MAX_SMEM = 232448  # the H100's 227 KB a block
_TAPS, _MMA_O, _OUT_STRIDE = 9, 32, 36
# the O = 64 tensor-core path's tile (pixels) and input channels
# (csrc/common.cuh::kWidePix, kWideC)
_WIDE_PIX, _WIDE_C = 64, 64
# The general route (csrc/common.cuh::kGenPix, kGenRows, kGenOuts,
# kGenPixO): its branches, in the order of csrc/common.cuh::GenBranch. A
# plan names one (TilePlan.branch, BwdPlan.branch: "general/<branch>"):
#  - "pixel": A and E at O <= 8 (every dcn_3 of the flags), a thread per
#    pixel of a TILE_SHAPES tile with its sums in registers; D at any O where
#    its shared memory fits, a thread per (pixel, group) of a tile of
#    32-256 pixels;
#  - "mma": A and E on bf16 x at O > 8 without a shared mask, tiles of 32
#    pixels, the weight staged once per block, the contraction on the
#    tensor cores;
#  - "chunked": every other width: K in chunks of 64 rows; in A and E the
#    whole weight staged once a block where it fits (_gen_smem_bytes), else
#    a chunk's rows a tile through at most 40 KB of shared memory.
# The chunked and mma tiles: 32 pixels, the shape with the fewest tiles,
# (1, 32) on a tie.
GEN_BRANCHES = ("chunked", "pixel", "mma")
GEN_TILE_SHAPES = ((1, 32), (2, 16))
_GEN_PIX, _GEN_ROWS, _GEN_OUTS, _GEN_PIX_O, _GEN_THREADS = 32, 64, 128, 8, 256
# kernel D's chunked branch: S [64][32], U [64][33] and a split pair's sums
# [32][3], f32 (csrc/dcn_bwd.cu::gen_bwd_smem_bytes)
_GEN_BWD_SMEM = 4 * (_GEN_ROWS * _GEN_PIX + _GEN_ROWS * (_GEN_PIX + 1) + 3 * _GEN_PIX)
# its dW partials (grid x O x C x kh x kw f32) are kept under this many
# elements (64 MB) by a smaller grid
_GEN_DW_PARTIALS = 1 << 24
# an SM's shared memory, of which each resident block takes 1 KB more
_SM_SMEM = 233472


def gen_cpgp(cpg: int) -> int:
    """Channels of a packed pixel of the general route for ``cpg`` channels
    a group (``csrc/common.cuh::gen_cpgp``): 2 up to 2, 4 up to 4, then a
    multiple of 8, zeros in the padding; the same for f32 and bf16 x."""
    return 2 if cpg <= 2 else 4 if cpg <= 4 else -(-cpg // 8) * 8


def _min_blocks(mma: bool, o: int) -> int:
    """Resident blocks an SM (``csrc/common.cuh::min_blocks``): on the
    tensor-core path 3 at O = 32 and 2 at O = 64; on the CUDA cores 3 at
    O < 32, 1 at O >= 32."""
    if mma:
        return 2 if o == WIDE_OUT_CHANNELS else 3
    return 3 if o < _MMA_O else 1


@dataclass(frozen=True)
class TilePlan:
    """How kernel A or E covers an (N, C, H, W) call: tiles of ``tile_h``
    x ``tile_w`` pixels (a block of one thread per pixel, or on the
    tensor-core path 8 warps on 32 pixels, 64 at O = 64); ``pad`` pixels of zeros around
    the packed planes of x (a clamped call: ceil(D) + 1, so that no corner
    needs a frame check; 0: corners checked); ``smem_bytes`` of dynamic
    shared memory (``csrc/common.cuh::smem_bytes``); ``mma``: the bf16
    contraction on the tensor cores; ``route``: "tuned" (those routes) or
    "general" (pad 0: every corner checked), ``branch`` the general route's
    branch ("general/pixel", "general/mma" or "general/chunked";
    :data:`GEN_BRANCHES`), with ``cpg`` channels a group packed as ``cpgp``
    (:func:`gen_cpgp`)."""

    tile_h: int
    tile_w: int
    pad: int
    smem_bytes: int
    mma: bool
    tiles_y: int
    tiles_x: int
    route: str = "tuned"
    branch: str = "tuned"
    cpg: int = 0
    cpgp: int = 0

    def args(self) -> tuple[int, int, int, int, int]:
        """The C entries' plan arguments: tile, padding, shared memory and
        the branch's index in :data:`GEN_BRANCHES` (0 on a tuned route)."""
        return self.tile_h, self.tile_w, self.pad, self.smem_bytes, _branch_code(self.branch)

    def packed_numel(self, n: int, c: int, h: int, w: int) -> int:
        """Elements of the scratch the pre-pass packs x into: its planes
        carry ``pad`` pixels of zeros below and ``pad + 1`` above
        (``csrc/common.cuh::padded``); a general plan's pixels ``cpgp``
        channels a group."""
        if self.route == "general":
            return n * (c // self.cpg) * self.cpgp * h * w
        ext = 2 * self.pad + 1 if self.pad else 0
        return n * c * (h + ext) * (w + ext)


def _branch_code(branch: str) -> int:
    """The C entries' branch argument: a general branch's index in
    :data:`GEN_BRANCHES`, 0 for "tuned"."""
    return 0 if branch == "tuned" else GEN_BRANCHES.index(branch.split("/")[1])


def _smem_bytes(mma: bool, c: int, o: int) -> int:
    """``csrc/common.cuh::smem_bytes``. Tensor-core path at O = 32: the
    bf16 weight and U, [32][K + pad] each, and the f32 output tile; at O =
    64: the bf16 weight [64][K], the corners' staging area [4][64][C] and
    U [64][C] (swizzled, not padded); CUDA-core path: the f32 weight."""
    ks = (_TAPS * c + 15) // 16 * 16 + 8
    if mma and o == WIDE_OUT_CHANNELS:
        return o * _TAPS * c * 2 + 5 * _WIDE_PIX * c * 2
    if mma:
        return 2 * 32 * ks * 2 + 32 * _OUT_STRIDE * 4
    return c * _TAPS * o * 4


def _gen_smem_bytes(c: int, o: int, k2: int) -> int:
    """``csrc/common.cuh::gen_smem_bytes``: the chunked branch's U [64][32]
    and its weight rows, f32, opw = O rounded up to 4, at most 128: the
    whole weight [C k2][opw] where O <= 128 and it fits beside U in half
    of :data:`MAX_SMEM` (two blocks an SM), else a chunk's rows [64][opw]
    (40 KB at most, whatever the widths)."""
    opw = min(-(-o // 4) * 4, _GEN_OUTS)
    whole = o <= _GEN_OUTS and 4 * (_GEN_ROWS * _GEN_PIX + c * k2 * opw) <= MAX_SMEM // 2 - 1024
    return 4 * (_GEN_ROWS * _GEN_PIX + (c * k2 if whole else _GEN_ROWS) * opw)


def _gen_pixel_smem(c: int, k2: int) -> int:
    """The pixel branch of A and E: the f32 weight [C k2][8] and the taps'
    places, int2 [k2] (``csrc/common.cuh::gen_pixel_smem_bytes``)."""
    return 4 * c * k2 * _GEN_PIX_O + 8 * k2


def _gen_mma_smem(c: int, o: int, g: int, k2: int) -> int:
    """The mma branch: the bf16 weight [O8][KS] and U [32][KS], O8 = O
    rounded up to 8, KS = G k2 cpgp rounded up to 16, plus 8, and the
    table of its sample rows, int4 [G k2 max(1, cpgp / 8)]
    (``csrc/common.cuh::gen_mma_smem_bytes``)."""
    cpgp = gen_cpgp(c // g)
    ks = -(-g * k2 * cpgp // 16) * 16 + 8
    return 2 * (-(-o // 8) * 8 + _GEN_PIX) * ks + 16 * g * k2 * max(1, cpgp // 8)


def _gen_fwd_fault(branch: str, c: int, o: int, g: int, k2: int, bf16: bool,
                   shared_mask: bool) -> str | None:
    """Why the general route's ``branch`` of A or E does not take this width
    (``csrc/common.cuh::check_gen_plan``), or None when it does."""
    if branch == "pixel":
        if o > _GEN_PIX_O:
            return f"the pixel branch takes O <= {_GEN_PIX_O}, not {o}"
        smem = _gen_pixel_smem(c, k2)
    elif branch == "mma":
        if not bf16 or shared_mask:
            return "the mma branch takes bf16 x and no shared mask"
        smem = _gen_mma_smem(c, o, g, k2)
    elif branch == "chunked":
        smem = _gen_smem_bytes(c, o, k2)
    else:
        return f"branch {branch!r} (one of {GEN_BRANCHES})"
    if smem > MAX_SMEM:
        return f"the {branch} branch's {smem} bytes of shared memory > {MAX_SMEM}"
    return None


def _gen_fwd_branch(c: int, o: int, g: int, k2: int, bf16: bool, shared_mask: bool) -> str:
    """The general route's branch of A and E: pixel at O <= 8, mma for bf16
    x without a shared mask, else chunked; each where its shared memory
    fits."""
    for branch in ("pixel", "mma"):
        if _gen_fwd_fault(branch, c, o, g, k2, bf16, shared_mask) is None:
            return branch
    return "chunked"


def _gen_tile(h: int, w: int, tile, who: str, shapes=GEN_TILE_SHAPES,
              pixels=(_GEN_PIX,)) -> tuple[int, int, int, int]:
    """(tile_h, tile_w, tiles_y, tiles_x) of the general route: of
    ``shapes`` (or ``tile``) the one with the fewest tiles."""
    shapes = (tile,) if tile is not None else shapes
    th, tw = min(shapes, key=lambda t: -(-h // t[0]) * -(-w // t[1]))
    if th * tw not in pixels:
        raise ValueError(f"{who}: this branch of the general route takes "
                         f"{'/'.join(map(str, pixels))}-pixel tiles, not {th}x{tw}")
    return th, tw, -(-h // th), -(-w // tw)


def _gen_plan(n, c, h, w, o, g, bf16, shared_mask, sm_count, tile, k2, branch):
    """The general route's tile plan (see :func:`tile_plan`)."""
    if branch is None:
        branch = _gen_fwd_branch(c, o, g, k2, bf16, shared_mask)
    fault = _gen_fwd_fault(branch, c, o, g, k2, bf16, shared_mask)
    if fault is not None:
        raise ValueError(f"tile_plan: {fault}")
    if branch == "pixel":  # a thread per pixel: TILE_SHAPES, as the tuned CUDA-core path
        if tile is None:
            for th, tw in TILE_SHAPES:
                if n * -(-h // th) * -(-w // tw) >= 3 * sm_count:
                    break
            tile = (th, tw)
        th, tw, ty, tx = _gen_tile(h, w, tile, "tile_plan", pixels=TILE_SHAPES_PIXELS)
        smem = _gen_pixel_smem(c, k2)
    else:
        th, tw, ty, tx = _gen_tile(h, w, tile, "tile_plan")
        smem = _gen_mma_smem(c, o, g, k2) if branch == "mma" else _gen_smem_bytes(c, o, k2)
    return TilePlan(th, tw, 0, smem, branch == "mma", ty, tx, "general", f"general/{branch}",
                    c // g, gen_cpgp(c // g))


@functools.lru_cache(maxsize=512)
def _plan(n, c, h, w, o, g, max_displacement, bf16, shared_mask, sm_count, tile=None,
          route="tuned", k2=9, branch=None):
    if route == "general":
        return _gen_plan(n, c, h, w, o, g, bool(bf16), bool(shared_mask), sm_count, tile, k2,
                         branch)
    if branch is not None:
        raise ValueError(f"tile_plan: branch {branch!r} names the general route, not {route!r}")
    if route != "tuned":
        raise ValueError(f"tile_plan: route {route!r} (one of {ROUTES})")
    wide = o == WIDE_OUT_CHANNELS
    mma = bool(bf16) and o in (_MMA_O, WIDE_OUT_CHANNELS) and not shared_mask
    if mma and wide and c != _WIDE_C:
        raise ValueError(f"tile_plan: bf16 at O = {o} takes {_WIDE_C} input channels, not {c}")
    pixels = _WIDE_PIX if wide else 32
    if tile is not None:
        shapes = (tile,)
    elif mma:
        shapes = (min(WIDE_MMA_TILE_SHAPES if wide else MMA_TILE_SHAPES,
                      key=lambda t: -(-h // t[0]) * -(-w // t[1])),)
    else:
        shapes = TILE_SHAPES
    for th, tw in shapes:
        ty, tx = -(-h // th), -(-w // tw)
        if n * ty * tx >= _min_blocks(mma, o) * sm_count:
            break
    if mma and th * tw != pixels:
        raise ValueError(f"tile_plan: the tensor-core path at O = {o} takes {pixels}-pixel "
                         f"tiles, not {th}x{tw}")
    pad = 0 if max_displacement is None else math.ceil(max_displacement) + 1
    smem = _smem_bytes(mma, c, o)
    if smem > MAX_SMEM:
        raise ValueError(f"tile_plan: {smem} bytes of shared memory > {MAX_SMEM}")
    return TilePlan(th, tw, pad, smem, mma, ty, tx)


def tile_plan(n: int, c: int, h: int, w: int, o: int, g: int,
              max_displacement: float | None, *, bf16: bool, shared_mask: bool = False,
              sm_count: int = SM_COUNT, tile: tuple[int, int] | None = None,
              route: str | None = None, kernel: str = "dcn_fwd", kh: int = 3, kw: int = 3,
              shared_taps: bool = False, tap_anchor: bool = False,
              branch: str | None = None) -> TilePlan:
    """The tile plan of kernel A (or E, ``kernel="dcn_fused"``: per-tap, no
    shared mask) for x (n, c, h, w), O = ``o`` outputs, ``g`` groups and a
    ``kh`` x ``kw`` weight. A clamped call on a tuned route reads its
    corners from x packed with a zero border of ``pad`` pixels, an unclamped
    one with frame checks; a tile of a clamped call therefore reads its
    corners from the tile grown by ``pad`` pixels below and ``pad + 1``
    above, in the packed plane (through L1). ``tile`` forces a tile (rows,
    columns) instead of the default one; ``route`` a route ("tuned" or
    "general") instead of :func:`width_route`'s (the general route at a
    tuned width, for measurements); ``tap_anchor``: the route of a per-tap
    anchored call. On the general route the plan also picks the branch
    (:data:`GEN_BRANCHES`: pixel at O <= 8, mma for bf16 x at O > 8 without
    a shared mask, else chunked) and its tile: the pixel branch a
    :data:`TILE_SHAPES` tile as the tuned CUDA-core path, the others
    :data:`GEN_TILE_SHAPES`; ``branch`` forces one (ValueError where it
    does not take the width)."""
    if route is None:
        route = width_route(kernel, c, o, g, kh, kw, shared=bool(shared_taps or shared_mask),
                            bf16=bool(bf16), tap_anchor=tap_anchor)
    return _plan(n, c, h, w, o, g, max_displacement, bool(bf16), bool(shared_mask),
                 sm_count, tile, route, kh * kw, branch)


# ---- the plan of kernel D -------------------------------------------------

# A block of 256 threads takes a tile of 256 / G pixels, one thread per
# (pixel, group); the persistent grid is at most _bwd_blocks_per_sm blocks
# a SM, and each block leaves one dW partial.
BWD_THREADS = 256


def _bwd_blocks_per_sm(o: int, cpg: int) -> int:
    """Resident blocks an SM (``csrc/dcn_bwd.cu::blocks_per_sm``): 2, or 1
    at O <= 4 with 4 channels a group, where the 4x4 patch's 64 sums need
    more than the 128 registers a thread of two blocks."""
    return 1 if o <= 4 and cpg == 4 else 2


def _dw_rows(o: int) -> int:
    """Output channels of a thread's dW block (``csrc/dcn_bwd.cu::dw_rows``)."""
    return min(o, 4)


def _dw_blocks(c: int, o: int) -> int:
    """The dW blocks of a block's threads: (O / rows) x C, each rows x 9
    taps of one input channel."""
    return o // _dw_rows(o) * c


def _bwd_smem_bytes(c: int, o: int, g: int) -> int:
    """``csrc/dcn_bwd.cu::bwd_smem_bytes``: the f32 weight [G][9][C/G][O],
    the tile's output gradient [O][P] and its modulated samples [P][9C + 1]
    (after the last tile the threads' dW sums [256][rows x 9] in their
    place), P = 256 / G pixels, all f32."""
    p = BWD_THREADS // g
    return 4 * (c * _TAPS * o + o * p
                + max(p * (_TAPS * c + 1), BWD_THREADS * _dw_rows(o) * _TAPS))


@dataclass(frozen=True)
class BwdPlan:
    """How kernel D covers an (N, C, H, W) call: tiles of ``tile_h`` x
    ``tile_w`` = 256 / G pixels; ``pad`` pixels of zeros around the packed
    planes of x and of the f32 dx accumulator (a clamped call: ceil(D) + 1,
    as :class:`TilePlan`'s); ``smem_bytes`` of dynamic shared memory;
    ``grid`` persistent blocks, each leaving one dW partial; ``patch``: a
    clamped call under shared taps sums its 9 taps' dx in one 4x4 patch of
    registers (16 vector atomics a pixel instead of 36). ``route``:
    "tuned", or "general" (pad 0, no patch; ``taps`` = kh x kw; ``branch``
    "general/pixel", tiles of 32-256 pixels, or "general/chunked", tiles of
    32; ``cpg`` channels a group packed as ``cpgp``, :func:`gen_cpgp`;
    ``tap_scratch``: f32 elements of the chunked branch's per-tap sums
    under shared taps or a shared mask)."""

    tile_h: int
    tile_w: int
    pad: int
    smem_bytes: int
    grid: int
    patch: bool
    tiles_y: int
    tiles_x: int
    route: str = "tuned"
    taps: int = _TAPS
    tap_scratch: int = 0
    branch: str = "tuned"
    cpg: int = 0
    cpgp: int = 0

    def args(self) -> tuple[int, int, int, int, int, int, int]:
        """The C entry's plan arguments (the branch's index in
        :data:`GEN_BRANCHES` last, 0 on the tuned route)."""
        return (self.tile_h, self.tile_w, self.pad, self.smem_bytes, self.grid, int(self.patch),
                _branch_code(self.branch))

    def packed_numel(self, n: int, c: int, h: int, w: int) -> int:
        """Elements of the packed x and of the packed dx accumulator."""
        if self.route == "general":
            return n * (c // self.cpg) * self.cpgp * h * w
        ext = 2 * self.pad + 1 if self.pad else 0
        return n * c * (h + ext) * (w + ext)

    def acc_numel(self, n: int, c: int, h: int, w: int, o: int) -> int:
        """f32 elements of the accumulator scratch: packed dx, then the
        blocks' dW partials (``grid`` x O x C x taps), then the chunked
        branch's per-tap sums."""
        return self.packed_numel(n, c, h, w) + self.grid * o * c * self.taps + self.tap_scratch


def _gen_bwd_pixel_smem(c: int, o: int, k2: int, p: int, staged: bool) -> int:
    """D's pixel branch at ``p`` pixels a tile
    (``csrc/dcn_bwd.cu::gen_bwd_pixel_smem_bytes``): the output gradient
    [O][P], U [C k2][P + 1], the dW slices' sums [256] and, ``staged``, the
    weight [O][C k2], f32."""
    return 4 * (o * p + c * k2 * (p + 1) + _GEN_THREADS + (o * c * k2 if staged else 0))


def _gen_bwd_pixel_fit(c: int, o: int, g: int, k2: int,
                       tiles_at=None, sm_count: int = SM_COUNT) -> tuple[int, bool] | None:
    """(pixels a tile, weight staged) of D's pixel branch, or None where it
    does not fit: the smallest power of two P with P G >= 256 (a thread a
    (pixel, group)), at least 32 and at most 256, halved while the call
    (``tiles_at(P)``: its tiles at P pixels) has fewer than two tiles an SM
    (at (2,16,48,48) in one group 256-pixel tiles kept 18 SMs busy and read
    9 % slower than the chunked branch) and while U does not fit; the
    weight staged where it fits beside them, and so that two blocks fit an
    SM unless one block fills it already."""
    p = 32
    while p < _GEN_THREADS and p * g < _GEN_THREADS:
        p *= 2
    while p > 32 and tiles_at is not None and tiles_at(p) < 2 * sm_count:
        p //= 2
    while p > 32 and _gen_bwd_pixel_smem(c, o, k2, p, False) > MAX_SMEM:
        p //= 2
    bare = _gen_bwd_pixel_smem(c, o, k2, p, False)
    if bare > MAX_SMEM:
        return None
    half = _SM_SMEM // 2 - 1024
    full = _gen_bwd_pixel_smem(c, o, k2, p, True)
    return p, full <= MAX_SMEM and (full <= half or bare > half)


def _gen_bwd_plan(n, c, h, w, o, g, shared_taps, sm_count, tile, kh, kw, shared_mask,
                  branch):
    """The general route's plan of kernel D (see :func:`bwd_plan`)."""
    taps = kh * kw

    def tiles_at(p):  # the call's tiles at p pixels, of the shapes below
        return min(n * -(-h // t[0]) * -(-w // t[1]) for t in ((p // 32, 32), (p // 16, 16)))

    fit = _gen_bwd_pixel_fit(c, o, g, taps, tiles_at if tile is None else None, sm_count)
    if branch is None:
        branch = "pixel" if fit is not None else "chunked"
    if branch == "pixel":
        if fit is None:
            raise ValueError(f"bwd_plan: the pixel branch's shared memory does not fit "
                             f"C = {c}, O = {o}, {kh}x{kw}")
        p, staged = fit
        shapes = ((p // 32, 32), (p // 16, 16))
        th, tw, ty, tx = _gen_tile(h, w, tile, "bwd_plan", shapes, pixels=(p,))
        smem = _gen_bwd_pixel_smem(c, o, taps, p, staged)
        blocks = max(1, min(3, _SM_SMEM // (smem + 1024)))
        scratch = 0
    elif branch == "chunked":
        th, tw, ty, tx = _gen_tile(h, w, tile, "bwd_plan")
        smem, blocks = _GEN_BWD_SMEM, 2
        scratch = n * g * taps * 3 * h * w if (shared_taps or shared_mask) else 0
    else:
        raise ValueError(f"bwd_plan: branch {branch!r} (one of {GEN_BRANCHES[:2]})")
    grid = max(1, min(n * ty * tx, blocks * sm_count, _GEN_DW_PARTIALS // (o * c * taps)))
    return BwdPlan(th, tw, 0, smem, grid, False, ty, tx, "general", taps, scratch,
                   f"general/{branch}", c // g, gen_cpgp(c // g))


@functools.lru_cache(maxsize=512)
def _bwd_plan(n, c, h, w, o, g, max_displacement, shared_taps, sm_count, tile=None,
              patch=None, route="tuned", kh=3, kw=3, shared_mask=False, branch=None):
    if route == "general":
        if patch:
            raise ValueError("bwd_plan: the general route has no 4x4 patch")
        return _gen_bwd_plan(n, c, h, w, o, g, bool(shared_taps), sm_count, tile, kh, kw,
                             bool(shared_mask), branch)
    if branch is not None:
        raise ValueError(f"bwd_plan: branch {branch!r} names the general route, not {route!r}")
    if route != "tuned":
        raise ValueError(f"bwd_plan: route {route!r} (one of {ROUTES})")
    p = BWD_THREADS // g
    shapes = (tile,) if tile is not None else ((p // 32, 32), (p // 16, 16))
    th, tw = min(shapes, key=lambda t: -(-h // t[0]) * -(-w // t[1]))
    if th * tw != p:
        raise ValueError(f"bwd_plan: {g} groups take {p}-pixel tiles, not {th}x{tw}")
    ty, tx = -(-h // th), -(-w // tw)
    pad = 0 if max_displacement is None else math.ceil(max_displacement) + 1
    if patch is None:
        patch = bool(shared_taps) and pad > 0
    if patch and not (shared_taps and pad > 0):
        raise ValueError("bwd_plan: the 4x4 patch needs shared taps and a clamp")
    grid = min(n * ty * tx, _bwd_blocks_per_sm(o, c // g) * sm_count)
    return BwdPlan(th, tw, pad, _bwd_smem_bytes(c, o, g), grid, patch, ty, tx)


def bwd_plan(n: int, c: int, h: int, w: int, o: int, g: int,
             max_displacement: float | None, *, shared_taps: bool = False,
             sm_count: int = SM_COUNT, tile: tuple[int, int] | None = None,
             patch: bool | None = None, route: str | None = None, kh: int = 3,
             kw: int = 3, shared_mask: bool = False, tap_anchor: bool = False,
             branch: str | None = None) -> BwdPlan:
    """The plan of kernel D for x (n, c, h, w), O = ``o``, ``g`` groups and
    a ``kh`` x ``kw`` weight. The tuned route: of the tiles (256 / G / 32,
    32) and (256 / G / 16, 16) the one with the fewest tiles, the first on
    a tie; the padding of :func:`tile_plan`; a grid of at most
    ``_bwd_blocks_per_sm`` blocks a SM. The general route, no padding: the
    pixel branch where its shared memory fits (:func:`_gen_bwd_pixel_fit`:
    tiles of P pixels, (P / 32, 32) or (P / 16, 16), a grid of at most 3
    blocks a SM, as many as fit its shared memory), else the chunked one
    (32-pixel tiles of :data:`GEN_TILE_SHAPES`, at most 2 blocks a SM).
    ``tile``, ``patch``, ``route`` and ``branch`` force a tile, the patch on
    or off, a route or a general branch instead of :func:`width_route`'s
    (for measurements); ``tap_anchor``: the route of a per-tap anchored
    call."""
    shared = bool(shared_taps or shared_mask)
    if route is None:
        route = width_route("dcn_bwd", c, o, g, kh, kw, shared=shared, tap_anchor=tap_anchor)
    return _bwd_plan(n, c, h, w, o, g, max_displacement, bool(shared_taps), sm_count,
                     tile, patch, route, kh, kw, bool(shared_mask), branch)


_sm_counts: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, asked once."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    count = _sm_counts.get(index)
    if count is None:
        count = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return count


def check_tiled(name: str, c: int, g: int, kh: int, kw: int, o: int = 32,
                shared: bool = False) -> None:
    """Raise ValueError with :func:`width_fault`'s reason when kernel
    ``name`` does not take these widths."""
    fault = width_fault(name, c, o, g, kh, kw, shared=shared)
    if fault is not None:
        raise ValueError(f"{name}: {fault}")


def check_route(name: str, route: str, c: int, g: int, kh: int, kw: int, o: int,
                shared: bool, bf16: bool = False, tap_anchor: bool = False,
                pad: int = 0, branch: str | None = None, shared_mask: bool = False) -> str:
    """The C entry of the ``route`` that a plan names for these widths;
    ValueError where the kernel, or a tuned route that the plan names, does
    not take them, where a per-tap anchored plan (``tap_anchor``) has a
    border (``pad``): those calls read frame-checked corners
    (:func:`border`), or where the plan's general ``branch`` (None: not
    checked) does not take them (the mma branch on f32 x or a shared mask,
    the pixel branch of A and E at O > 8, a branch whose shared memory does
    not fit)."""
    check_tiled(name, c, g, kh, kw, o, shared)
    if route == "tuned":
        fault = _tuned_fault(name, c, o, g, kh, kw, bool(shared), bool(bf16), bool(tap_anchor))
        if fault is not None:
            raise ValueError(f"{name}: the tuned route does not take {fault}")
        if tap_anchor and pad:
            raise ValueError(f"{name}: a per-tap anchored call reads frame-checked corners "
                             f"(pad 0), not planes padded by {pad}")
        if branch not in (None, "tuned"):
            raise ValueError(f"{name}: branch {branch!r} is the general route's")
    elif route == "general":
        kind = None if branch is None else branch.split("/")[-1]
        if kind is None:
            fault = None
        elif name == "dcn_bwd":
            fault = None if kind == "chunked" else \
                f"branch {branch!r} (one of {GEN_BRANCHES[:2]})" if kind != "pixel" else \
                None if _gen_bwd_pixel_fit(c, o, g, kh * kw) is not None else \
                "the pixel branch's shared memory at this width"
        else:
            fault = _gen_fwd_fault(kind, c, o, g, kh * kw, bool(bf16), bool(shared_mask))
        if fault is not None:
            raise ValueError(f"{name}: the general route's plan does not take {fault}")
    else:
        raise ValueError(f"{name}: route {route!r} (one of {ROUTES})")
    return _ENTRIES[name][route]


def dcn_forward(
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
    plan: TilePlan | None = None,
    with_table: bool = False,
):
    """Kernel A alone (no autograd): (N, O, H, W) in x's dtype. CUDA tensors
    only. ``anchor``: the anchored mode (shared taps or per-tap). ``plan``: a
    :func:`tile_plan` other than the default one (other tiles, or the
    general route at a tuned width, are measured this way). ``with_table``:
    return (output, the anchor table the call's pre-pass wrote, f32 (N, G,
    bands, tiles, 2), or None unanchored), the table that
    :func:`dcn_backward` takes."""
    global launches, anchor_launches, general_launches, tap_anchor_launches, wide_launches
    with span("crfp.kernel.A", {"x": x, "weight": weight,
                                "anchored": anchor is not None}) as s:
        g = _check(x, offset, mask, weight, bias, shared_taps, shared_mask)
        n, c, h, w = x.shape
        o, _, kh, kw = weight.shape
        shared = bool(shared_taps or shared_mask)
        bf16 = x.dtype == torch.bfloat16
        # an anchored call's displacements are bounded by its reach, which sizes
        # the zero border of the packed planes as a clamp to +-reach would
        # (border(): per-tap, no border)
        d = max_displacement if anchor is None else anchor.reach
        tap_anchor = anchor is not None and not shared_taps
        if plan is None:
            plan = _plan(n, c, h, w, o, g, border(d, anchor, shared_taps), bf16,
                         bool(shared_mask), sm_count(x.device), None,
                         width_route("dcn_fwd", c, o, g, kh, kw, shared=shared, bf16=bf16,
                                     tap_anchor=tap_anchor), kh * kw)
        entry = check_route("dcn_fwd", plan.route, c, g, kh, kw, o, shared, bf16, tap_anchor,
                            plan.pad, plan.branch, bool(shared_mask))
        s.note(route=plan.route, branch=plan.branch)
        out = torch.empty((n, o, h, w), dtype=x.dtype, device=x.device)
        # the pre-pass's zero-padded, pixel-major copy of x
        packed = torch.empty(plan.packed_numel(n, c, h, w), dtype=x.dtype, device=x.device)
        # an anchored call's table, written by its own pre-pass
        table = None if anchor is None else torch.empty(
            (n, g, *anchor.cells(h, w), 2), dtype=torch.float32, device=x.device)
        _build.launch("dcn_fwd", entry, _ARGTYPES, x.device,
                      x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                      None if bias is None else bias.data_ptr(), out.data_ptr(),
                      packed.data_ptr(),
                      n, c, h, w, o, g, kh, kw, _build.window(d),
                      int(shared_taps), int(shared_mask), int(bf16), *plan.args(),
                      None if table is None else table.data_ptr(),
                      *kernel_args(anchor))
        launches += 1
        if anchor is not None:
            anchor_launches += 1
            tap_anchor_launches += not shared_taps
        if plan.route == "general":
            general_launches += 1
        elif o == WIDE_OUT_CHANNELS:
            wide_launches += 1
        return (out, table) if with_table else out


def dcn_backward(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    max_displacement: int | None = None,
    shared_taps: bool = False,
    shared_mask: bool = False,
    anchor: AnchorGeometry | None = None,
    table: torch.Tensor | None = None,
    plan: BwdPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel D for the DCN stages: (dx in x's dtype, d-offset, d-mask, dW
    float32) of :func:`deform_conv2d_windowed` for the output gradient
    ``grad_out`` (N, O, H, W) in x's dtype. CUDA tensors only. Three
    launches, no synchronisation; outputs and scratch from ``torch.empty``.
    ``anchor`` with ``table``: the anchored mode (shared taps or per-tap), on
    the table that kernel A's anchored forward wrote (``dcn_forward(...,
    with_table=True)``). ``plan``: a :func:`bwd_plan` other than the
    default one (the general route at a tuned width, for one)."""
    global bwd_launches, bwd_anchor_launches, bwd_general_launches, bwd_tap_anchor_launches
    with span("crfp.kernel.D", {"x": x, "weight": weight,
                                "anchored": anchor is not None}) as s:
        g = _check(x, offset, mask, weight, None, shared_taps, shared_mask)
        n, c, h, w = x.shape
        o, _, kh, kw = weight.shape
        shared = bool(shared_taps or shared_mask)
        if grad_out.shape != (n, o, h, w) or grad_out.dtype != x.dtype \
                or grad_out.device != x.device or not grad_out.is_contiguous():
            raise ValueError(f"dcn_bwd: grad_out {tuple(grad_out.shape)} {grad_out.dtype} "
                             f"must be a contiguous {(n, o, h, w)} {x.dtype} on {x.device}")
        if (anchor is None) != (table is None):
            raise ValueError("dcn_bwd: an anchored call takes the anchor geometry and the "
                             "table of its forward, both")
        if table is not None and (table.shape != (n, g, *anchor.cells(h, w), 2)
                                  or table.dtype != torch.float32 or table.device != x.device
                                  or not table.is_contiguous()):
            raise ValueError(f"dcn_bwd: anchor table {tuple(table.shape)} {table.dtype} must be "
                             f"a contiguous float32 {(n, g, *anchor.cells(h, w), 2)} on {x.device}")
        # the anchored reach bounds every displacement and sizes the padding
        d = max_displacement if anchor is None else anchor.reach
        tap_anchor = anchor is not None and not shared_taps
        if plan is None:
            plan = _bwd_plan(n, c, h, w, o, g, border(d, anchor, shared_taps), bool(shared_taps),
                             sm_count(x.device), None, None,
                             width_route("dcn_bwd", c, o, g, kh, kw, shared=shared,
                                         tap_anchor=tap_anchor), kh, kw, bool(shared_mask))
        entry = check_route("dcn_bwd", plan.route, c, g, kh, kw, o, shared, tap_anchor=tap_anchor,
                            pad=plan.pad, branch=plan.branch)
        s.note(route=plan.route, branch=plan.branch)
        dx = torch.empty_like(x)
        d_off = torch.empty_like(offset)
        d_mask = torch.empty_like(mask)
        dw = torch.empty_like(weight)
        # scratch: x packed as kernel A packs it, and the f32 packed dx
        # accumulator followed by the blocks' dW partials
        packed = torch.empty(plan.packed_numel(n, c, h, w), dtype=x.dtype, device=x.device)
        acc = torch.empty(plan.acc_numel(n, c, h, w, o), dtype=torch.float32, device=x.device)
        _build.launch("dcn_bwd", entry, _BWD_ARGTYPES, x.device,
                      x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                      grad_out.data_ptr(), dx.data_ptr(), d_off.data_ptr(),
                      d_mask.data_ptr(), dw.data_ptr(), packed.data_ptr(), acc.data_ptr(),
                      n, c, h, w, o, g, kh, kw, _build.window(d),
                      int(shared_taps), int(shared_mask), int(x.dtype == torch.bfloat16),
                      None if table is None else table.data_ptr(), *kernel_args(anchor),
                      *plan.args())
        bwd_launches += 1
        if anchor is not None:
            bwd_anchor_launches += 1
            bwd_tap_anchor_launches += not shared_taps
        if plan.route == "general":
            bwd_general_launches += 1
        return dx, d_off, d_mask, dw



class _DeformConv2dWindowed(torch.autograd.Function):
    """Kernel A forward, kernel D backward; db is the sum of the output
    gradient over (N, H, W). Anchored, the forward's table is saved with
    the operands, and the backward reads it."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, max_displacement,
                shared_taps, shared_mask, anchor):
        out, table = dcn_forward(x, offset, mask, weight, bias,
                                 max_displacement=max_displacement, shared_taps=shared_taps,
                                 shared_mask=shared_mask, anchor=anchor, with_table=True)
        ctx.save_for_backward(x, offset, mask, weight, table)
        ctx.kw = dict(max_displacement=max_displacement, shared_taps=shared_taps,
                      shared_mask=shared_mask, anchor=anchor)
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight, table = ctx.saved_tensors
        grad_out = grad_out.to(x.dtype).contiguous()
        dx, d_off, d_mask, dw = dcn_backward(x, offset, mask, weight, grad_out,
                                             table=table, **ctx.kw)
        db = grad_out.float().sum((0, 2, 3)) if ctx.has_bias else None
        return dx, d_off, d_mask, dw, db, None, None, None, None


def deform_conv2d_windowed(
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
    """Windowed DCNv2, NCHW; (N, O, H, W) in x's dtype; differentiable in
    x, offset, mask, weight and bias. With ``anchor`` the per-cell anchored
    DCN of that geometry instead of the ±D clamp
    (:func:`crfp_torch.ops.anchor.dcn_geometry`; ``fullgrad=True`` for the
    training grid), differentiable as well (kernel D's anchored mode), per-tap
    or under shared taps.

    CPU tensors take the plain version (autograd of plain PyTorch); CUDA
    tensors launch kernel A forward and kernel D backward (x float32 or
    bfloat16, offset/mask/weight/bias float32, f32 accumulation; bf16 x at
    O = 32 and O = 64 contracted on the tensor cores) or raise. Widths:
    :func:`width_fault` (every width the JAX kernels take), each on the
    route :func:`width_route` picks. Overridable (``torch.overrides``), as the warp's
    dispatcher."""
    if has_torch_function((x, offset, mask)):
        return handle_torch_function(
            deform_conv2d_windowed, (x, offset, mask), x, offset, mask, weight, bias,
            max_displacement=max_displacement, shared_taps=shared_taps,
            shared_mask=shared_mask, anchor=anchor)
    recorded = torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                               for t in (x, offset, mask, weight, bias))
    if x.device.type == "cpu":
        return deform_conv2d_windowed_ref(
            x, offset, mask, weight, bias, max_displacement=max_displacement,
            shared_taps=shared_taps, shared_mask=shared_mask, anchor=anchor)
    if anchor is not None and not recorded:
        return dcn_forward(x, offset, mask, weight, bias, max_displacement=max_displacement,
                           shared_taps=shared_taps, shared_mask=shared_mask, anchor=anchor)
    if recorded:
        # a width that kernel D does not take (where the JAX package refuses
        # it too) raises here, where autograd records the call, not first in
        # the backward pass
        o, c, kh, kw = weight.shape
        taps = 1 if shared_taps else kh * kw
        check_tiled("dcn_bwd", c, offset.shape[1] // (2 * taps), kh, kw, o,
                    shared_taps or shared_mask)
    return _DeformConv2dWindowed.apply(x, offset, mask, weight, bias,
                                       max_displacement, shared_taps, shared_mask, anchor)
