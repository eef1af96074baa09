"""The DCN kernels' widths and kernel D's host-side arithmetic, on the CPU.

Every ``DCNAlign`` of ``CRFP`` (v18 and every other variant with DCN
stages, ``hr_dcn`` on and off) and ``CRFPRuntimeV18`` at mid 16 and mid 32
(the widths of ``checkpoints/v18_mid16_procedural.npz``,
``v18_mid32_struct.npz`` and ``basic_fvsr_mid32_struct.npz``) passes the
pure width rule of kernels A, D and
(per-tap, windowed) E, ``crfp_torch.ops.cuda.dcn.width_fault``, on their
tuned routes, and every DCN of the gen-1 pyramids at mid 64 and of PCD at
nf 64 passes A's tuned route and D's general one: a width the kernels do
not take shows here, not first on a card (``tests/test_torch_widths.py``
holds the other widths). Kernel D's plan
(``bwd_plan``) at the training shapes: the tiles cover every pixel once,
the packed planes and the f32 accumulator hold every corner, the shared
memory is ``csrc/dcn_bwd.cu``'s and fits the H100, and one call of the
dispatcher is one foreign call of three launches with its outputs and
scratch from ``torch.empty``. On a card only (marker ``cuda``): D's
gradients against autograd of the plain version at the four widths,
clamped and unclamped, and dW, d-offset and d-mask bit-equal over two runs.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from crfp_torch.ops.cuda import dcn

torch.set_num_threads(1)

_ROOT = Path(__file__).resolve().parents[1]

# (name, (n, c, h, w), o, g, D, shared): kernel D's calls on the training
# path of the recipe (B 2, GT 192) at mid 32 and mid 16
SHAPES = [
    ("mid32_per_tap", (2, 32, 48, 48), 32, 8, 8, False),
    ("mid32_shared", (2, 4, 192, 192), 4, 1, 32, True),
    ("mid16_per_tap", (2, 16, 48, 48), 16, 8, 8, False),
    ("mid16_shared", (2, 2, 192, 192), 2, 1, 32, True),
]
_IDS = [s[0] for s in SHAPES]


def _plan(shape, clamped=True, **kw):
    _, (n, c, h, w), o, g, d, shared = shape
    return dcn.bwd_plan(n, c, h, w, o, g, d if clamped else None, shared_taps=shared, **kw)


# ---- the widths -----------------------------------------------------------

_MODELS = [("CRFP", 16, "v18_mid16_procedural.npz"), ("CRFP", 32, "v18_mid32_struct.npz"),
           ("CRFPRuntimeV18", 16, "v18_mid16_procedural.npz"),
           ("CRFPRuntimeV18", 32, "v18_mid32_struct.npz")]
# (variant, hr_dcn, checkpoint at mid 32 or None): every other trunk variant
# with DCN stages, at mid 16 and 32 (no_dcn has none)
_VARIANTS = [("v13", True, None), ("v13", False, None), ("v15", True, None),
             ("v15", False, None), ("v18_cra", True, None),
             ("basic_fvsr", False, "basic_fvsr_mid32_struct.npz")]
_ROWS = ([(m, mid, ckpt, "v18", True) for m, mid, ckpt in _MODELS]
         + [("CRFP", mid, ckpt if mid == 32 else None, v, hr)
            for v, hr, ckpt in _VARIANTS for mid in (16, 32)])
_ROW_IDS = ([f"{m}_mid{mid}" for m, mid, _ in _MODELS]
            + [f"CRFP_{v}{'' if hr else '_lr_dcn'}_mid{mid}"
               for v, hr, _ in _VARIANTS for mid in (16, 32)])
# the gen-1 pyramids at their published mid 64 (variant: "cra" or "plain")
# and PCD at nf 64: kernel A only (inference), D refuses O = 64
_WIDE = [("CRFPPyramidX8", 64, None, "plain", True), ("CRFPPyramidX8", 64, None, "cra", True),
         ("CRFPPyramidX4", 64, None, "plain", True), ("CRFPPyramidX4", 64, None, "cra", True),
         ("PCDAlign", 64, None, "plain", True)]
_ROWS += _WIDE
_ROW_IDS += [f"{m}{'_cra' if v == 'cra' else ''}_mid{mid}" for m, mid, _, v, _ in _WIDE]
# deformable groups of each level (models/pyramid.py) and of PCD's four stages
_WIDE_GROUPS = {("CRFPPyramidX8", "plain"): (16, 16, 4, 1), ("CRFPPyramidX8", "cra"): (1,) * 4,
                ("CRFPPyramidX4", "plain"): (16, 16, 4, 1),
                ("CRFPPyramidX4", "cra"): (16, 16, 4, 1), ("PCDAlign", "plain"): (8,) * 4}


def _wide_stages(model, mid, variant):
    """(name, C, O, G) of every DCN of a pyramid or of PCD, on the CPU."""
    from crfp_torch.models.pyramid import CRFPPyramidX4, CRFPPyramidX8, PyramidLevelAlign
    from crfp_torch.nn.align import DCNAlign
    from crfp_torch.nn.pcd import PCDAlign

    if model == "PCDAlign":
        net = PCDAlign(mid, 8, device="cpu")
        return [(name, *m.dcn_weight.shape[1::-1], m.deform_groups)
                for name, m in net.named_modules() if isinstance(m, DCNAlign)]
    cls = CRFPPyramidX8 if model == "CRFPPyramidX8" else CRFPPyramidX4
    net = cls(mid, cra=variant == "cra", device="cpu")
    out = []
    for name, m in net.named_modules():
        if isinstance(m, PyramidLevelAlign):
            o, c = getattr(m, f"dcn_weight_{m.lv}").shape[:2]
            out.append((name, c, o, getattr(m, f"dcn_offset_{m.lv}").conv.out_channels // 18))
    return out


@pytest.mark.parametrize("model,mid,ckpt,variant,hr_dcn", _ROWS, ids=_ROW_IDS)
def test_every_dcn_stage_passes_the_width_rule(model, mid, ckpt, variant, hr_dcn):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.models.runtime import CRFPRuntimeV18
    from crfp_torch.nn.align import DCNAlign
    from crfp_torch.params import load_npz

    if model in ("CRFPPyramidX8", "CRFPPyramidX4", "PCDAlign"):
        # per-tap at O = 64: A's tuned route takes every stage; D takes O =
        # 64 on its general route, and so does A under shared taps
        stages = _wide_stages(model, mid, variant)
        assert [g for *_, g in stages] == list(_WIDE_GROUPS[model, variant])
        for name, c, o, g in stages:
            assert (c, o) == (mid, mid), name
            assert dcn.width_fault("dcn_fwd", c, o, g, 3, 3) is None, name
            assert dcn.width_route("dcn_fwd", c, o, g, 3, 3) == "tuned", name
            assert dcn.width_fault("dcn_bwd", c, o, g, 3, 3) is None, name
            assert dcn.width_route("dcn_bwd", c, o, g, 3, 3) == "general", name
            assert dcn.width_route("dcn_fwd", c, o, g, 3, 3, shared=True) == "general", name
        return
    cfg = ModelConfig(variant=variant, hr_dcn=hr_dcn, mid_channels=mid, dcn_window=8,
                      dcn_window_hr=32)
    net = (CRFP(cfg, device="cpu") if model == "CRFP"
           else CRFPRuntimeV18(cfg, warp_size=(64, 64), device="cpu"))
    leaves = load_npz(str(_ROOT / "checkpoints" / ckpt)) if ckpt else None
    stages = [(name, m) for name, m in net.named_modules() if isinstance(m, DCNAlign)]
    assert [name for name, _ in stages] == ["dcn_0", "dcn_1", "dcn_2", "dcn_3"]
    for name, m in stages:
        o, c, kh, kw = m.dcn_weight.shape
        # the checkpoint of this width holds the same DCN: (kh, kw, C, O)
        if leaves is not None:
            assert leaves[f"params/{name}/dcn_weight"].shape == (kh, kw, c, o), name
        g, shared = m.deform_groups, m.repeat
        for kernel in ("dcn_fwd", "dcn_bwd"):
            assert dcn.width_fault(kernel, c, o, g, kh, kw, shared=shared) is None, \
                (name, kernel)
        if not shared and m.window is not None:  # where DCNAlign takes kernel E
            assert dcn.width_fault("dcn_fused", c, o, g, kh, kw) is None, name
            assert dcn.width_route("dcn_fused", c, o, g, kh, kw) == "tuned", name
        # mid 16 and 32 keep the tuned routes
        assert o in dcn.SUPPORTED_OUT_CHANNELS
        for kernel in ("dcn_fwd", "dcn_bwd"):
            assert dcn.width_route(kernel, c, o, g, kh, kw, shared=shared) == "tuned", \
                (name, kernel)
    # dcn_0/1/2 at O = mid with mid/8 channels per group; dcn_3 shared at
    # O = mid/8 with the HR-level cascade, per-tap at O = mid without it
    widths = {name: tuple(m.dcn_weight.shape[:2]) + (m.deform_groups,) for name, m in stages}
    assert widths["dcn_0"] == (mid, mid, 8)
    assert widths["dcn_3"] == ((mid // 8, mid // 8, 1) if hr_dcn else (mid, mid, 8))
    assert stages[3][1].repeat == hr_dcn


# (kernel, (C, O, G, kh, kw), the route it takes or the fault it names). The
# first seven widths were refused until the general route took them (the
# tuned route's reason is the second item, which a plan that names the tuned
# route there raises); the faults that remain are the JAX package's own
# (C % G != 0, crfp_tpu/ops/pallas/dcn.py:815, :1705).
_RULE_CASES = [
    ("dcn_fwd", (32, 8, 8, 3, 3), ("general", "O = 8")),
    ("dcn_bwd", (32, 64, 8, 3, 3), ("general", "O = 64")),
    ("dcn_fused", (4, 4, 1, 3, 3), ("general", "O = 4")),
    ("dcn_fused", (4, 2, 1, 3, 3), ("general", "O = 2")),
    ("dcn_fwd", (64, 32, 8, 3, 3), ("general", "channels per group")),
    ("dcn_bwd", (32, 32, 8, 5, 5), ("general", "3x3")),
    ("dcn_bwd", (64, 32, 16, 3, 3), ("general", "16 groups")),
    ("dcn_fwd", (24, 24, 16, 3, 3), "groups must divide"),
    ("dcn_bwd", (3, 3, 2, 3, 3), "groups must divide"),
    ("dcn_fused", (32, 32, 5, 3, 3), "groups must divide"),
    ("dcn_bwd", (32, 32, 8, 3, 3), ("tuned", None)),
]
_RULE_IDS = ["A_O8", "D_O64", "E_O4", "E_O2", "A_cpg8", "D_5x5", "D_16_groups",
             "A_c_mod_g", "D_c_mod_g", "E_c_mod_g", "D_mid32_tuned"]


@pytest.mark.parametrize("kernel,args,want", _RULE_CASES, ids=_RULE_IDS)
def test_width_rule_names_the_fault(kernel, args, want):
    c, o, g, kh, kw = args
    if isinstance(want, str):  # a fault that the JAX package names too
        got = dcn.width_fault(kernel, *args)
        assert got is not None and want in got
        with pytest.raises(ValueError, match=re.escape(want)):
            dcn.check_tiled(kernel, c, g, kh, kw, o)
        with pytest.raises(ValueError, match=re.escape(want)):
            dcn.width_route(kernel, *args)
        return
    route, tuned_fault = want
    assert dcn.width_fault(kernel, *args) is None
    dcn.check_tiled(kernel, c, g, kh, kw, o)
    assert dcn.width_route(kernel, *args) == route
    if route == "general":
        # a plan that names the tuned route at this width is refused, with its reason
        with pytest.raises(ValueError, match=re.escape(tuned_fault)):
            dcn.check_route(kernel, "tuned", c, g, kh, kw, o, False)
    want_entry = f"crfp_{kernel}" + ("_general" if route == "general" else "")
    assert dcn.check_route(kernel, route, c, g, kh, kw, o, False) == want_entry


def test_kernel_e_refuses_shared_taps():
    assert "per-tap" in dcn.width_fault("dcn_fused", 16, 16, 8, 3, 3, shared=True)
    assert dcn.width_fault("dcn_fwd", 16, 16, 8, 3, 3, shared=True) is None


# ---- kernel D's plan -----------------------------------------------------

@pytest.mark.parametrize("clamped", [True, False], ids=["clamped", "unclamped"])
@pytest.mark.parametrize("shape", SHAPES, ids=_IDS)
def test_bwd_tiles_cover_every_pixel_once(shape, clamped):
    _, (n, c, h, w), o, g, d, shared = shape
    plan = _plan(shape, clamped)
    # a thread per (pixel, group): 256 / G pixels a tile, 32 or 16 wide
    assert plan.tile_h * plan.tile_w == dcn.BWD_THREADS // g
    assert plan.tile_w in (16, 32)
    assert plan.tiles_y == math.ceil(h / plan.tile_h)
    assert plan.tiles_x == math.ceil(w / plan.tile_w)
    hits = np.zeros((h, w), np.int32)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            y0, x0 = ty * plan.tile_h, tx * plan.tile_w
            hits[y0:min(y0 + plan.tile_h, h), x0:min(x0 + plan.tile_w, w)] += 1
    assert hits.min() == 1 and hits.max() == 1
    # the fewest tiles of the two widths: the training planes take no ragged tile
    assert h % plan.tile_h == 0 and w % plan.tile_w == 0
    # the persistent grid: every tile walked, at most 2 blocks a SM (1 for
    # dcn_3 at mid 32, whose patch needs the registers)
    tiles = n * plan.tiles_y * plan.tiles_x
    per_sm = 1 if (o, c // g) == (4, 4) else 2
    assert dcn._bwd_blocks_per_sm(o, c // g) == per_sm
    assert plan.grid == min(tiles, per_sm * dcn.SM_COUNT)
    assert plan.pad == (math.ceil(d) + 1 if clamped else 0)
    assert plan.patch == (shared and clamped)


@pytest.mark.parametrize("shape", SHAPES, ids=_IDS)
def test_bwd_scratch_sizes(shape):
    """The packed x and the f32 dx accumulator have the padded planes of
    kernel A's pre-pass; the accumulator scratch then holds one dW partial
    of O x C x 9 per block."""
    _, (n, c, h, w), o, g, d, _ = shape
    plan = _plan(shape)
    hp, wp = h + 2 * plan.pad + 1, w + 2 * plan.pad + 1
    a_plan = dcn.tile_plan(n, c, h, w, o, g, d, bf16=True, shared_mask=shape[5])
    assert plan.packed_numel(n, c, h, w) == n * c * hp * wp == a_plan.packed_numel(n, c, h, w)
    assert plan.acc_numel(n, c, h, w, o) == n * c * hp * wp + plan.grid * o * c * 9
    unclamped = _plan(shape, clamped=False)
    assert unclamped.packed_numel(n, c, h, w) == n * c * h * w


@pytest.mark.parametrize("shape", SHAPES, ids=_IDS)
def test_bwd_padded_planes_hold_every_corner(shape):
    """A clamped call reads x and adds dx at corners up to pad below and
    pad + 1 above the frame, unchecked: every corner of the plain version's
    samples (offsets at +-D, beyond it, and far at the edge) lies in the
    padded plane, the +D corner of the last row included."""
    _, (n, _, h, w), _, g, d, shared = shape
    plan = _plan(shape)
    hp, wp = h + 2 * plan.pad + 1, w + 2 * plan.pad + 1
    taps = 1 if shared else 9
    rng = np.random.default_rng(0)
    size = (n, g, taps, 2, h, w)
    ky = (np.arange(3) - 1).repeat(3).reshape(1, 1, 9, 1, 1)
    kx = np.tile(np.arange(3) - 1, 3).reshape(1, 1, 9, 1, 1)
    gy = np.arange(h, dtype=np.float32).reshape(1, 1, 1, h, 1)
    gx = np.arange(w, dtype=np.float32).reshape(1, 1, 1, 1, w)
    for off in (rng.choice([-float(d), float(d)], size=size),
                rng.uniform(-3 * d, 3 * d, size=size)):
        off = np.clip(off, -d, d).astype(np.float32)
        y0 = np.floor((gy + ky) + off[:, :, :, 0]).astype(np.int64) + plan.pad
        x0 = np.floor((gx + kx) + off[:, :, :, 1]).astype(np.int64) + plan.pad
        assert y0.min() >= 0 and y0.max() + 1 < hp
        assert x0.min() >= 0 and x0.max() + 1 < wp


@pytest.mark.parametrize("shape", SHAPES, ids=_IDS)
def test_bwd_shared_memory_is_the_kernels(shape):
    """csrc/dcn_bwd.cu::bwd_smem_bytes: the f32 weight, the tile's output
    gradient and its samples (or, after a tile's dW products, the threads'
    dW sums), within the H100's 227 KB, and the blocks an SM the plan
    counts on fit."""
    _, (_, c, _, _), o, g, _, _ = shape
    p = 256 // g
    rows = min(o, 4)
    want = 4 * (c * 9 * o + o * p + max(p * (9 * c + 1), 256 * rows * 9))
    assert _plan(shape).smem_bytes == want
    assert dcn._bwd_blocks_per_sm(o, c // g) * (want + 1024) <= 228 * 1024
    # the dW blocks of the threads divide the block: (O / rows) x C of them
    assert 256 % (o // rows * c) == 0


def test_bwd_plan_options():
    shape = SHAPES[1]
    assert not _plan(shape, patch=False).patch
    with pytest.raises(ValueError, match="patch"):
        _plan(SHAPES[0], patch=True)
    with pytest.raises(ValueError, match="256-pixel tiles"):
        _plan(shape, tile=(4, 32))
    assert _plan(shape, tile=(16, 16)).tiles_x == 12


def _launch_bodies():
    src = (_ROOT / "crfp_torch" / "csrc" / "dcn_bwd.cu").read_text()
    body = src[src.index("cudaError_t launch(BwdArgs<T> a"):]
    return body[:body.index("\n}\n")]


def test_bwd_call_is_one_foreign_call_of_three_launches(monkeypatch):
    """One call of the dispatcher: one foreign call, whose C entry launches
    three kernels (the pre-pass, the tiled kernel, the epilogue); outputs
    and scratch come from torch.empty (nothing is zeroed or cast on the
    host side), and the scratch has the plan's sizes."""
    from crfp_torch.ops.cuda import _build

    calls = []
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(dcn, "_check", lambda *a: 8)
    monkeypatch.setattr(dcn, "sm_count", lambda device: 132)
    for name in ("zeros", "zeros_like"):
        monkeypatch.setattr(torch, name, lambda *a, **k: pytest.fail("zero-filled tensor"))
    allocs = []
    empty = torch.empty

    def counting_empty(*a, **k):
        t = empty(*a, **k)
        allocs.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", counting_empty)
    n, c, h, w, o = 2, 32, 48, 48, 32
    x = torch.ones(n, c, h, w, dtype=torch.bfloat16)
    off, mask = torch.ones(n, 144, h, w), torch.ones(n, 72, h, w)
    weight, gout = torch.ones(o, c, 3, 3), torch.ones(n, o, h, w, dtype=torch.bfloat16)
    before = dcn.bwd_launches
    dx, d_off, d_mask, dw = dcn.dcn_backward(x, off, mask, weight, gout, max_displacement=8)
    assert len(calls) == 1 and dcn.bwd_launches == before + 1
    lib, entry, argtypes, _, *args = calls[0]
    assert (lib, entry) == ("dcn_bwd", "crfp_dcn_bwd") and len(args) + 1 == len(argtypes)
    plan = dcn.bwd_plan(n, c, h, w, o, 8, 8)
    assert tuple(args[-7:]) == plan.args()
    assert dx.dtype == torch.bfloat16 and dx.shape == x.shape
    assert d_off.shape == off.shape and d_mask.shape == mask.shape and dw.shape == weight.shape
    assert sorted(allocs[-2:]) == sorted([plan.packed_numel(n, c, h, w),
                                          plan.acc_numel(n, c, h, w, o)])
    body = _launch_bodies()
    assert body.count("<<<") + body.count("launch_dependent(") == 3


# ---- on the card -------------------------------------------------------
# The skip condition is a string, so pytest evaluates it when the test is
# set up, not when the module is imported. Run with
#   python -m pytest tests/test_torch_dcn_bwd.py --noconftest -m cuda -q

_NEEDS_CARD = pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs an NVIDIA GPU and nvcc")
# (name, c, o, g, shared): the four widths of the v18 DCN stages
_WIDTHS = [("O32_cpg4_per_tap", 32, 32, 8, False), ("O4_cpg4_shared", 4, 4, 1, True),
           ("O16_cpg2_per_tap", 16, 16, 8, False), ("O2_cpg2_shared", 2, 2, 1, True)]


def _d_args(c, o, g, shared, seed, hw=(29, 45), d=3):
    taps = 1 if shared else 9
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, c, *hw, generator=gen)
    off = torch.randn(2, g * taps * 2, *hw, generator=gen) * d
    mask = torch.rand(2, g * taps, *hw, generator=gen)
    w = torch.randn(o, c, 3, 3, generator=gen) * 0.2
    b = torch.randn(o, generator=gen)
    gout = torch.randn(2, o, *hw, generator=gen)
    return [t.cuda() for t in (x, off, mask, w, b, gout)]


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("window", [3, None], ids=["clamped", "unclamped"])
@pytest.mark.parametrize("width", _WIDTHS, ids=[w[0] for w in _WIDTHS])
def test_kernel_d_is_deterministic_but_for_dx_on_card(width, window):
    """dW, d-offset and d-mask are summed in a fixed order: two calls give
    the same bits (dx is summed by atomics)."""
    _, c, o, g, shared = width
    x, off, mask, w, _, gout = _d_args(c, o, g, shared, seed=8)
    kw = dict(max_displacement=window, shared_taps=shared, shared_mask=shared)
    for dtype in (torch.float32, torch.bfloat16):
        xx, gg = x.to(dtype), gout.to(dtype)
        first = dcn.dcn_backward(xx, off, mask, w, gg, **kw)
        again = dcn.dcn_backward(xx, off, mask, w, gg, **kw)
        torch.cuda.synchronize()
        for a, b in zip(first[1:], again[1:]):
            assert torch.equal(a, b)
        # dx: f32 sums in another order, then x's dtype (a bf16 step is 2^-8)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        assert float((first[0].float() - again[0].float()).abs().max()) <= \
            tol * float(first[0].float().abs().max())


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[5]], ids=[s[0] for s in SHAPES if s[5]])
def test_kernel_d_patch_matches_the_per_tap_scatter_on_card(shape):
    """Under shared taps a clamped call sums a pixel's dx in its 4x4 patch;
    with the patch forced off every gradient is the same (dx to f32
    rounding of the atomics' order)."""
    _, (n, c, h, w), o, g, d, _ = shape
    x, off, mask, wt, _, gout = _d_args(c, o, g, True, seed=9, hw=(h // 4, w // 4), d=d)
    kw = dict(max_displacement=d, shared_taps=True, shared_mask=True)
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), off, mask, wt, gout.to(dtype))
        hw = (h // 4, w // 4)
        on = dcn.dcn_backward(*args, plan=dcn.bwd_plan(n, c, *hw, o, g, d, shared_taps=True),
                              **kw)
        off_ = dcn.dcn_backward(*args, plan=dcn.bwd_plan(n, c, *hw, o, g, d,
                                                         shared_taps=True, patch=False), **kw)
        torch.cuda.synchronize()
        for a, b in zip(on[1:], off_[1:]):
            assert torch.equal(a, b)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        assert float((on[0].float() - off_[0].float()).abs().max()) <= \
            tol * float(on[0].float().abs().max())
