"""Kernel A at O = 64, the widths of the gen-1 pyramids (mid 64: 4, 16 and
64 channels a group) and of PCD (nf 64: 8 channels a group). On the CPU:
the tile plan of each call of the pyramids' and PCD's main path (bf16: the
tensor-core route, 64-pixel tiles, two resident blocks an SM, the bf16
weight, the corners' staging area and U in 114,688 bytes of shared memory; f32: the
CUDA-core route, one resident block an SM, the f32 weight of 147,456 bytes;
tiles covering every pixel once, no border unclamped), every corner of a
clamped call inside the zero-padded packed plane and inside its tile grown
by the border, the width rule (the tuned route per-tap only at O = 64,
kernel D and shared taps on the general route, 64 input channels for the
tensor-core route), and the dispatcher's plain version on CPU tensors. On
a card only (marker ``cuda``): the kernel against its plain version at
every channel count, clamped and unclamped, f32 to 1e-4 and
bf16 to 2e-2 of max|ref|, the same bits in two runs and from a CUDA-graph
replay, every tile of the tensor-core plan giving the same bits, and a
call that autograd records trained through kernel D's general route."""

import math

import numpy as np
import pytest
import torch

from crfp_torch.ops.cuda import dcn

torch.set_num_threads(1)

# (name, (n, c, h, w), g): the O = 64 calls of phase 3d's 720p clip (LR
# 90x160): X8 levels 0-3, X4 level 1-3, PCD's levels and cascade
SHAPES = [
    ("x8_lv0_cpg4", (1, 64, 90, 160), 16),
    ("x8_lv1_cpg4", (1, 64, 180, 320), 16),
    ("x8_lv2_cpg16", (1, 64, 360, 640), 4),
    ("x8_lv3_cpg64", (1, 64, 720, 1280), 1),
    ("pcd_l3_cpg8", (1, 64, 45, 80), 8),
    ("pcd_l1_cpg8", (1, 64, 180, 320), 8),
]
_IDS = [s[0] for s in SHAPES]


def _wide_mma_smem(c):
    """csrc/common.cuh::smem_bytes of the tensor-core route at O = 64: the
    weight [64][9C], the staging area of a tap's four corners [4][64
    pixels][C] and U [64][C], all bf16."""
    return 64 * 9 * c * 2 + 4 * 64 * c * 2 + 64 * c * 2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 8], ids=["unclamped", "clamped"])
@pytest.mark.parametrize("shape", SHAPES, ids=_IDS)
def test_wide_plan(shape, window, dtype):
    _, (n, c, h, w), g = shape
    plan = dcn.tile_plan(n, c, h, w, 64, g, window, bf16=dtype == "bf16")
    if dtype == "bf16":  # the tensor cores: 64-pixel tiles, two blocks an SM
        assert plan.mma and dcn._min_blocks(plan.mma, 64) == 2
        assert plan.smem_bytes == _wide_mma_smem(c) == 114688 <= dcn.MAX_SMEM
        assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024  # two blocks in an SM's 228 KB
        assert (plan.tile_h, plan.tile_w) in dcn.WIDE_MMA_TILE_SHAPES
        assert plan.tile_h * plan.tile_w == 64
        # the shape with the fewest tiles, the first of them on a tie
        counts = [math.ceil(h / th) * math.ceil(w / tw) for th, tw in dcn.WIDE_MMA_TILE_SHAPES]
        assert dcn.WIDE_MMA_TILE_SHAPES.index((plan.tile_h, plan.tile_w)) == \
            counts.index(min(counts))
    else:  # the CUDA cores: one block an SM, the f32 weight
        assert not plan.mma and dcn._min_blocks(plan.mma, 64) == 1
        assert plan.smem_bytes == c * 9 * 64 * 4 == 147456 <= dcn.MAX_SMEM
        assert (plan.tile_h, plan.tile_w) in dcn.TILE_SHAPES
    assert plan.pad == (0 if window is None else math.ceil(window) + 1)
    assert plan.tiles_y == math.ceil(h / plan.tile_h)
    assert plan.tiles_x == math.ceil(w / plan.tile_w)
    hits = np.zeros((h, w), np.int32)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            hits[ty * plan.tile_h:(ty + 1) * plan.tile_h,
                 tx * plan.tile_w:(tx + 1) * plan.tile_w] += 1
    assert (hits == 1).all()


def _corners(h, w, d, kind, seed):
    """floor(sy), floor(sx) of every (pixel, tap) as deform_conv2d_windowed_ref
    forms them (f32, after the clamp to +-d) for seeded offsets of one
    group: at +-d, uniform beyond the window, and far at the frame's edge.
    The groups of a call sample alike, so one stands for all."""
    rng = np.random.default_rng(seed)
    size = (9, 2, h, w)
    if kind == "extreme":
        off = rng.choice([-float(d), float(d)], size=size)
    elif kind == "random":
        off = rng.uniform(-1.5 * d, 1.5 * d, size=size)
    else:
        off = rng.choice([-1.0, 1.0], size=size) * rng.uniform(0.9 * d, 3 * d, size=size)
    off = torch.from_numpy(off.astype(np.float32)).clamp(-float(d), float(d))
    ky = (torch.arange(3, dtype=torch.float32) - 1).repeat_interleave(3).view(9, 1, 1)
    kx = (torch.arange(3, dtype=torch.float32) - 1).repeat(3).view(9, 1, 1)
    gy = torch.arange(h, dtype=torch.float32).view(1, h, 1)
    gx = torch.arange(w, dtype=torch.float32).view(1, 1, w)
    return (torch.floor((gy + ky) + off[:, 0]).long(),
            torch.floor((gx + kx) + off[:, 1]).long())


@pytest.mark.parametrize("shape", SHAPES, ids=_IDS)
def test_wide_padded_planes_hold_every_corner(shape):
    """The padded route at D = 8 (X8 at ``dcn_window=8``): x packed with a
    zero border of ``pad`` pixels below and ``pad + 1`` above the frame
    holds both corners of every sample, a corner at exactly +D included,
    and each lies in its pixel's tile grown by ``pad`` below and ``pad +
    1`` above, for every tile the tensor-core plan can take."""
    _, (n, c, h, w), g = shape
    d = 8
    for tile in dcn.WIDE_MMA_TILE_SHAPES:
        plan = dcn.tile_plan(n, c, h, w, 64, g, d, bf16=True, tile=tile)
        assert plan.mma and plan.pad == math.ceil(d) + 1
        hp, wp = h + 2 * plan.pad + 1, w + 2 * plan.pad + 1
        assert plan.packed_numel(n, c, h, w) == n * c * hp * wp
        wy0 = (torch.arange(h) // plan.tile_h * plan.tile_h - plan.pad).view(1, h, 1)
        wx0 = (torch.arange(w) // plan.tile_w * plan.tile_w - plan.pad).view(1, 1, w)
        win_h, win_w = plan.tile_h + 2 * plan.pad + 1, plan.tile_w + 2 * plan.pad + 1
        for i, kind in enumerate(("extreme", "random", "edge")):
            y0, x0 = _corners(h, w, d, kind, seed=20 + i)
            assert int(y0.min()) + plan.pad >= 0 and int(y0.max()) + 1 + plan.pad < hp, kind
            assert int(x0.min()) + plan.pad >= 0 and int(x0.max()) + 1 + plan.pad < wp, kind
            if kind == "extreme":  # the +D corner of the last row: the last padded row
                assert int(y0.max()) + 1 + plan.pad == hp - 1
            assert bool((y0 >= wy0).all()) and bool((y0 + 1 < wy0 + win_h).all()), (tile, kind)
            assert bool((x0 >= wx0).all()) and bool((x0 + 1 < wx0 + win_w).all()), (tile, kind)


@pytest.mark.parametrize("cpg", [4, 8, 16, 64])
def test_wide_width_rule(cpg):
    g = 64 // cpg
    assert dcn.width_fault("dcn_fwd", 64, 64, g, 3, 3) is None
    assert dcn.width_route("dcn_fwd", 64, 64, g, 3, 3) == "tuned"
    # shared taps, D and E at O = 64 run, on the general route (the tuned
    # route's reasons are what a plan naming it there raises)
    for kernel, shared, fault in (("dcn_fwd", True, "per-tap"), ("dcn_bwd", False, "O = 64"),
                                  ("dcn_fused", False, "O = 64")):
        assert dcn.width_fault(kernel, 64, 64, g, 3, 3, shared=shared) is None
        assert dcn.width_route(kernel, 64, 64, g, 3, 3, shared=shared) == "general"
        with pytest.raises(ValueError, match=fault):
            dcn.check_route(kernel, "tuned", 64, g, 3, 3, 64, shared)
    # 2 channels a group is a width of the trunk's O, not of O = 64's tuned
    # route; 8, 16 and 64 are O = 64's alone: the general route takes the rest
    assert dcn.width_route("dcn_fwd", 64, 64, 32, 3, 3) == "general"
    if cpg not in dcn.SUPPORTED_CHANNELS_PER_GROUP:
        assert dcn.width_route("dcn_fwd", 64, 32, g, 3, 3) == "general"
    # the tensor-core route takes 64 input channels; a plan that names it at
    # other channels raises, the default plan takes the general route (its
    # own tensor-core branch, general/mma); f32 takes the tuned
    # CUDA-core route
    with pytest.raises(ValueError, match="64 input channels"):
        dcn.tile_plan(1, 32, 45, 80, 64, max(32 // cpg, 1), None, bf16=True, route="tuned")
    plan = dcn.tile_plan(1, 32, 45, 80, 64, max(32 // cpg, 1), None, bf16=True)
    assert plan.route == "general" and plan.branch == "general/mma"
    # the route rule knows the dtype: what it predicts is what the plan takes
    g32 = max(32 // cpg, 1)
    if 32 % cpg == 0:  # a width of O = 64's tuned route in f32, not in bf16
        assert dcn.width_route("dcn_fwd", 32, 64, g32, 3, 3) == "tuned"
        with pytest.raises(ValueError, match="64 input channels"):
            dcn.check_route("dcn_fwd", "tuned", 32, g32, 3, 3, 64, False, bf16=True)
    assert dcn.width_route("dcn_fwd", 32, 64, g32, 3, 3, bf16=True) == plan.route
    assert dcn.width_route("dcn_fwd", 64, 64, g, 3, 3, bf16=True) == "tuned"
    plan = dcn.tile_plan(1, 32, 45, 80, 64, max(32 // cpg, 1), None, bf16=False)
    assert not plan.mma
    assert plan.route == dcn.width_route("dcn_fwd", 32, 64, max(32 // cpg, 1), 3, 3)


def _args(cpg, seed=0, d=8, hw=(37, 53)):
    g = 64 // cpg
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 64, *hw, generator=gen)
    off = torch.randn(2, g * 18, *hw, generator=gen) * (0.75 * d)
    mask = torch.rand(2, g * 9, *hw, generator=gen)
    wt = torch.randn(64, 64, 3, 3, generator=gen) * 0.05
    b = torch.randn(64, generator=gen)
    return x, off, mask, wt, b


@pytest.mark.parametrize("cpg", [4, 64])
def test_wide_dispatcher_runs_plain_on_cpu(cpg):
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    x, off, mask, wt, b = _args(cpg, hw=(9, 11))
    got = dcn.deform_conv2d_windowed(x, off, mask, wt, b, max_displacement=None)
    want = deform_conv2d_windowed_ref(x, off, mask, wt, b, max_displacement=None)
    assert got.shape == (2, 64, 9, 11) and torch.equal(got, want)


# ---- on the card -------------------------------------------------------
#   python -m pytest tests/test_torch_dcn_wide.py --noconftest -m cuda -q

_NEEDS_CARD = pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs an NVIDIA GPU and nvcc")


def _replayed(fn):
    """fn() replayed from a CUDA graph (warmed and captured on a side
    stream, its output zeroed before the replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("window", [8, None], ids=["clamped", "unclamped"])
@pytest.mark.parametrize("cpg", [4, 8, 16, 64])
def test_wide_kernel_matches_plain_on_card(cpg, window):
    """f32 on the CUDA cores to 1e-4; bf16 on the tensor cores to 2e-2 of
    max|ref| of the f32 plain version on the same values; each the same
    bits in two runs and, in bf16, from a CUDA-graph replay."""
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    x, off, mask, wt, b = (t.cuda() for t in _args(cpg))
    kw = dict(max_displacement=window)
    n, c, h, w = x.shape
    assert dcn.tile_plan(n, c, h, w, 64, 64 // cpg, window, bf16=True).mma
    assert not dcn.tile_plan(n, c, h, w, 64, 64 // cpg, window, bf16=False).mma
    want = deform_conv2d_windowed_ref(x, off, mask, wt, b, **kw)
    got = dcn.dcn_forward(x, off, mask, wt, b, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4
    xb = x.to(torch.bfloat16)
    wantb = deform_conv2d_windowed_ref(xb.float(), off, mask, wt, b, **kw)
    gotb = dcn.dcn_forward(xb, off, mask, wt, b, **kw)
    torch.cuda.synchronize()
    assert float((gotb.float() - wantb).abs().max()) <= 2e-2 * float(wantb.abs().max())
    assert torch.equal(gotb, dcn.dcn_forward(xb, off, mask, wt, b, **kw))
    assert torch.equal(_replayed(lambda: dcn.dcn_forward(xb, off, mask, wt, b, **kw)), gotb)
    assert torch.equal(got, dcn.dcn_forward(x, off, mask, wt, b, **kw))


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("window", [8, None], ids=["clamped", "unclamped"])
@pytest.mark.parametrize("cpg", [4, 8, 16, 64])
def test_every_wide_plan_gives_the_same_bits_on_card(cpg, window):
    """The tile changes which block computes a pixel, never the
    arithmetic: every tile of the O = 64 tensor-core plan gives the
    default plan's bits (ragged planes: no tile divides 37 x 53)."""
    x, off, mask, wt, b = (t.cuda() for t in _args(cpg, seed=2))
    xb = x.to(torch.bfloat16)
    n, c, h, w = x.shape
    kw = dict(max_displacement=window)
    want = dcn.dcn_forward(xb, off, mask, wt, b, **kw)
    for tile in dcn.WIDE_MMA_TILE_SHAPES:
        plan = dcn.tile_plan(n, c, h, w, 64, 64 // cpg, window, bf16=True, tile=tile)
        got = dcn.dcn_forward(xb, off, mask, wt, b, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile


@pytest.mark.cuda
@_NEEDS_CARD
def test_wide_kernel_refuses_a_recorded_call_on_card():
    """A call that autograd records at O = 64 was refused until kernel D's
    general route took it: now it trains through that route, every
    gradient within 1e-4 of max|ref| of autograd of the plain version in
    f32; a width the JAX package refuses (C % G != 0) is still refused."""
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    x, off, mask, wt, b = (t.cuda() for t in _args(16))
    gout = torch.randn_like(x)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, off, mask, wt, b)]
    before = dcn.bwd_general_launches
    dcn.deform_conv2d_windowed(*leaves).backward(gout)
    torch.cuda.synchronize()
    assert dcn.bwd_general_launches == before + 1
    want = [t.detach().clone().requires_grad_(True) for t in (x, off, mask, wt, b)]
    deform_conv2d_windowed_ref(*want).backward(gout)
    for got, ref in zip(leaves, want):
        assert float((got.grad - ref.grad).abs().max()) <= 1e-4 * float(ref.grad.abs().max())
    # 60 channels in 8 groups
    n, _, h, w = x.shape
    xr = x[:, :60].contiguous().requires_grad_(True)
    off8, mask8 = torch.zeros(n, 8 * 18, h, w, device="cuda"), torch.ones(n, 8 * 9, h, w,
                                                                         device="cuda")
    with pytest.raises(ValueError, match="groups must divide"):
        dcn.deform_conv2d_windowed(xr, off8, mask8, wt[:, :60].contiguous(), b)
