"""The tile plan of kernels A and E (crfp_torch.ops.cuda.dcn.tile_plan) at
the shapes of the serving, gate and training paths and of chip_smoke.py,
in f32 and bf16: the tiles cover every pixel once, every corner the plain
version samples lies in its tile's window and in the zero-padded packed
plane, the shared memory fits the H100, and an unclamped call plans no
window (no border: its corners are checked). On a card only (marker
``cuda``): kernels A and E against their plain versions at ragged shapes,
every plan giving the same bits, E against the PyTorch prologue + A, and a
CUDA-graph replay against the eager call."""

import math

import numpy as np
import pytest
import torch

from crfp_torch.ops.cuda import dcn

torch.set_num_threads(1)

# (name, (n, c, h, w), o, g, D, shared): the main paths' calls of A and E
SHAPES = [
    ("serving_per_tap", (1, 32, 180, 180), 32, 8, 8, False),
    ("serving_shared", (1, 4, 720, 720), 4, 1, 32, True),
    ("gate_per_tap", (1, 32, 180, 320), 32, 8, 8, False),
    ("gate_shared", (1, 4, 720, 1280), 4, 1, 32, True),
    ("train_per_tap", (2, 32, 48, 48), 32, 8, 8, False),
    ("train_shared", (2, 4, 192, 192), 4, 1, 32, True),
]
DTYPES = ["f32", "bf16"]


def _plan(shape, dtype, d="clamped", tile=None):
    _, (n, c, h, w), o, g, dd, shared = shape
    return dcn.tile_plan(n, c, h, w, o, g, dd if d == "clamped" else None,
                         bf16=dtype == "bf16", shared_mask=shared, tile=tile)


def _tiles(shape, dtype):
    """Every tile the plan can take for this call."""
    mma = dtype == "bf16" and not shape[5]
    return dcn.MMA_TILE_SHAPES if mma else dcn.TILE_SHAPES


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_tiles_cover_every_pixel_once(shape, dtype):
    _, (n, _, h, w), o, *_ = shape
    plan = _plan(shape, dtype)
    if not plan.mma:  # the largest tile that fills every SM with resident blocks
        tiles = n * plan.tiles_y * plan.tiles_x
        assert tiles >= dcn._min_blocks(False, o) * dcn.SM_COUNT \
            or (plan.tile_h, plan.tile_w) == dcn.TILE_SHAPES[-1]
        for th, tw in dcn.TILE_SHAPES[:dcn.TILE_SHAPES.index((plan.tile_h, plan.tile_w))]:
            assert n * math.ceil(h / th) * math.ceil(w / tw) < dcn._min_blocks(False, o) * 132
    assert plan.tiles_y == math.ceil(h / plan.tile_h)
    assert plan.tiles_x == math.ceil(w / plan.tile_w)
    assert (plan.tile_h * plan.tile_w) % 32 == 0 and plan.tile_h * plan.tile_w <= 256
    hits = np.zeros((h, w), np.int32)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            y0, x0 = ty * plan.tile_h, tx * plan.tile_w
            # the kernel's ragged edge: threads past the frame write nothing
            hits[y0:min(y0 + plan.tile_h, h), x0:min(x0 + plan.tile_w, w)] += 1
    assert hits.min() == 1 and hits.max() == 1
    # a batch repeats the tiling once per image
    assert n * plan.tiles_y * plan.tiles_x >= plan.tiles_y * plan.tiles_x


def _sample_positions(shape, kind, seed):
    """(sy, sx) of every (pixel, tap) as deform_conv2d_windowed_ref forms
    them (f32, after the clamp), for seeded offsets: at +-D, uniform beyond
    the window (clamped), and large at the frame's edge."""
    _, (n, _, h, w), _, g, d, shared = shape
    taps = 1 if shared else 9
    rng = np.random.default_rng(seed)
    size = (n, g, taps, 2, h, w)
    if kind == "extreme":
        off = rng.choice([-float(d), float(d)], size=size)
    elif kind == "random":
        off = rng.uniform(-1.5 * d, 1.5 * d, size=size)
    else:  # edge: far offsets everywhere, which matter at the frame's edge
        off = rng.choice([-1.0, 1.0], size=size) * rng.uniform(0.9 * d, 3 * d, size=size)
    off = torch.from_numpy(off.astype(np.float32)).clamp(-float(d), float(d))
    ky = (torch.arange(3, dtype=torch.float32) - 1).repeat_interleave(3).view(1, 1, 9, 1, 1)
    kx = (torch.arange(3, dtype=torch.float32) - 1).repeat(3).view(1, 1, 9, 1, 1)
    gy = torch.arange(h, dtype=torch.float32).view(1, 1, 1, h, 1)
    gx = torch.arange(w, dtype=torch.float32).view(1, 1, 1, 1, w)
    sy = (gy + ky) + off[:, :, :, 0]
    sx = (gx + kx) + off[:, :, :, 1]
    return sy, sx


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_window_holds_every_corner(shape, dtype):
    """Both corners of every sample, in y and in x, lie in the window of
    the pixel's tile, the tile grown by ``pad`` pixels below and ``pad + 1``
    above (the TPU kernel's window DMA): what a block reads of the packed
    plane, through L1, for every tile the plan can take."""
    _, (_, _, h, w), _, _, d, _ = shape
    for tile in _tiles(shape, dtype):
        plan = _plan(shape, dtype, tile=tile)
        assert plan.pad == math.ceil(d) + 1
        win_h, win_w = plan.tile_h + 2 * plan.pad + 1, plan.tile_w + 2 * plan.pad + 1
        ty = torch.arange(h) // plan.tile_h
        tx = torch.arange(w) // plan.tile_w
        wy0 = (ty * plan.tile_h - plan.pad).view(h, 1)
        wx0 = (tx * plan.tile_w - plan.pad).view(1, w)
        for i, kind in enumerate(("extreme", "random", "edge")):
            sy, sx = _sample_positions(shape, kind, seed=i)
            y0, x0 = torch.floor(sy).long(), torch.floor(sx).long()
            assert bool((y0 >= wy0).all()) and bool((y0 + 1 < wy0 + win_h).all()), (tile, kind)
            assert bool((x0 >= wx0).all()) and bool((x0 + 1 < wx0 + win_w).all()), (tile, kind)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_padded_planes_hold_every_corner(shape, dtype):
    """A clamped call reads its corners unchecked from x packed with a zero
    border of ``pad`` pixels below and ``pad + 1`` above the frame: every
    corner the plain version samples lies inside it, a corner at exactly
    +D (weight 0) included."""
    _, (n, c, h, w), *_ = shape
    plan = _plan(shape, dtype)
    hp, wp = h + 2 * plan.pad + 1, w + 2 * plan.pad + 1
    assert plan.packed_numel(n, c, h, w) == n * c * hp * wp
    for i, kind in enumerate(("extreme", "random", "edge")):
        sy, sx = _sample_positions(shape, kind, seed=10 + i)
        y0 = torch.floor(sy).long() + plan.pad
        x0 = torch.floor(sx).long() + plan.pad
        assert int(y0.min()) >= 0 and int(y0.max()) + 1 < hp, kind
        assert int(x0.min()) >= 0 and int(x0.max()) + 1 < wp, kind
        if kind == "extreme":  # the +D corner of the last row: the last padded row
            assert int(y0.max()) + 1 == hp - 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_fits_shared_memory(shape, dtype):
    """The bytes of csrc/common.cuh::smem_bytes, within the H100's 227 KB
    a block, for every tile: the tensor-core path's bf16 weight and U
    ([32][9C padded to 16, + 8] each) and f32 output tile, or the f32
    weight."""
    _, (_, c, _, _), o, _, _, shared = shape
    mma = dtype == "bf16" and o == 32 and not shared
    ks = (9 * c + 15) // 16 * 16 + 8
    want = 2 * 32 * ks * 2 + 32 * 36 * 4 if mma else c * 9 * o * 4
    for tile in _tiles(shape, dtype):
        plan = _plan(shape, dtype, tile=tile)
        assert plan.mma == mma
        assert plan.smem_bytes == want <= 227 * 1024


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_unclamped_call_plans_no_window(shape, dtype):
    plan = _plan(shape, dtype, d="unclamped")
    assert plan.pad == 0
    n, c, h, w = shape[1]
    assert plan.packed_numel(n, c, h, w) == n * c * h * w  # no border: checked corners
    # the last plan argument names the general route's branch: 0 on a tuned route
    assert plan.args() == (plan.tile_h, plan.tile_w, 0, plan.smem_bytes, 0)


def test_plan_refuses_what_the_kernels_do_not_take():
    # refused only where the JAX package refuses too: groups that do not
    # divide the channels (crfp_tpu/ops/pallas/dcn.py:815)
    with pytest.raises(ValueError, match="groups must divide"):
        dcn.check_tiled("dcn_fwd", 32, 5, 3, 3)
    with pytest.raises(ValueError, match="groups must divide"):
        dcn.tile_plan(1, 32, 45, 80, 32, 5, 8, bf16=True)
    # 8 channels a group and a 5x5 weight, once refused, take the general route
    dcn.check_tiled("dcn_fwd", 32, 4, 3, 3)
    dcn.check_tiled("dcn_fwd", 32, 8, 5, 5)
    assert dcn.tile_plan(1, 32, 45, 80, 32, 4, 8, bf16=True).route == "general"
    assert dcn.tile_plan(1, 32, 45, 80, 32, 8, 8, bf16=True, kh=5, kw=5).route == "general"
    dcn.check_tiled("dcn_fwd", 32, 8, 3, 3)
    assert dcn.tile_plan(1, 32, 45, 80, 32, 8, 8, bf16=True).route == "tuned"


# ---- on the card -------------------------------------------------------
# The skip condition is a string, so pytest evaluates it when the test is
# set up, not when the module is imported. Run with
#   python -m pytest tests/test_torch_dcn_tiles.py --noconftest -m cuda -q

_NEEDS_CARD = pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs an NVIDIA GPU and nvcc")
_RAGGED = (2, 37, 53)  # N, H, W: no tile size divides them


def _a_args(shared, seed=0, d=8):
    g, c, o = (1, 4, 4) if shared else (8, 32, 32)
    taps = 1 if shared else 9
    n, h, w = _RAGGED
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=gen)
    off = torch.randn(n, g * taps * 2, h, w, generator=gen) * (0.75 * d)
    mask = torch.rand(n, g * taps, h, w, generator=gen)
    wt = torch.randn(o, c, 3, 3, generator=gen) * 0.1
    b = torch.randn(o, generator=gen)
    return [t.cuda() for t in (x, off, mask, wt, b)]


def _e_args(seed=1, c=32):
    n, h, w = _RAGGED
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=gen)
    raw = torch.randn(n, 8 * 18, h, w, generator=gen) * 0.5
    rawm = torch.randn(n, 8 * 9, h, w, generator=gen) * 1.5
    flow = torch.stack([torch.randn(n, h, w, generator=gen) + 2.5,
                        torch.randn(n, h, w, generator=gen) * 3 - 1.0], dim=1)
    wt = torch.randn(c, c, 3, 3, generator=gen) * 0.1
    b = torch.randn(c, generator=gen)
    return [t.cuda() for t in (x, raw, rawm, flow, wt, b)]


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("window", [8, None], ids=["clamped", "unclamped"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_tap", "shared"])
def test_kernel_a_tiles_match_plain_on_card(shared, window):
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    x, off, mask, wt, b = _a_args(shared)
    kw = dict(max_displacement=window, shared_taps=shared, shared_mask=shared)
    want = deform_conv2d_windowed_ref(x, off, mask, wt, b, **kw)
    got = dcn.dcn_forward(x, off, mask, wt, b, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4
    xb = x.to(torch.bfloat16)
    wantb = deform_conv2d_windowed_ref(xb.float(), off, mask, wt, b, **kw)
    gotb = dcn.dcn_forward(xb, off, mask, wt, b, **kw)
    again = dcn.dcn_forward(xb, off, mask, wt, b, **kw)
    torch.cuda.synchronize()
    assert float((gotb.float() - wantb).abs().max()) <= 2e-2 * float(wantb.abs().max())
    assert torch.equal(gotb, again) and torch.equal(got, dcn.dcn_forward(x, off, mask, wt,
                                                                         b, **kw))


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_tap", "shared"])
def test_every_plan_gives_the_same_bits_on_card(shared, dtype):
    """The tile changes which block computes a pixel, never the
    arithmetic: every plan gives the default plan's bits."""
    x, off, mask, wt, b = _a_args(shared, seed=2)
    x = x.to(dtype)
    n, c, h, w = x.shape
    o, g = wt.shape[0], off.shape[1] // (2 if shared else 18)
    kw = dict(max_displacement=8, shared_taps=shared, shared_mask=shared)
    want = dcn.dcn_forward(x, off, mask, wt, b, **kw)
    mma = dtype == torch.bfloat16 and not shared
    for tile in dcn.MMA_TILE_SHAPES if mma else dcn.TILE_SHAPES:
        plan = dcn.tile_plan(n, c, h, w, o, g, 8, bf16=dtype == torch.bfloat16,
                             shared_mask=shared, tile=tile)
        got = dcn.dcn_forward(x, off, mask, wt, b, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("offsets", ["random", "rounding"])
@pytest.mark.parametrize("window", [8, None], ids=["clamped", "unclamped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_shared_taps_patch_gives_the_per_tap_bits_on_card(dtype, window, offsets):
    """Under shared_taps a clamped bf16 call takes the 9 taps' corners from
    one 4x4 patch of x (the other modes run the per-tap loop); the same
    offset repeated for every tap through the per-tap loop gives the same
    bits. "rounding": dy = dx = -1e-5, so that the f32 sum
    (p + k) + dy rounds onto the integer p + k above 256 and stays below it
    up to 256: taps across row or column 257 fall outside the patch and
    load their own corners."""
    if offsets == "random":
        x, off, mask, wt, b = _a_args(True, seed=3)
    else:
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(1, 4, 270, 262, generator=gen).cuda()
        off = torch.full((1, 2, 270, 262), -1e-5).cuda()
        mask = torch.rand(1, 1, 270, 262, generator=gen).cuda()
        wt = (torch.randn(4, 4, 3, 3, generator=gen) * 0.1).cuda()
        b = torch.randn(4, generator=gen).cuda()
    x = x.to(dtype)
    kw = dict(max_displacement=window, shared_mask=True)
    got = dcn.dcn_forward(x, off, mask, wt, b, shared_taps=True, **kw)
    want = dcn.dcn_forward(x, off.repeat(1, 9, 1, 1).contiguous(), mask, wt, b,
                           shared_taps=False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("window", [8, None], ids=["clamped", "unclamped"])
@pytest.mark.parametrize("width", [("O16_cpg2", 16, 16, 8, False), ("O2_cpg2", 2, 2, 1, True)],
                         ids=["O16_cpg2_per_tap", "O2_cpg2_shared"])
def test_kernel_a_mid16_widths_match_plain_on_card(width, window):
    """Kernel A at the mid-16 widths (dcn_0/1/2 at O = 16, 2 channels per
    group; dcn_3 at O = 2): f32 to 1e-4, bf16 to 2e-2 of max|ref| of the
    f32 plain version on the same values, two runs the same bits, and under
    shared taps the per-tap loop's bits on the repeated offset."""
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    _, c, o, g, shared = width
    taps = 1 if shared else 9
    n, h, w = _RAGGED
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(n, c, h, w, generator=gen).cuda()
    off = (torch.randn(n, g * taps * 2, h, w, generator=gen) * 6).cuda()
    mask = torch.rand(n, g * taps, h, w, generator=gen).cuda()
    wt = (torch.randn(o, c, 3, 3, generator=gen) * 0.1).cuda()
    b = torch.randn(o, generator=gen).cuda()
    kw = dict(max_displacement=window, shared_taps=shared, shared_mask=shared)
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
    if shared:
        per_tap = dcn.dcn_forward(xb, off.repeat(1, 9, 1, 1).contiguous(), mask, wt, b,
                                  **dict(kw, shared_taps=False))
        assert torch.equal(gotb, per_tap)


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("window", [8, None], ids=["clamped", "unclamped"])
@pytest.mark.parametrize("c", [32, 16], ids=["O32", "O16"])
def test_kernel_e_tiles_match_plain_and_prologue_a_on_card(window, c):
    from crfp_torch.ops.cuda import dcn_fused
    from crfp_torch.ops.dcn_windowed import (
        deform_conv2d_fusedprep_ref,
        fusedprep_offsets_and_mask,
    )

    x, raw, rawm, flow, wt, b = _e_args(c=c)
    kw = dict(max_residue_magnitude=10.0, max_displacement=window)
    want = deform_conv2d_fusedprep_ref(x, raw, rawm, flow, wt, b, **kw)
    got = dcn_fused.deform_conv2d_fusedprep(x, raw, rawm, flow, wt, b, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    # against the PyTorch prologue, then kernel A: f32 rounding, and the
    # same bits in bf16, where both contract the same rounded samples
    off, mask = fusedprep_offsets_and_mask(raw, rawm, flow, 10.0)
    pa = dcn.dcn_forward(x, off, mask, wt, b, max_displacement=window)
    torch.cuda.synchronize()
    assert float((got - pa).abs().max()) <= 1e-5
    xb, rb, mb = (t.to(torch.bfloat16) for t in (x, raw, rawm))
    gotb = dcn_fused.deform_conv2d_fusedprep(xb, rb, mb, flow, wt, b, **kw)
    offb, maskb = fusedprep_offsets_and_mask(rb, mb, flow, 10.0)
    pab = dcn.dcn_forward(xb, offb, maskb, wt, b, max_displacement=window)
    wantb = deform_conv2d_fusedprep_ref(xb.float(), rb.float(), mb.float(), flow, wt, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(gotb, pab)
    assert float((gotb.float() - wantb).abs().max()) <= 2e-2 * float(wantb.abs().max())
    assert torch.equal(gotb, dcn_fused.deform_conv2d_fusedprep(xb, rb, mb, flow, wt, b,
                                                                **kw))


def _replayed(fn):
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
def test_kernels_a_and_e_replay_from_a_cuda_graph_on_card():
    from crfp_torch.ops.cuda import dcn_fused

    for shared in (False, True):
        x, off, mask, wt, b = _a_args(shared, seed=4)
        xb = x.to(torch.bfloat16)
        kw = dict(max_displacement=8, shared_taps=shared, shared_mask=shared)
        eager = dcn.dcn_forward(xb, off, mask, wt, b, **kw)
        assert torch.equal(_replayed(lambda: dcn.dcn_forward(xb, off, mask, wt, b, **kw)),
                           eager)
    args = [t.to(torch.bfloat16) if i < 3 else t for i, t in enumerate(_e_args(seed=5))]
    eager = dcn_fused.deform_conv2d_fusedprep(*args, max_displacement=8)
    assert torch.equal(_replayed(lambda: dcn_fused.deform_conv2d_fusedprep(
        *args, max_displacement=8)), eager)
