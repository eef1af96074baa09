"""Kernel A at O = 64, the widths of the gen-1 pyramids (mid 64: 4, 16 and
64 channels a group) and of PCD (nf 64: 8 channels a group). On the CPU:
the tile plan of each call of the pyramids' and PCD's main path (the
CUDA-core path, one resident block an SM, the f32 weight of 147,456 bytes
in shared memory, tiles covering every pixel once, no border unclamped), the
width rule (per-tap only at O = 64, nothing for kernel D), and the
dispatcher's plain version on CPU tensors. On a card only (marker
``cuda``): the kernel against its plain version at every channel count,
clamped and unclamped, f32 to 1e-4 and bf16 to 2e-2 of max|ref|, the same
bits in two runs, and a call that autograd records refused."""

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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 8], ids=["unclamped", "clamped"])
@pytest.mark.parametrize("shape", SHAPES, ids=_IDS)
def test_wide_plan(shape, window, dtype):
    _, (n, c, h, w), g = shape
    plan = dcn.tile_plan(n, c, h, w, 64, g, window, bf16=dtype == "bf16")
    assert not plan.mma and dcn._min_blocks(plan.mma, 64) == 1
    assert plan.smem_bytes == c * 9 * 64 * 4 == 147456 <= dcn.MAX_SMEM
    assert plan.pad == (0 if window is None else math.ceil(window) + 1)
    assert (plan.tile_h, plan.tile_w) in dcn.TILE_SHAPES
    assert plan.tiles_y == math.ceil(h / plan.tile_h)
    assert plan.tiles_x == math.ceil(w / plan.tile_w)
    hits = np.zeros((h, w), np.int32)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            hits[ty * plan.tile_h:(ty + 1) * plan.tile_h,
                 tx * plan.tile_w:(tx + 1) * plan.tile_w] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("cpg", [4, 8, 16, 64])
def test_wide_width_rule(cpg):
    g = 64 // cpg
    assert dcn.width_fault("dcn_fwd", 64, 64, g, 3, 3) is None
    assert "per-tap" in dcn.width_fault("dcn_fwd", 64, 64, g, 3, 3, shared=True)
    assert "O = 64" in dcn.width_fault("dcn_bwd", 64, 64, g, 3, 3)
    assert "O = 64" in dcn.width_fault("dcn_fused", 64, 64, g, 3, 3)
    # 2 channels a group is a width of the trunk's O, not of O = 64; 8, 16
    # and 64 are O = 64's alone
    assert "channels per group" in dcn.width_fault("dcn_fwd", 64, 64, 32, 3, 3)
    if cpg not in dcn.SUPPORTED_CHANNELS_PER_GROUP:
        assert "channels per group" in dcn.width_fault("dcn_fwd", 64, 32, g, 3, 3)


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


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("window", [8, None], ids=["clamped", "unclamped"])
@pytest.mark.parametrize("cpg", [4, 8, 16, 64])
def test_wide_kernel_matches_plain_on_card(cpg, window):
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    x, off, mask, wt, b = (t.cuda() for t in _args(cpg))
    kw = dict(max_displacement=window)
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
    assert torch.equal(got, dcn.dcn_forward(x, off, mask, wt, b, **kw))


@pytest.mark.cuda
@_NEEDS_CARD
def test_wide_kernel_refuses_a_recorded_call_on_card():
    x, off, mask, wt, b = (t.cuda() for t in _args(16))
    x.requires_grad_(True)
    with pytest.raises(ValueError, match="dcn_bwd: O = 64"):
        dcn.deform_conv2d_windowed(x, off, mask, wt, b)
    with torch.no_grad():
        assert dcn.deform_conv2d_windowed(x, off, mask, wt, b).shape == x.shape
