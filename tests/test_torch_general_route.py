"""The general route's plans (``crfp_torch/ops/cuda/dcn.py``: ``tile_plan``
and ``bwd_plan`` with ``route="general"``) at every width that
``chip_smoke.py``'s phase 15 runs, on ragged frames: the branch each plan
picks (``GEN_BRANCHES``: pixel, mma, chunked), its shared memory under the
H100's 227 KB, every pixel in one tile, the packed channel stride and the
scratch sizes, and the refusals of a plan whose branch does not take the
width. Pure Python: no card, no JAX. The card holds the branches against
the plain versions (``tests/test_torch_widths.py -m cuda``, ``chip_smoke.py
--widths-only``)."""

import itertools

import pytest

from crfp_torch.ops.cuda import dcn

# (id, C, O, G, k, shared, A's branch in f32 and in bf16, D's branch): the
# widths of chip_smoke.py's phase 15(a); E takes A's branch (per-tap only)
WIDTHS = [
    ("mid8", 8, 8, 8, 3, False, "pixel", "pixel", "pixel"),
    ("mid8_dcn3", 1, 1, 1, 3, True, "pixel", "pixel", "pixel"),
    ("mid24", 24, 24, 8, 3, False, "chunked", "mma", "pixel"),
    ("mid24_dcn3", 3, 3, 1, 3, True, "pixel", "pixel", "pixel"),
    ("mid48", 48, 48, 8, 3, False, "chunked", "mma", "pixel"),
    ("mid48_dcn3", 6, 6, 1, 3, True, "pixel", "pixel", "pixel"),
    ("mid64", 64, 64, 8, 3, False, "chunked", "mma", "pixel"),
    ("mid64_dcn3", 8, 8, 1, 3, True, "pixel", "pixel", "pixel"),
    ("dg1", 32, 32, 1, 3, False, "chunked", "mma", "pixel"),
    ("dg2", 32, 32, 2, 3, False, "chunked", "mma", "pixel"),
    ("dg4", 32, 32, 4, 3, False, "chunked", "mma", "pixel"),
    ("dg16", 32, 32, 16, 3, False, "chunked", "mma", "pixel"),
    ("k1", 32, 32, 8, 1, False, "chunked", "mma", "pixel"),
    ("k5", 32, 32, 8, 5, False, "chunked", "mma", "pixel"),
    ("k5_dcn3", 4, 4, 1, 5, True, "pixel", "pixel", "pixel"),
    ("pyramid_lv1", 16, 16, 16, 3, False, "chunked", "mma", "pixel"),
    ("pyramid_lv3", 16, 16, 1, 3, False, "chunked", "mma", "pixel"),
    ("mid32", 32, 32, 8, 3, False, "chunked", "mma", "pixel"),
    ("mid32_dcn3", 4, 4, 1, 3, True, "pixel", "pixel", "pixel"),
]
_FRAMES = ((45, 80), (7, 33), (192, 192))


def _covers(plan, h, w):
    assert (plan.tiles_y - 1) * plan.tile_h < h <= plan.tiles_y * plan.tile_h
    assert (plan.tiles_x - 1) * plan.tile_w < w <= plan.tiles_x * plan.tile_w


@pytest.mark.parametrize("width", WIDTHS, ids=[w[0] for w in WIDTHS])
def test_general_plans_at_every_width(width):
    """Both dtypes' general plans of A, E and D on ragged frames, clamped
    and unclamped: the rule's branch, its tile, no border, shared memory
    under 227 KB, every pixel covered once, x packed at gen_cpgp channels a
    group (the same for f32 and bf16) and D's scratch: packed dx, the
    blocks' dW partials and, for the chunked branch under shared taps, the
    per-tap sums."""
    _, c, o, g, k, shared, f32_branch, bf16_branch, bwd_branch = width
    cpg = c // g
    cpgp = dcn.gen_cpgp(cpg)
    assert cpgp >= cpg and cpgp in (2, 4) or cpgp % 8 == 0
    for (h, w), d, bf16 in itertools.product(_FRAMES, (8, None), (False, True)):
        kw = dict(kh=k, kw=k, route="general")
        plans = [dcn.tile_plan(2, c, h, w, o, g, d, bf16=bf16, shared_mask=shared,
                               shared_taps=shared, **kw)]
        if not shared:
            plans.append(dcn.tile_plan(2, c, h, w, o, g, d, bf16=bf16, kernel="dcn_fused", **kw))
        for plan in plans:
            assert plan.branch == f"general/{bf16_branch if bf16 else f32_branch}"
            assert plan.mma == (plan.branch == "general/mma") and plan.pad == 0
            px = plan.tile_h * plan.tile_w
            assert px in dcn.TILE_SHAPES_PIXELS if plan.branch == "general/pixel" else px == 32
            assert 0 < plan.smem_bytes <= dcn.MAX_SMEM
            assert plan.args()[-1] == dcn.GEN_BRANCHES.index(plan.branch.split("/")[1])
            assert plan.packed_numel(2, c, h, w) == 2 * g * cpgp * h * w
            _covers(plan, h, w)
        bwd = dcn.bwd_plan(2, c, h, w, o, g, d, shared_taps=shared, shared_mask=shared, **kw)
        assert bwd.branch == f"general/{bwd_branch}" and bwd.pad == 0 and not bwd.patch
        assert 0 < bwd.smem_bytes <= dcn.MAX_SMEM
        # a thread a (pixel, group): P G >= 256 at most 256 pixels, halved
        # where the call has fewer than two tiles an SM or U does not fit
        p = bwd.tile_h * bwd.tile_w
        assert p % 32 == 0 and 32 <= p <= 256
        doubled_fits = dcn._gen_bwd_pixel_smem(c, o, k * k, 2 * p, False) <= dcn.MAX_SMEM
        assert p == 32 or ((2 * p * g > 256 or p == 256 or not doubled_fits)
                           and bwd.tiles_y * bwd.tiles_x * 2 >= 2 * dcn.SM_COUNT)
        _covers(bwd, h, w)
        assert 1 <= bwd.grid <= bwd.tiles_y * bwd.tiles_x * 2
        assert bwd.acc_numel(2, c, h, w, o) == 2 * g * cpgp * h * w + bwd.grid * o * c * k * k
        chunked = dcn.bwd_plan(2, c, h, w, o, g, d, shared_taps=shared, shared_mask=shared,
                               branch="chunked", **kw)
        assert chunked.tile_h * chunked.tile_w == 32 and chunked.smem_bytes == dcn._GEN_BWD_SMEM
        assert chunked.acc_numel(2, c, h, w, o) == (
            2 * g * cpgp * h * w + chunked.grid * o * c * k * k
            + (2 * g * k * k * 3 * h * w if shared else 0))


@pytest.mark.parametrize("cpg,cpgp,f32_bytes,bf16_bytes", [
    (1, 2, 8, 4), (2, 2, 8, 4), (3, 4, 16, 8), (4, 4, 16, 8), (5, 8, 16, 16),
    (8, 8, 16, 16), (12, 16, 16, 16), (24, 24, 16, 16), (64, 64, 16, 16)])
def test_packed_channel_stride(cpg, cpgp, f32_bytes, bf16_bytes):
    """A packed pixel's channels (csrc/common.cuh::gen_cpgp): 2, 4 or a
    multiple of 8, so that a corner's channels are whole 4-16 byte loads
    (``gen_vec_bytes``: the smaller of 16 and the pixel's bytes)."""
    assert dcn.gen_cpgp(cpg) == cpgp
    assert min(16, cpgp * 4) == f32_bytes and min(16, cpgp * 2) == bf16_bytes
    assert (cpgp * 4) % f32_bytes == 0 and (cpgp * 2) % bf16_bytes == 0


@pytest.mark.parametrize("c,o,g,k,whole", [
    (24, 24, 8, 3, True), (48, 48, 8, 3, True), (32, 32, 16, 3, True), (32, 32, 8, 5, True),
    (64, 64, 8, 3, False), (1024, 512, 1, 7, False)],
    ids=["mid24", "mid48", "dg16", "k5", "mid64", "o512"])
def test_chunked_branch_stages_the_weight_once_where_it_fits(c, o, g, k, whole):
    """The chunked forward's shared memory (csrc/common.cuh::gen_smem_bytes):
    U [64][32] f32 beside the whole weight [C k2][opw] where O <= 128 and
    both fit in half the card's (two blocks an SM; staged once a block),
    else beside a chunk's 64 rows (staged once a tile, 40 KB at most)."""
    opw = min(-(-o // 4) * 4, 128)
    rows = c * k * k if whole else 64
    assert (4 * (64 * 32 + c * k * k * opw) <= dcn.MAX_SMEM // 2 - 1024 and o <= 128) == whole
    for bf16, kernel in itertools.product((False, True), ("dcn_fwd", "dcn_fused")):
        plan = dcn.tile_plan(1, c, 45, 80, o, g, 8, bf16=bf16, kh=k, kw=k, kernel=kernel,
                             route="general", branch="chunked")
        assert plan.branch == "general/chunked"
        assert plan.smem_bytes == 4 * (64 * 32 + rows * opw) <= dcn.MAX_SMEM // 2


def test_plans_refuse_a_branch_that_does_not_take_the_width():
    """A plan names its branch, and check_route (the dispatchers' check
    before the C entry, which checks again) refuses a branch that does not
    take the call: the mma branch on f32 x or a shared mask, the pixel
    branch of A and E at O > 8, D's pixel branch where its shared memory does
    not fit, a branch of the general route on the tuned one, an unknown one."""
    mma = dcn.tile_plan(1, 24, 45, 80, 24, 8, 8, bf16=True)
    assert mma.branch == "general/mma"
    assert dcn.check_route("dcn_fwd", "general", 24, 8, 3, 3, 24, False, True,
                           branch=mma.branch) == "crfp_dcn_fwd_general"
    with pytest.raises(ValueError, match="bf16 x and no shared mask"):
        dcn.check_route("dcn_fwd", "general", 24, 8, 3, 3, 24, False, False, branch=mma.branch)
    with pytest.raises(ValueError, match="bf16 x and no shared mask"):
        dcn.check_route("dcn_fwd", "general", 3, 1, 3, 3, 3, True, True, branch=mma.branch,
                        shared_mask=True)
    with pytest.raises(ValueError, match="O <= 8"):
        dcn.check_route("dcn_fused", "general", 24, 8, 3, 3, 24, False, True,
                        branch="general/pixel")
    with pytest.raises(ValueError, match="branch 'general/mma'"):
        dcn.check_route("dcn_bwd", "general", 24, 8, 3, 3, 24, False, branch="general/mma")
    with pytest.raises(ValueError, match="pixel branch's shared memory"):
        dcn.check_route("dcn_bwd", "general", 1024, 1, 7, 7, 512, False, branch="general/pixel")
    with pytest.raises(ValueError, match="general route's"):
        dcn.check_route("dcn_fwd", "tuned", 32, 8, 3, 3, 32, False, True, branch="general/mma")
    with pytest.raises(ValueError, match="O <= 8"):
        dcn.tile_plan(1, 24, 45, 80, 24, 8, 8, bf16=True, route="general", branch="pixel")
    with pytest.raises(ValueError, match="bf16 x"):
        dcn.tile_plan(1, 24, 45, 80, 24, 8, 8, bf16=False, route="general", branch="mma")
    with pytest.raises(ValueError, match="branch"):
        dcn.tile_plan(1, 24, 45, 80, 24, 8, 8, bf16=True, route="general", branch="wide")
    with pytest.raises(ValueError, match="names the general route"):
        dcn.tile_plan(1, 32, 45, 80, 32, 8, 8, bf16=True, route="tuned", branch="mma")
    with pytest.raises(ValueError, match="branch"):
        dcn.bwd_plan(2, 24, 48, 48, 24, 8, 8, route="general", branch="mma")
    with pytest.raises(ValueError, match="pixel branch's shared memory"):
        dcn.bwd_plan(1, 1024, 16, 16, 512, 1, None, kh=7, kw=7, route="general",
                     branch="pixel")
    # a width no faster branch takes falls back to the chunked one, 40 KB
    big = dcn.tile_plan(1, 1024, 64, 64, 512, 1, None, bf16=True, kh=7, kw=7)
    assert big.branch == "general/chunked" and big.smem_bytes == 4 * 64 * (32 + 128)
    assert dcn.bwd_plan(1, 1024, 16, 16, 512, 1, None, kh=7, kw=7).branch == "general/chunked"
    # the pixel branch's tiles: TILE_SHAPES, forced shapes of 32-256 pixels
    assert dcn.tile_plan(1, 3, 45, 80, 3, 1, 8, bf16=True, shared_taps=True, shared_mask=True,
                         route="general", tile=(2, 16)).tile_h == 2
    with pytest.raises(ValueError, match="pixel tiles"):
        dcn.tile_plan(1, 3, 45, 80, 3, 1, 8, bf16=True, shared_taps=True, shared_mask=True,
                      route="general", tile=(3, 5))
