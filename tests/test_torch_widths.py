"""Every DCN width the JAX kernels take, in the port: the general route of
kernels A, D and E (``crfp_torch/csrc/common.cuh::dcn_tiles_general``,
``csrc/dcn_bwd.cu``'s ``crfp_dcn_bwd_general``) beside the tuned routes.

- The width rule (pure Python): every DCN stage of ``CRFP`` and
  ``CRFPRuntimeV18`` at ``--mid_channels`` 8, 16, 24, 32, 48 and 64 x
  ``--dg_num`` 1, 2, 4, 8 and 16 x ``--dcn_kernel`` 1, 3 and 5, and of the
  gen-1 pyramids at mid 16, 32 and 64, is taken by A and D (and by E where
  ``DCNAlign`` hands it E); the route is tuned exactly where the seed's
  width table had one (:func:`_seed_table_fault`, that table as it stood);
  the plans of both routes cover every pixel once and stay under the
  H100's 227 KB of shared memory.
- Where the JAX package refuses a width, so does the port, for the same
  reason: channels that the groups do not divide (mid 8 and mid 24 at
  dg 16: the TPU kernel's ``assert c % g == 0``), and kernel E on shared
  taps (the fused TPU kernel takes per-tap offsets only).
- Parity with JAX on the CPU, f32, through the port's plain versions (what
  the general route is held to on the card): the v18 batch trunk's
  forward and every leaf's gradient of one Charbonnier loss at mid 24
  (3 channels a group, dcn_3 at O = 3), at dg 16 (mid 16: 1 channel a
  group) and at dcn_kernel 5, to tests/test_torch_train.py's 1e-4;
  ``CRFPRuntimeV18``'s frames at mid 24 to 1e-4; and the anchored dcn_3
  and HR warp at mid 24 (C = 3, a 128-column quantum) and mid 64 (C = 8)
  through JAX's dispatch routed to its anchored kernels
  (``torch_parity.anchored_jax_dispatch``), within
  tests/test_torch_anchor.py's tolerances: the anchored cell grid is
  JAX's at those widths.
- On a card (marker ``cuda``): the general route of A, D and E against the
  plain versions at the new widths, f32 and bf16, and against the tuned
  route at mid 32.
"""

import itertools
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from crfp_torch.ops.cuda import dcn  # noqa: E402

torch.set_num_threads(1)

MIDS = (8, 16, 24, 32, 48, 64)
DGS = (1, 2, 4, 8, 16)
KERNELS = (1, 3, 5)


# ---- the width rule ---------------------------------------------------------

def _seed_table_fault(kernel, c, o, g, kh, kw, shared):
    """The seed's width rule (ops/cuda/dcn.py::width_fault before the general
    route): the widths the tuned routes were written for, and nothing else."""
    if (kh, kw) != (3, 3):
        return "3x3"
    pairs = {o_: (2, 4) for o_ in (2, 4, 16, 32)}
    table = {"dcn_fwd": {**pairs, 64: (4, 8, 16, 64)}, "dcn_bwd": pairs,
             "dcn_fused": {16: (2, 4), 32: (2, 4)}}[kernel]
    if o not in table or g < 1 or c % g or c // g not in table[o]:
        return "width"
    if shared and (kernel == "dcn_fused" or o == 64):
        return "shared"
    if kernel == "dcn_bwd":
        rows = min(o, 4)
        p = 256 // g if g in (1, 2, 4, 8) else 0
        if not p or 256 % (o // rows * c):
            return "groups"
        if 4 * (c * 9 * o + o * p + max(p * (9 * c + 1), 256 * rows * 9)) > 232448:
            return "smem"
    return None


def _no_init_draws(monkeypatch):
    """Models built for their shapes only: the init's random draws are
    skipped (the rule reads no weight)."""
    for name in ("uniform_", "normal_"):
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, **k: self)


def _stages(model):
    """(name, C, O, G, k, shared, E applies) of every DCN of a model."""
    from crfp_torch.models.pyramid import PyramidLevelAlign
    from crfp_torch.nn.align import DCNAlign

    out = []
    for name, m in model.named_modules():
        if isinstance(m, DCNAlign):
            o, c, kh, kw = m.dcn_weight.shape
            assert kh == kw == m.kernel
            out.append((name, c, o, m.deform_groups, kh, m.repeat,
                        m.window is not None and not m.repeat))
        elif isinstance(m, PyramidLevelAlign):
            o, c, kh, _ = getattr(m, f"dcn_weight_{m.lv}").shape
            g = getattr(m, f"dcn_offset_{m.lv}").conv.out_channels // (2 * kh * kh)
            out.append((name, c, o, g, kh, False, False))
    return out


def _assert_plans(c, o, g, k, shared, kernels):
    """Both dtypes' plans of each kernel at this width, on ragged frames
    clamped and unclamped: every pixel in exactly one tile, the shared
    memory under the H100's 227 KB; a general plan has no border and its
    branch's tile (32 pixels, the pixel branch a multiple of 32 up to 256)."""
    for (h, w), d, bf16 in itertools.product(((45, 80), (7, 33)), (8, None), (False, True)):
        plans = []
        if "dcn_fwd" in kernels:
            plans.append(dcn.tile_plan(1, c, h, w, o, g, d, bf16=bf16, shared_mask=shared,
                                       shared_taps=shared, kh=k, kw=k))
        if "dcn_fused" in kernels:
            plans.append(dcn.tile_plan(1, c, h, w, o, g, d, bf16=bf16, kernel="dcn_fused",
                                       kh=k, kw=k))
        if "dcn_bwd" in kernels:
            plans.append(dcn.bwd_plan(1, c, h, w, o, g, d, shared_taps=shared,
                                      shared_mask=shared, kh=k, kw=k))
        for plan in plans:
            assert plan.smem_bytes <= dcn.MAX_SMEM
            assert (plan.tiles_y - 1) * plan.tile_h < h <= plan.tiles_y * plan.tile_h
            assert (plan.tiles_x - 1) * plan.tile_w < w <= plan.tiles_x * plan.tile_w
            if plan.route == "general":
                px = plan.tile_h * plan.tile_w
                assert plan.pad == 0 and plan.branch.startswith("general/")
                assert (px % 32 == 0 and px <= 256) if plan.branch == "general/pixel" else px == 32


def _jax_refuses(c, o, g):
    """The JAX package's TPU kernel refuses groups that do not divide the
    channels (crfp_tpu/ops/pallas/dcn.py:815), before any compile."""
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.dcn import deform_conv2d_pallas

    with pytest.raises(AssertionError):
        deform_conv2d_pallas(jnp.zeros((1, 4, 4, c)), jnp.zeros((1, 4, 4, g, 9, 2)),
                             jnp.ones((1, 4, 4, g, 9)), jnp.zeros((3, 3, c, o)), None,
                             max_displacement=8, interpret=True)


@pytest.mark.parametrize("mid", MIDS)
def test_width_rule_takes_every_stage(mid, monkeypatch):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.models.runtime import CRFPRuntimeV18

    _no_init_draws(monkeypatch)
    general = refused = 0
    for dg, k in itertools.product(DGS, KERNELS):
        cfg = ModelConfig(mid_channels=mid, deform_groups=dg, dcn_kernel=k, dcn_window=8,
                          dcn_window_hr=32)
        for model in (CRFP(cfg, device="cpu"),
                      CRFPRuntimeV18(cfg, warp_size=(64, 64), device="cpu")):
            stages = _stages(model)
            assert [s[0] for s in stages] == ["dcn_0", "dcn_1", "dcn_2", "dcn_3"]
            # dcn_0/1/2: O = mid in dg groups; dcn_3: O = mid / 8, one group, shared
            assert [s[1:6] for s in stages] == [(mid, mid, dg, k, False)] * 3 + [
                (mid // 8, mid // 8, 1, k, True)]
            for name, c, o, g, kk, shared, fused in stages:
                kernels = ("dcn_fwd", "dcn_bwd") + (("dcn_fused",) if fused else ())
                if c % g:
                    # the JAX package refuses it too (mid 8 and 24 at dg 16)
                    for kernel in kernels:
                        assert "groups must divide" in dcn.width_fault(
                            kernel, c, o, g, kk, kk, shared=shared)
                    refused += 1
                    continue
                for kernel in kernels:
                    assert dcn.width_fault(kernel, c, o, g, kk, kk, shared=shared) is None, \
                        (name, kernel)
                    route = dcn.width_route(kernel, c, o, g, kk, kk, shared=shared)
                    seed = _seed_table_fault(kernel, c, o, g, kk, kk, shared)
                    assert route == ("tuned" if seed is None else "general"), \
                        (name, kernel, route, seed)
                    general += route == "general"
                _assert_plans(c, o, g, kk, shared, kernels)
    assert general > 0
    assert refused == (2 * 3 * len(KERNELS) if mid in (8, 24) else 0)
    if mid in (8, 24):
        _jax_refuses(mid, mid, 16)


@pytest.mark.parametrize("mid", (16, 32, 64))
@pytest.mark.parametrize("kind", ("X8", "X8_cra", "X4"))
def test_width_rule_takes_every_pyramid_stage(kind, mid, monkeypatch):
    """The gen-1 pyramids at dg 16 (levels 16, 16, 4, 1 groups; CRA 1): A
    per-tap, on its tuned route at mid 64 (O = 64) and on the general route
    at mid 16 and 32 (1 and 2 channels a group at the first levels, which
    tests/test_pyramid_parity.py holds at mid 16 in JAX); D's general route
    takes them all."""
    from crfp_torch.models.pyramid import CRFPPyramidX4, CRFPPyramidX8

    _no_init_draws(monkeypatch)
    cls = CRFPPyramidX4 if kind == "X4" else CRFPPyramidX8
    stages = _stages(cls(mid, cra=kind.endswith("cra"), device="cpu"))
    assert len(stages) == 4
    for name, c, o, g, k, shared, _ in stages:
        assert (c, o, k, shared) == (mid, mid, 3, False), name
        for kernel in ("dcn_fwd", "dcn_bwd"):
            assert dcn.width_fault(kernel, c, o, g, k, k) is None, (name, kernel)
            seed = _seed_table_fault(kernel, c, o, g, k, k, False)
            assert dcn.width_route(kernel, c, o, g, k, k) == (
                "tuned" if seed is None else "general"), (name, kernel)
        _assert_plans(c, o, g, k, False, ("dcn_fwd", "dcn_bwd"))
    if mid == 64:
        assert all(dcn.width_route("dcn_fwd", *s[1:4], 3, 3) == "tuned" for s in stages)


def test_refusals_are_the_jax_packages():
    """What the port refuses, and why: the JAX package refuses the same.
    - Groups that do not divide the channels: crfp_tpu/ops/pallas/dcn.py:815
      asserts c % g == 0 (and :1705 in the fused kernel).
    - Kernel E on shared taps: the fused TPU kernel takes 2 kh kw offset
      channels a group (:1701), per-tap only; the port's E likewise.
    - Kernel E under autograd: the fused TPU kernel has no VJP (the JAX
      model takes it for inference only, crfp_tpu/nn/align.py:141-147);
      the port's E raises where autograd would record it."""
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.dcn import deform_conv2d_pallas_fusedprep

    from crfp_torch.ops.cuda import dcn_fused

    for kernel in ("dcn_fwd", "dcn_bwd", "dcn_fused"):
        for c, o, g in ((24, 24, 16), (8, 8, 16), (3, 3, 2), (32, 32, 5)):
            assert "groups must divide" in dcn.width_fault(kernel, c, o, g, 3, 3)
            with pytest.raises(ValueError, match="groups must divide"):
                dcn.width_route(kernel, c, o, g, 3, 3)
    _jax_refuses(24, 24, 16)
    _jax_refuses(3, 3, 2)
    # E on shared taps: refused by both (2 offset channels are no 2 * 9 per group)
    assert "per-tap" in dcn.width_fault("dcn_fused", 3, 3, 1, 3, 3, shared=True)
    assert dcn.width_fault("dcn_fwd", 3, 3, 1, 3, 3, shared=True) is None
    with pytest.raises(AssertionError):
        deform_conv2d_pallas_fusedprep(jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, 2)),
                                       jnp.zeros((1, 8, 8, 1)), jnp.zeros((3, 3, 3, 3)), None,
                                       max_displacement=8, interpret=True)
    # E under autograd, at a general-route width (mid 24: 3 channels a group)
    x = torch.zeros(1, 24, 6, 6, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        dcn_fused.deform_conv2d_fusedprep(x, torch.zeros(1, 8 * 18, 6, 6),
                                          torch.zeros(1, 8 * 9, 6, 6), torch.zeros(1, 2, 6, 6),
                                          torch.zeros(24, 24, 3, 3), max_displacement=8)


def test_plan_names_the_general_route_at_a_tuned_width(monkeypatch):
    """``plan=`` may name the general route at a tuned width (mid 32): that
    is how the tests and chip_smoke.py hold the two routes against each
    other; a plan that names the tuned route at a width it does not take is
    refused, with the tuned route's reason."""
    tuned = dcn.tile_plan(1, 32, 180, 180, 32, 8, 8, bf16=True)
    general = dcn.tile_plan(1, 32, 180, 180, 32, 8, 8, bf16=True, route="general")
    assert (tuned.route, tuned.mma, general.route, general.mma) == ("tuned", True, "general", True)
    # the mma branch: the bf16 weight [32][K + 8] and U [32][K + 8], K = 8 x 9 x 4,
    # and the table of its 8 x 9 sample rows
    assert general.branch == "general/mma" and general.args()[-1] == 2
    assert general.pad == 0 and general.smem_bytes == 2 * (32 + 32) * (8 * 9 * 4 + 8) + 16 * 72
    assert general.packed_numel(1, 32, 180, 180) == 32 * 180 * 180
    bwd = dcn.bwd_plan(2, 4, 192, 192, 4, 1, 32, shared_taps=True, shared_mask=True,
                       route="general")
    assert (bwd.route, bwd.patch, bwd.pad, bwd.taps) == ("general", False, 0, 9)
    # the pixel branch: 256-pixel tiles at one group; packed dx and the dW
    # partials (d-offset and d-mask summed over the taps in registers)
    assert bwd.branch == "general/pixel" and bwd.tile_h * bwd.tile_w == 256
    assert bwd.acc_numel(2, 4, 192, 192, 4) == 2 * 4 * 192 * 192 + bwd.grid * 4 * 4 * 9
    assert bwd.grid == min(bwd.tiles_y * bwd.tiles_x * 2, 3 * dcn.SM_COUNT)
    # the chunked branch: packed dx, the dW partials, the per-tap sums of the
    # shared taps
    bwd = dcn.bwd_plan(2, 4, 192, 192, 4, 1, 32, shared_taps=True, shared_mask=True,
                       route="general", branch="chunked")
    assert bwd.acc_numel(2, 4, 192, 192, 4) == (2 * 4 * 192 * 192 + bwd.grid * 4 * 4 * 9
                                                + 2 * 1 * 9 * 3 * 192 * 192)
    assert bwd.grid == min(bwd.tiles_y * bwd.tiles_x * 2, 2 * dcn.SM_COUNT)
    with pytest.raises(ValueError, match="tuned route does not take"):
        dcn.check_route("dcn_fwd", "tuned", 24, 8, 3, 3, 24, False)
    with pytest.raises(ValueError, match="32-pixel tiles"):
        dcn.tile_plan(1, 32, 180, 180, 32, 8, 8, bf16=True, route="general", tile=(4, 32))
    with pytest.raises(ValueError, match="patch"):
        dcn.bwd_plan(2, 4, 192, 192, 4, 1, 32, shared_taps=True, route="general", patch=True)
    # one flag sends every call that names no route down the general route
    # (chip_smoke.py's whole-model control at mid 32)
    monkeypatch.setattr(dcn, "forced_route", "general")
    assert dcn.width_route("dcn_bwd", 32, 32, 8, 3, 3) == "general"
    assert dcn.tile_plan(1, 32, 180, 180, 32, 8, 8, bf16=True) == general
    with pytest.raises(ValueError, match="groups must divide"):
        dcn.width_route("dcn_fwd", 24, 24, 16, 3, 3)
    monkeypatch.setattr(dcn, "forced_route", None)
    # shared memory stays bounded at any width: O = 512, C = 1024, 7x7
    assert dcn.tile_plan(1, 1024, 64, 64, 512, 1, None, bf16=False, kh=7, kw=7).smem_bytes \
        == 4 * 64 * (32 + 128)


def test_dispatchers_launch_the_routes_entries(monkeypatch):
    """One foreign call a dispatcher call: the general route's C entry at a
    general width (mid 24), the tuned one at mid 32, each with its plan's
    arguments in the order of the entry's argument types; the general
    counters count the general calls only. The launch is a stub, the
    operands meta tensors (tests/test_torch_launch.py's way)."""
    from crfp_torch.ops.cuda import _build, dcn_fused

    calls = []
    monkeypatch.setattr(_build, "launch", lambda lib, entry, argtypes, dev, *a:
                        calls.append((lib, entry, len(argtypes), a)))
    monkeypatch.setattr(dcn, "_check", lambda x, off, *a: off.shape[1] // 18)
    monkeypatch.setattr(dcn_fused, "_check", lambda x, ro, *a: ro.shape[1] // 18)
    monkeypatch.setattr(dcn, "sm_count", lambda d: 132)
    monkeypatch.setattr(dcn_fused, "sm_count", lambda d: 132)
    names = ("launches", "bwd_launches", "general_launches", "bwd_general_launches")
    for name in names:  # restored after the test
        monkeypatch.setattr(dcn, name, getattr(dcn, name))
    for name in ("launches", "general_launches"):
        monkeypatch.setattr(dcn_fused, name, getattr(dcn_fused, name))
    before = (dcn.general_launches, dcn.bwd_general_launches, dcn_fused.general_launches)
    for mid, want in ((24, "_general"), (32, "")):
        x = torch.zeros(1, mid, 12, 20, dtype=torch.bfloat16, device="meta")
        off = torch.zeros(1, 144, 12, 20, device="meta")
        mask = torch.zeros(1, 72, 12, 20, device="meta")
        wt = torch.zeros(mid, mid, 3, 3, device="meta")
        dcn.dcn_forward(x, off, mask, wt, max_displacement=8)
        dcn.dcn_backward(x, off, mask, wt, x, max_displacement=8)
        dcn_fused.deform_conv2d_fusedprep(x, off.bfloat16(), mask.bfloat16(),
                                          torch.zeros(1, 2, 12, 20, device="meta"), wt,
                                          max_displacement=8)
        assert [c[1] for c in calls[-3:]] == [f"crfp_dcn_fwd{want}", f"crfp_dcn_bwd{want}",
                                             f"crfp_dcn_fused{want}"]
        assert all(len(a) + 1 == n for _, _, n, a in calls[-3:])
        plan = dcn.tile_plan(1, mid, 12, 20, mid, 8, 8, bf16=True)
        assert plan.route == ("general" if want else "tuned")
        assert calls[-3][3][19:24] == plan.args() == calls[-1][3][19:24]
        assert dcn.bwd_plan(1, mid, 12, 20, mid, 8, 8).args() == calls[-2][3][-7:]
    assert (dcn.general_launches, dcn.bwd_general_launches, dcn_fused.general_launches) == \
        tuple(b + 1 for b in before)


# ---- parity with JAX on the CPU --------------------------------------------

_WIN = dict(dcn_window=8, dcn_window_hr=32)
# (id, mid, dg, dcn_kernel): mid 24 (3 channels a group; dcn_3 at O = 3),
# dg 16 at mid 16 (1 channel a group) and dcn_kernel 5
_TRUNKS = [("mid24", 24, 8, 3), ("dg16", 16, 16, 3), ("k5", 16, 8, 5)]


@pytest.mark.parametrize("case", _TRUNKS, ids=[c[0] for c in _TRUNKS])
def test_trunk_forward_and_every_gradient_match_jax(case):
    """The v18 batch trunk (T 2, LR 8, B 1, windows 8/32, f32) from the
    port's seeded init with perturbed heads (a JAX init would compile the
    trunk once more): the output to 1e-4, the loss to 1e-5 relative and
    every leaf's gradient to 1e-4 of its max|ref|, against one JAX
    value_and_grad (tests/test_torch_train.py's tolerances)."""
    import jax
    import jax.numpy as jnp
    import torch_parity as tp
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from crfp_tpu.models.crfp import ModelConfig as JConfig
    from test_torch_train import _jloss, clip_batch

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, to_jax
    from crfp_torch.train.loop import charbonnier_loss

    _, mid, dg, k = case
    kw = dict(mid_channels=mid, deform_groups=dg, dcn_kernel=k, **_WIN)
    flat = tp.perturb_heads(to_jax(CRFP(ModelConfig(**kw), device="cpu", seed=0).state_dict()),
                            seed=1)
    batch = clip_batch(t=2)
    jb = {key: jnp.asarray(v) for key, v in batch.items()}
    (jl, jsr), jg = jax.jit(jax.value_and_grad(_jloss(JCRFP(JConfig(variant="v18", **kw))),
                                               has_aux=True))(tp.unflatten(flat), jb)

    model = CRFP(ModelConfig(**kw, remat=True), device="cpu")
    model.load_state_dict(from_jax(flat), strict=True)
    tb = {key: torch.from_numpy(v) for key, v in batch.items()}
    sr = model(tb["lr"], tb["fv"], tb["mk"])
    np.testing.assert_allclose(sr.detach().numpy(), np.asarray(jsr), rtol=0, atol=1e-4)
    loss = charbonnier_loss(sr, tb["hr"])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    got = to_jax({n: p.grad for n, p in model.named_parameters()})
    want = tp.flat_params(jg)
    assert sorted(got) == sorted(want) and len(want) == len(flat)
    bad = {key: float(np.abs(got[key] - w).max()) / float(np.abs(w).max())
           for key, w in want.items()
           if not float(np.abs(got[key] - w).max()) <= 1e-4 * float(np.abs(w).max())}
    assert not bad, bad
    # the stages are the width under test
    w3 = want["params/dcn_3/dcn_weight"].shape
    assert w3 == (k, k, mid // 8, mid // 8)
    assert want["params/dcn_0/dcn_offset/conv/kernel"].shape[-1] == dg * 2 * k * k


def test_runtime_frames_match_jax_at_mid24():
    """CRFPRuntimeV18 at mid 24, windows 8/32: 3 frames (step0 and two
    steps) to 1e-4, the port's seeded init with perturbed heads."""
    import torch_parity as tp

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18
    from crfp_torch.params import to_jax

    kw = dict(mid_channels=24, **_WIN)
    init = CRFPRuntimeV18(ModelConfig(**kw), warp_size=tp.WARP, device="cpu", seed=0)
    flat = tp.perturb_heads(to_jax(init.state_dict()), seed=2)
    lrs, fvs = tp.clip(t=3, seed=3)
    want = tp.jax_frames(tp.jax_model(**kw), flat, lrs, fvs)
    got = tp.torch_frames(tp.torch_model(flat, **kw), lrs, fvs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, 128, 192, 3)
        assert float(np.abs(g - w).max()) <= 1e-4, (i, float(np.abs(g - w).max()))


def _field(rng, h, w, d, taps=1):
    """(1, h, w, taps, 2) offsets (dy, dx): a smooth field of 1.6 x D that
    changes from cell to cell, plus +-3 px (tests/test_torch_anchor.py's)."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([1.6 * d * np.sin(yy / 9.0 + xx / 13.0),
                     -1.5 * d * np.cos(xx / 11.0 - yy / 17.0)], -1)
    return (base[None, :, :, None] + rng.uniform(-3, 3, (1, h, w, taps, 2))).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("mid", (24, 64))
def test_anchored_dcn3_and_hr_warp_grids_match_jax(mid, monkeypatch):
    """dcn_3 and the HR state warp at mid 24 (C = 3: a 128-column quantum)
    and mid 64 (C = 8), anchored, through JAX's model-level dispatch routed
    to its anchored kernels (interpret mode), f32, the request the models
    make (DCN: band 8 x xtile 32; warp: band 64): the port's plain versions
    on its geometry within tests/test_torch_anchor.py's atol 5e-5, rtol
    1e-4; the ±D clamp and a grid of twice the band miss by 20 times
    that."""
    import crfp_tpu.nn.align as jalign
    import crfp_tpu.ops.pallas.warp as jwarp
    import jax.numpy as jnp
    import torch_parity as tp

    from crfp_torch.ops import anchor as an
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    tp.anchored_jax_dispatch(monkeypatch)
    # at C = 3 a cell is 128 columns wide: three of them across the frame
    c, d, (h, w) = mid // 8, 16, (48, 264)
    rng = np.random.default_rng(mid)
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    off = _field(rng, h, w, d)
    mk = rng.uniform(0, 1, (1, h, w, 1)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, c)) * 0.2).astype(np.float32)

    def close(got, want):
        err = float(np.abs(got - want).max())
        assert np.allclose(got, want, atol=5e-5, rtol=1e-4), err
        return err

    def far(got, want):
        assert float(np.abs(got - want).max()) > 20 * 5e-5

    want = np.asarray(jalign._windowed_dcn(
        jnp.asarray(x), jnp.asarray(off.reshape(1, h, w, 1, 1, 2)),
        jnp.asarray(mk.reshape(1, h, w, 1, 1)), jnp.asarray(wt), None, d, shared=True,
        shared_mask=True, anchor=True))
    args = (_nchw(x), _nchw(off.reshape(1, h, w, 2)), _nchw(mk),
            torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous())
    geom = an.dcn_geometry(h, w, c, c, 1, 3, d, bf16=False, shared_taps=True, shared_mask=True)
    assert geom.lane_q == 128 // math.gcd(c, 128)

    def port_dcn(**a):
        return deform_conv2d_windowed_ref(*args, None, shared_taps=True, shared_mask=True,
                                          **a).permute(0, 2, 3, 1).numpy()

    close(port_dcn(anchor=geom), want)
    far(port_dcn(max_displacement=d), want)
    far(port_dcn(anchor=an.AnchorGeometry(**{**geom.__dict__, "band": 2 * geom.band})), want)

    flow = np.stack([off[..., 0, 1], off[..., 0, 0]], -1)  # (dx, dy)
    want = np.asarray(jwarp.flow_warp_maybe_windowed(jnp.asarray(x), jnp.asarray(flow), d,
                                                     anchor=True))
    wgeom = an.warp_geometry(h, w, c, d, bf16=False)

    def port_warp(g, clamp=d):
        return flow_warp_windowed_ref(args[0], _nchw(flow), clamp, g).permute(0, 2, 3, 1).numpy()

    close(port_warp(wgeom), want)
    far(port_warp(None), want)
    far(port_warp(an.AnchorGeometry(**{**wgeom.__dict__, "band": 2 * wgeom.band})), want)


# ---- on the card ------------------------------------------------------------
# The skip condition is a string, so pytest evaluates it when the test is
# set up, not when the module is imported. Run with
#   python -m pytest tests/test_torch_widths.py --noconftest -m cuda -q
# (this file imports JAX only inside its CPU tests).

_NEEDS_CARD = pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs an NVIDIA GPU and nvcc")
# (id, C, O, G, k, shared): the general route's widths of the flags
_CARD_WIDTHS = [("mid24_per_tap", 24, 24, 8, 3, False), ("mid24_dcn3", 3, 3, 1, 3, True),
                ("mid8_dcn3", 1, 1, 1, 3, True), ("mid64_dcn3", 8, 8, 1, 3, True),
                ("dg16", 32, 32, 16, 3, False), ("k5", 32, 32, 8, 5, False),
                ("k1", 32, 32, 8, 1, False), ("mid64_D", 64, 64, 8, 3, False)]


def _card_operands(c, o, g, k, shared, seed, hw=(29, 45), d=3):
    gen = torch.Generator().manual_seed(seed)
    taps = 1 if shared else k * k
    x = torch.randn(2, c, *hw, generator=gen)
    off = torch.randn(2, g * taps * 2, *hw, generator=gen) * d
    mask = torch.rand(2, g * taps, *hw, generator=gen)
    w = torch.randn(o, c, k, k, generator=gen) * 0.2
    b = torch.randn(o, generator=gen)
    gout = torch.randn(2, o, *hw, generator=gen)
    return [t.cuda() for t in (x, off, mask, w, b, gout)]


def _rel(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


# the widths whose general route also runs anchored (dcn_3's shared taps and
# a per-tap stage), on the training grid of their geometry
_ANCHORED = ("mid24_per_tap", "mid24_dcn3", "mid8_dcn3", "mid64_dcn3")


def _branch_plans(x, o, g, k, shared, window, branch, anchor):
    """(A's plan, D's plan) of the general route: the rule's branches
    ("rule"), or its chunked branch forced ("chunked")."""
    if branch == "rule":
        return None, None
    n, c, h, w = x.shape
    d = anchor.reach if anchor is not None else window
    fwd = dcn.tile_plan(n, c, h, w, o, g, d if shared or anchor is None else None,
                        bf16=x.dtype == torch.bfloat16, shared_mask=shared, shared_taps=shared,
                        kh=k, kw=k, route="general", branch=branch)
    bwd = dcn.bwd_plan(n, c, h, w, o, g, d, shared_taps=shared, shared_mask=shared, kh=k, kw=k,
                       route="general", branch=branch)
    return fwd, bwd


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("branch", ["rule", "chunked"])
@pytest.mark.parametrize("window", [3, None, "anchored"], ids=["clamped", "unclamped", "anchored"])
@pytest.mark.parametrize("width", _CARD_WIDTHS, ids=[w[0] for w in _CARD_WIDTHS])
def test_general_route_matches_plain_on_card(width, window, branch):
    """A forward and D backward on the general route against autograd of
    the plain version, through the dispatcher with the rule's branches
    ("rule": pixel, mma or chunked by the width and dtype) or with the
    chunked branch forced ("chunked"), clamped, unclamped and (dcn_3 and
    the mid-24 per-tap stage) anchored on the training grid: the output
    and the gradients of x, offset, mask, weight and (through the
    dispatcher) bias, f32 to 1e-4 of max|ref|, bf16 x and output gradient
    to 2e-2 of max|ref| of the f32 plain version on the same (rounded)
    values; A bit-equal over two runs
    and from a CUDA graph; dW, d-offset and d-mask bit-equal over two runs."""
    from crfp_torch.ops import anchor as an
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    wid, c, o, g, k, shared = width
    if window == "anchored" and wid not in _ANCHORED:
        pytest.skip(f"{wid}: no anchored geometry of this width on the card list")
    x, off, mask, w, b, gout = _card_operands(c, o, g, k, shared, seed=4)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        geom = None
        if window == "anchored":
            geom = an.dcn_geometry(*x.shape[2:], c, o, g, k, 3, bf16=dtype == torch.bfloat16,
                                   shared_taps=shared, shared_mask=shared, fullgrad=True)
        d = 3 if window == "anchored" else window
        kw = dict(max_displacement=d, shared_taps=shared, shared_mask=shared, anchor=geom)
        xx, gg = x.to(dtype), gout.to(dtype)
        fplan, bplan = _branch_plans(xx, o, g, k, shared, d, branch, geom)
        routes = [dcn.width_route(k_, c, o, g, k, k, shared=shared,
                                  tap_anchor=geom is not None and not shared)
                  for k_ in ("dcn_fwd", "dcn_bwd")]
        before = (dcn.general_launches, dcn.bwd_general_launches)
        if branch == "rule":
            leaves = [t.detach().clone().requires_grad_(True) for t in (xx, off, mask, w, b)]
            out = dcn.deform_conv2d_windowed(*leaves, **kw)
            out.backward(gg)
            grads = [t.grad for t in leaves]  # the bias's too
            # dg 16 at mid 32 (2 channels a group, O = 32) is a width of A's
            # tuned route; D's general route takes its 16 groups
            want_general = tuple(int(r == "general") for r in routes)
        else:
            out, table = dcn.dcn_forward(xx, off, mask, w, b, plan=fplan, with_table=True, **kw)
            grads = list(dcn.dcn_backward(xx, off, mask, w, gg, table=table, plan=bplan, **kw))
            want_general = (1, 1)
        torch.cuda.synchronize()
        assert (dcn.general_launches - before[0], dcn.bwd_general_launches - before[1]) == \
            want_general
        ref = [t.detach().float().clone().requires_grad_(True) for t in (xx, off, mask, w, b)]
        want = deform_conv2d_windowed_ref(*ref, **kw)
        want.backward(gg.float())
        assert _rel(out, want) <= tol
        for name, got, r in zip(("x", "offset", "mask", "weight", "bias"), grads, ref):
            assert _rel(got, r.grad) <= tol, (name, _rel(got, r.grad))
        if routes[0] == "general" or branch != "rule":
            def fwd():
                return dcn.dcn_forward(xx, off, mask, w, b, plan=fplan, **kw)
            first = fwd()
            assert torch.equal(first, fwd())
            assert torch.equal(captured_on_card(fwd), first)
        table = dcn.dcn_forward(xx, off, mask, w, b, with_table=True, **kw)[1]
        again = dcn.dcn_backward(xx, off, mask, w, gg, table=table, plan=bplan, **kw)
        first = dcn.dcn_backward(xx, off, mask, w, gg, table=table, plan=bplan, **kw)
        torch.cuda.synchronize()
        for a_, b_ in zip(first[1:], again[1:]):
            assert torch.equal(a_, b_)


def captured_on_card(fn):
    """``fn()`` replayed from a CUDA graph, its output zeroed before the
    replay (chip_smoke.py's ``captured``)."""
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
@pytest.mark.parametrize("branch", [None, "chunked"], ids=["rule", "chunked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_general_route_matches_tuned_at_mid32_on_card(dtype, branch):
    """At mid 32 both routes take the widths: A, D and E's general route
    named by ``plan=`` (the rule's branch, or the chunked one forced)
    against the tuned one on the same operands (f32 to 1e-5 of max|ref|;
    bf16 to 1e-2: both round the samples and the weight to bf16 and sum in
    f32, in other orders), and E's general route against its plain
    version."""
    from crfp_torch.ops.cuda import dcn_fused
    from crfp_torch.ops.dcn_windowed import deform_conv2d_fusedprep_ref

    tol = 1e-5 if dtype == torch.float32 else 1e-2
    bf16 = dtype == torch.bfloat16
    for c, o, g, shared, d in ((32, 32, 8, False, 8), (4, 4, 1, True, 32)):
        x, off, mask, w, b, gout = _card_operands(c, o, g, 3, shared, seed=5, hw=(45, 80),
                                                  d=d)
        x, gout = x.to(dtype), gout.to(dtype)
        kw = dict(max_displacement=d, shared_taps=shared, shared_mask=shared)
        plan = dcn.tile_plan(*x.shape, o, g, d, bf16=bf16, shared_mask=shared,
                             shared_taps=shared, route="general", branch=branch)
        bplan = dcn.bwd_plan(*x.shape, o, g, d, shared_taps=shared, shared_mask=shared,
                             route="general", branch=branch)
        assert _rel(dcn.dcn_forward(x, off, mask, w, b, plan=plan, **kw),
                    dcn.dcn_forward(x, off, mask, w, b, **kw)) <= tol
        for got, want in zip(dcn.dcn_backward(x, off, mask, w, gout, plan=bplan, **kw),
                             dcn.dcn_backward(x, off, mask, w, gout, **kw)):
            assert _rel(got, want) <= max(tol, 1e-4)
        if shared:
            continue
        gen = torch.Generator().manual_seed(6)
        raw_off = (torch.randn(1, g * 18, 45, 80, generator=gen)).cuda().to(dtype)
        raw_mask = torch.randn(1, g * 9, 45, 80, generator=gen).cuda().to(dtype)
        flow = (torch.randn(1, 2, 45, 80, generator=gen) * 2).cuda()
        x1 = x[:1].contiguous()
        fplan = dcn.tile_plan(*x1.shape, o, g, d, bf16=bf16, kernel="dcn_fused", route="general",
                              branch=branch)
        got = dcn_fused.deform_conv2d_fusedprep(x1, raw_off, raw_mask, flow, w, b,
                                                max_displacement=d, plan=fplan)
        assert _rel(got, dcn_fused.deform_conv2d_fusedprep(
            x1, raw_off, raw_mask, flow, w, b, max_displacement=d)) <= tol
        want = deform_conv2d_fusedprep_ref(x1.float(), raw_off.float(), raw_mask.float(), flow,
                                           w, b, max_displacement=d)
        assert _rel(got, want) <= (1e-4 if dtype == torch.float32 else 2e-2)
