"""Per-tap anchored windows (``DCNAlign(anchor=True)`` as a per-tap stage;
kernels A and D in per-tap anchored mode) in the port against the JAX
package, on the CPU.

- Module forward: the port's per-tap ``DCNAlign(anchor=True)`` (8 channels
  in 2 groups, 24x40, window 8, f32) against JAX's, its dispatch routed to
  the anchored Pallas kernel in interpret mode
  (``torch_parity.anchored_jax_dispatch``: off the TPU JAX drops
  ``anchor``), on the same numpy-seeded weights (``params.from_jax``) and a
  flow that is coherent within each cell of the f32 grid (8 x 32) and lies
  past ±8; within ``test_torch_anchor.py``'s ``F32_TOL``. The clamped stage
  misses JAX by more than 20 times that.
- Module backward (``anchor_vjp``): every gradient of the same stage on the
  training grid, inputs and parameters, against JAX's with its dispatch
  routed to ``deform_conv2d_pallas_vjp(anchor_vjp=True)``; within
  ``test_torch_anchor_train.py``'s ``atol 2e-4, rtol 1e-4``; the clamped
  stage's gradients miss by more than 20 tolerances.
- The route rule and the plans: which route takes a per-tap anchored call
  at O = 16, 32 and 64 (4, 8, 16 and 64 channels a group) and at mid 24;
  the plans take no zero border (``ops/cuda/dcn.py::border``), and the
  tuned routes refuse planes padded by the anchored reach; an anchored
  per-tap stage under ``fused_prep`` takes the structured path.
- On a card (marker ``cuda``): kernels A and D in per-tap anchored mode
  against their plain versions (autograd of it for D) on every route, two
  runs bit-equal, different from the clamp, per-tap anchored launches
  counted.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from crfp_torch.ops import anchor as an  # noqa: E402
from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref  # noqa: E402

torch.set_num_threads(1)

F32_TOL = dict(atol=5e-5, rtol=1e-4)  # tests/test_torch_anchor.py
GRAD_TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_torch_anchor_train.py
MISS = 20
M, G, H, W, D = 8, 2, 24, 40, 8


def _stage_inputs(seed: int = 5):
    """NHWC numpy (cur, pre, pre_aligned, flow) of a per-tap stage: a
    smooth field to sample, and a flow (dx, dy) constant within each cell
    of the f32 grid (band 8, xtile 32) up to +-1 px: rows +14 or -13, columns
    +40 or -38, cell by cell, so that every cell's anchor lies past ±8 and
    its mean far from a rounding boundary of the quanta (8 rows, 32
    columns)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    fr = rng.uniform(-0.3, 0.3, (2, M)).astype(np.float32)
    ph = rng.uniform(0, 6.3, (M,)).astype(np.float32)
    pre = np.sin(yy[..., None] * fr[0] + xx[..., None] * fr[1] + ph)[None].astype(np.float32)
    cur = rng.standard_normal((1, H, W, M)).astype(np.float32)
    pre_al = rng.standard_normal((1, H, W, M)).astype(np.float32)
    dy = np.where((np.arange(H) // 8) % 2 == 0, 14.0, -13.0)[:, None] + \
        rng.uniform(-1, 1, (H, W))
    dx = np.where((np.arange(W) // 32) % 2 == 0, 40.0, -38.0)[None, :] + \
        rng.uniform(-1, 1, (H, W))
    flow = np.stack([dx, dy], -1)[None].astype(np.float32)
    return cur, pre, pre_al, flow


def _jax_stage(args, **kw):
    """JAX's per-tap DCNAlign (window 8) and its parameters: the init's,
    with random heads and DCN weight (offset head std 0.02: the taps'
    residuals around the flow stay within the margins)."""
    import jax
    import jax.numpy as jnp
    import torch_parity as tp
    from crfp_tpu.nn.align import DCNAlign as JAlign

    jm = JAlign(M, G, 3, 10.0, window=D, anchor=True, **kw)
    flat = tp.perturb_heads(tp.flat_params(jm.init(jax.random.PRNGKey(0),
                                                   *(jnp.asarray(a) for a in args))),
                            seed=3, offset_std=0.02)
    return jm, flat


def _port_stage(flat, anchor: bool, **kw):
    from crfp_torch.nn.align import DCNAlign
    from crfp_torch.params import from_jax

    tm = DCNAlign(M, G, 3, 10.0, window=D, anchor=anchor, **kw)
    tm.load_state_dict(from_jax(flat), strict=True)
    return tm


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def test_per_tap_stage_forward_matches_jax(monkeypatch):
    import jax
    import jax.numpy as jnp
    import torch_parity as tp

    args = _stage_inputs()
    jm, flat = _jax_stage(args)
    tp.anchored_jax_dispatch(monkeypatch)
    # one jitted apply: eager interpret-mode Pallas dispatches op by op
    want_al, want_feat = jax.jit(jm.apply)(tp.unflatten(flat), *(jnp.asarray(a) for a in args))
    want_al = np.asarray(want_al)

    geom = an.dcn_geometry(H, W, M, M, G, 3, D, bf16=False, shared_taps=False,
                           shared_mask=False)
    assert (geom.band, geom.xtile, geom.a_y, geom.a_x) == (8, 32, 8, 32)
    with torch.no_grad():
        got_al, got_feat = _port_stage(flat, True)(*(_nchw(a) for a in args))
        clamp_al, _ = _port_stage(flat, False)(*(_nchw(a) for a in args))
    np.testing.assert_allclose(got_feat.permute(0, 2, 3, 1).numpy(), np.asarray(want_feat),
                               atol=1e-5, rtol=0)
    got = got_al.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want_al, **F32_TOL)
    miss = float(np.abs(clamp_al.permute(0, 2, 3, 1).numpy() - want_al).max())
    assert miss > MISS * F32_TOL["atol"], miss
    assert float(np.abs(want_al - args[1]).max()) > 0.1  # not the identity


def test_per_tap_stage_gradients_match_jax_anchor_vjp(monkeypatch):
    """Every gradient of ``sum(aligned * g)`` (inputs and parameters) of
    the stage with ``anchor_vjp`` (the training grid, which at these widths
    is the inference one: band 8 x xtile 32) against JAX's through
    ``deform_conv2d_pallas_vjp(anchor=True, anchor_vjp=True)``."""
    import jax
    import jax.numpy as jnp
    import torch_parity as tp
    from crfp_torch.params import to_jax

    args = _stage_inputs(seed=6)
    jm, flat = _jax_stage(args, anchor_vjp=True)
    geom = an.dcn_geometry(H, W, M, M, G, 3, D, bf16=False, shared_taps=False,
                           shared_mask=False, fullgrad=True)
    assert (geom.band, geom.xtile) == (8, 32)
    gout = np.random.default_rng(7).standard_normal((1, H, W, M)).astype(np.float32)
    tp.anchored_jax_dispatch(monkeypatch)
    params = tp.unflatten(flat)

    def loss(p, *a):
        return jnp.sum(jm.apply(p, *a)[0] * gout)

    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        params, *(jnp.asarray(a) for a in args))
    want_p = tp.flat_params(jg[0])
    want_x = [np.asarray(g) for g in jg[1:]]

    def port(anchor):
        tm = _port_stage(flat, anchor, anchor_vjp=True)
        xs = [_nchw(a).requires_grad_(True) for a in args]
        out, _ = tm(*xs)
        (out * _nchw(gout)).sum().backward()
        grads = {k: v.grad for k, v in tm.named_parameters()}
        flat_g = to_jax({k: g for k, g in grads.items()})
        return flat_g, [x.grad.permute(0, 2, 3, 1).numpy() for x in xs]

    got_p, got_x = port(True)
    for i, (g, w) in enumerate(zip(got_x, want_x)):
        np.testing.assert_allclose(g, w, err_msg=f"input {i}", **GRAD_TOL)
    assert set(got_p) == set(want_p)
    for k in want_p:
        np.testing.assert_allclose(np.asarray(got_p[k]), want_p[k], err_msg=k, **GRAD_TOL)

    def miss(got, want):
        return max(float(np.max(np.abs(g - w) / (GRAD_TOL["atol"] + GRAD_TOL["rtol"] *
                                                  np.abs(w)))) for g, w in zip(got, want))

    _, clamp_x = port(False)
    assert miss(clamp_x, want_x) > MISS


# ---- the route rule, the plans and the module's dispatch ---------------------

# (id, C, O, G, bf16, route of A, route of D): the per-tap stages at mid 16,
# 32 and 64 (A's O = 64 route at 4, 8, 16 and 64 channels a group, the
# pyramids' and PCD's), mid 24, and a per-tap call at dcn_3's tuned width
# O = 4, which the tuned routes take clamped and the general route anchored
WIDTHS = [("mid16", 16, 16, 8, True, "tuned", "tuned"),
          ("mid32", 32, 32, 8, True, "tuned", "tuned"),
          ("mid32_f32", 32, 32, 8, False, "tuned", "tuned"),
          ("o64_cpg4", 64, 64, 16, True, "tuned", "general"),
          ("o64_cpg8", 64, 64, 8, True, "tuned", "general"),
          ("o64_cpg16", 64, 64, 4, True, "tuned", "general"),
          ("o64_cpg64", 64, 64, 1, True, "tuned", "general"),
          ("o64_cpg16_f32", 64, 64, 4, False, "tuned", "general"),
          ("mid24", 24, 24, 8, True, "general", "general"),
          ("o4_cpg2", 4, 4, 2, True, "general", "general")]


@pytest.mark.parametrize("case", WIDTHS, ids=[c[0] for c in WIDTHS])
def test_per_tap_anchored_route_and_border(case):
    from crfp_torch.ops.cuda import dcn

    _, c, o, g, bf16, route_a, route_d = case
    geom = an.dcn_geometry(180, 180, c, o, g, 3, D, bf16=bf16, shared_taps=False,
                           shared_mask=False)
    assert dcn.width_route("dcn_fwd", c, o, g, 3, 3, bf16=bf16, tap_anchor=True) == route_a
    assert dcn.width_route("dcn_bwd", c, o, g, 3, 3, tap_anchor=True) == route_d
    if o < 16:  # clamped, the tuned routes take it
        assert dcn.width_route("dcn_fwd", c, o, g, 3, 3, bf16=bf16) == "tuned"
        assert dcn.width_route("dcn_bwd", c, o, g, 3, 3) == "tuned"
    # the reach: the column quantum of c / g channels a group
    lane_q = 128 // np.gcd(c // g, 128)
    assert geom.lane_q == lane_q and geom.reach == max(geom.a_y + geom.dl_r,
                                                       geom.a_x + geom.dl_c)
    pad = int(np.ceil(geom.reach)) + 1
    assert dcn.border(D, geom, shared_taps=False) is None
    assert dcn.border(D, geom, shared_taps=True) == geom.reach
    assert dcn.border(D) == D
    plan = dcn.tile_plan(1, c, 180, 180, o, g, dcn.border(D, geom), bf16=bf16, tap_anchor=True)
    bplan = dcn.bwd_plan(2, c, 48, 48, o, g, dcn.border(D, geom), tap_anchor=True)
    assert plan.route == route_a and bplan.route == route_d
    assert plan.pad == bplan.pad == 0
    # planes padded by the reach (pad - 1 >= reach): no tuned route takes
    # them for a per-tap anchored call, which reads frame-checked corners
    padded = dcn.tile_plan(1, c, 180, 180, o, g, geom.reach, bf16=bf16, tap_anchor=True)
    bpadded = dcn.bwd_plan(2, c, 48, 48, o, g, geom.reach, tap_anchor=True)
    for name, p, b16 in (("dcn_fwd", padded, bf16), ("dcn_bwd", bpadded, False)):
        if p.route == "tuned":
            assert p.pad == pad and p.pad - 1 >= geom.reach
            with pytest.raises(ValueError, match="frame-checked corners"):
                dcn.check_route(name, p.route, c, g, 3, 3, o, False, b16, True, p.pad)
            # the clamp and shared taps keep their borders
            dcn.check_route(name, p.route, c, g, 3, 3, o, False, b16, False, p.pad)
        else:
            assert p.pad == 0
            dcn.check_route(name, p.route, c, g, 3, 3, o, False, b16, True, p.pad)


def test_per_tap_anchored_dispatch_on_the_cpu():
    """On CPU tensors the dispatcher takes the plain version, per-tap
    anchored too, with autograd through it; the module builds per-tap
    anchored stages (the refusal is gone), and under ``fused_prep`` an
    anchored stage takes the structured path, not kernel E's dispatcher."""
    from crfp_torch.nn import align
    from crfp_torch.ops.cuda import dcn

    geom = an.dcn_geometry(16, 24, 8, 8, 2, 3, 8, bf16=False, shared_taps=False,
                           shared_mask=False)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 16, 24, generator=gen)
    off = torch.randn(1, 36, 16, 24, generator=gen) * 12.0
    mask = torch.rand(1, 18, 16, 24, generator=gen)
    wt = torch.randn(8, 8, 3, 3, generator=gen)
    leaves = [t.clone().requires_grad_(True) for t in (x, off, mask, wt)]
    out = dcn.deform_conv2d_windowed(*leaves, max_displacement=8, anchor=geom)
    ref = deform_conv2d_windowed_ref(x, off, mask, wt, max_displacement=8, anchor=geom)
    assert torch.equal(out, ref)
    out.sum().backward()
    assert all(t.grad is not None for t in leaves)
    with pytest.raises(ValueError, match="CUDA tensor"):  # A alone: the card only
        dcn.dcn_forward(x, off, mask, wt, anchor=geom)

    calls = []
    fused = align.deform_conv2d_fusedprep
    align.deform_conv2d_fusedprep = lambda *a, **k: calls.append(1) or fused(*a, **k)
    try:
        args = [torch.from_numpy(a) for a in _stage_inputs()]
        args = [a.permute(0, 3, 1, 2).contiguous() for a in args]
        with torch.no_grad():
            stage = align.DCNAlign(M, G, 3, 10.0, window=D, anchor=True, fused_prep=True)
            got, _ = stage(*args)
            stage.fused_prep = False
            want, _ = stage(*args)
            stage.anchor = False
            stage.fused_prep = True
            stage(*args)
    finally:
        align.deform_conv2d_fusedprep = fused
    assert calls == [1]  # only the unanchored stage took kernel E's dispatcher
    assert torch.equal(got, want)


# ---- on a card ----------------------------------------------------------------
#   python -m pytest tests/test_torch_anchor_per_tap.py --noconftest -m cuda -q

_NEEDS_CARD = pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs an NVIDIA GPU and nvcc")


def _card_operands(n, c, g, h, w, dtype, seed):
    """x, per-tap offsets (a smooth field of +-1.7 D that changes from cell
    to cell, plus +-2 px per tap), mask, weight, bias, on the card."""
    gen = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    base = torch.stack([1.7 * D * torch.sin(yy / 9.0 + xx / 13.0),
                        -1.8 * D * torch.cos(xx / 11.0 - yy / 17.0)])
    off = base.repeat(g * 9, 1, 1)[None].repeat(n, 1, 1, 1)
    off = off + (torch.rand(n, g * 18, h, w, generator=gen) * 4 - 2)
    x = torch.randn(n, c, h, w, generator=gen).to(dtype)
    mask = torch.rand(n, g * 9, h, w, generator=gen)
    wt = torch.randn(c, c, 3, 3, generator=gen) * 0.1
    b = torch.randn(c, generator=gen)
    return [t.cuda() for t in (x, off.contiguous(), mask, wt, b)]


# (id, C, G, (h, w)): the tuned routes at mid 32 and 16, O = 64 at 8
# channels a group, the general route at mid 24, O = 64 at 4, 16 and 64
# channels a group
CARD_WIDTHS = [("mid32", 32, 8, (75, 83)), ("mid16", 16, 8, (75, 83)),
               ("o64_cpg8", 64, 8, (45, 80)), ("mid24", 24, 8, (75, 83)),
               ("o64_cpg4", 64, 16, (45, 80)), ("o64_cpg16", 64, 4, (45, 80)),
               ("o64_cpg64", 64, 1, (45, 80))]


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CARD_WIDTHS, ids=[c[0] for c in CARD_WIDTHS])
def test_per_tap_anchored_kernel_a_matches_plain_on_card(case, dtype):
    from crfp_torch.ops.cuda import dcn

    _, c, g, (h, w) = case
    x, off, mask, wt, b = _card_operands(1, c, g, h, w, dtype, 0)
    bf16 = dtype == torch.bfloat16
    geom = an.dcn_geometry(h, w, c, c, g, 3, D, bf16=bf16, shared_taps=False,
                           shared_mask=False)
    want = deform_conv2d_windowed_ref(x.float(), off, mask, wt, b, max_displacement=D,
                                      anchor=geom)
    before = dcn.tap_anchor_launches
    got = dcn.dcn_forward(x, off, mask, wt, b, max_displacement=D, anchor=geom)
    again = dcn.dcn_forward(x, off, mask, wt, b, max_displacement=D, anchor=geom)
    clamp = dcn.dcn_forward(x, off, mask, wt, b, max_displacement=D)
    torch.cuda.synchronize()
    tol = 1e-4 if not bf16 else 2e-2 * float(want.abs().max())
    assert dcn.tap_anchor_launches == before + 2
    assert float((got.float() - want).abs().max()) <= tol
    assert torch.equal(got, again)
    assert float((clamp.float() - want).abs().max()) > MISS * tol


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [CARD_WIDTHS[0], CARD_WIDTHS[3]], ids=["mid32", "mid24"])
def test_per_tap_anchored_kernel_d_matches_plain_on_card(case, dtype):
    from crfp_torch.ops.cuda import dcn

    _, c, g, _ = case
    n, h, w = 2, 48, 48
    x, off, mask, wt, b = _card_operands(n, c, g, h, w, dtype, 1)
    gout = torch.randn(n, c, h, w, generator=torch.Generator().manual_seed(2)).to(dtype).cuda()
    geom = an.dcn_geometry(h, w, c, c, g, 3, D, bf16=dtype == torch.bfloat16,
                           shared_taps=False, shared_mask=False, fullgrad=True)

    def grads(fn, xx):
        leaves = [t.detach().clone().requires_grad_(True) for t in (xx, off, mask, wt)]
        fn(*leaves, None, max_displacement=D, anchor=geom).backward(gout.to(xx.dtype))
        return [t.grad.float() for t in leaves]

    want = grads(deform_conv2d_windowed_ref, x.float())
    before = dcn.bwd_tap_anchor_launches
    got = grads(dcn.deform_conv2d_windowed, x)
    _, table = dcn.dcn_forward(x, off, mask, wt, max_displacement=D, anchor=geom,
                               with_table=True)
    bits = dcn.dcn_backward(x, off, mask, wt, gout, max_displacement=D, anchor=geom,
                            table=table)
    again = dcn.dcn_backward(x, off, mask, wt, gout, max_displacement=D, anchor=geom,
                             table=table)
    clamp = dcn.dcn_backward(x, off, mask, wt, gout, max_displacement=D)
    torch.cuda.synchronize()
    assert dcn.bwd_tap_anchor_launches == before + 3
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for i, (a, wnt) in enumerate(zip(got, want)):
        assert float((a - wnt).abs().max()) <= rel * float(wnt.abs().max()), i
    assert all(torch.equal(p, q) for p, q in zip(bits[1:], again[1:]))
    assert float((clamp[1] - bits[1]).abs().max()) > 0.1 * float(bits[1].abs().max())
