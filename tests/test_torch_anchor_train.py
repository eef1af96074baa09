"""Anchored training (``ModelConfig.dcn_anchor_vjp``) in the port against
the JAX package, on the CPU.

- Op level: every gradient of the port's plain anchored DCN (shared taps,
  at r = 1 and in the s2d(4) operand form; per-tap at r = 1) and warp (the
  full-resolution grid and the s2d(4) one) against ``crfp_tpu``'s differentiable entries
  with ``anchor=True, anchor_vjp=True, interpret=True``, and the
  fallback geometry of tests/test_pallas_dcn.py:401-430 (D 64, C 64,
  16x16, band 8 / xtile 8, where JAX differentiates in XLA at the resolved
  grid); within JAX's own ``atol 2e-4, rtol 1e-4``
  (tests/test_pallas_dcn.py:368-398). In every case the port at the ±D
  clamp, and at another grid (the inference one; per-tap, where the two
  coincide, cells of 16 rows), misses JAX by more than 20 times the
  tolerance.
- The grid: ``anchor_geometry(fullgrad=True)`` held to the grid JAX's
  anchored VJP resolves, through its outputs (bf16 dcn_3: band 16; the HR
  warp: band 40 in f32, 48 in bf16).
- Model level: one Charbonnier loss of the batch CRFP v18 (mid 16, T 3,
  LR 8, B 1, f32) and every leaf's gradient with ``dcn_anchor`` and
  ``dcn_anchor_vjp``, ``hr_s2d`` off and on, against JAX's
  ``value_and_grad`` with its dispatch routed to the anchored VJP entries
  (``torch_parity.anchored_jax_dispatch``), the HR flow pushed past ±32 on
  part of the frame: 1e-4 on the output, every gradient within 1e-4 of its
  leaf's max|ref| (tests/test_torch_train.py's tolerances).
- The tree: an anchored-trained parameter tree through ``from_jax`` and
  ``to_jax`` both ways.
- On a card (marker ``cuda``): kernel D's two anchored modes against
  autograd of their plain versions, bit-equal d-offset, d-mask and dW
  over two runs, different from the clamped backward's.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from crfp_torch.ops import anchor as an  # noqa: E402
from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref  # noqa: E402
from crfp_torch.ops.warp import flow_warp_windowed_ref  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-4)
# what a port that ignores the anchor, or takes another cell grid, misses
# JAX by at the least, in tolerances
MISS = 20


def _field(rng, n, h, w, d, amp=(1.6, 1.5), noise=3.0):
    """(n, h, w, 2) offsets (dy, dx): a smooth field of amplitude ``amp`` x
    D that changes from cell to cell, plus ``noise`` px of white noise."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([amp[0] * d * np.sin(yy / 9.0 + xx / 13.0),
                     -amp[1] * d * np.cos(xx / 11.0 - yy / 17.0)], -1)
    return (base[None] + rng.uniform(-noise, noise, (n, h, w, 2))).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())


def _miss(got, want):
    """How far ``got`` is from ``want`` in units of the tolerance: the
    largest |d| / (atol + rtol |want|) over every element of every pair."""
    return max(float(np.max(np.abs(g - w) / (TOL["atol"] + TOL["rtol"] * np.abs(w))))
               for g, w in zip(got, want))


def _torch_grads(fn, inputs, gout):
    """Every gradient of ``sum(fn(*inputs) * gout)`` as NHWC-free numpy."""
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True) for a in inputs]
    out = fn(*leaves)
    out.backward(torch.from_numpy(gout))
    return [leaf.grad.numpy() for leaf in leaves]


def _jax_grads(fn, inputs, gout):
    import jax
    import jax.numpy as jnp

    # one jitted pullback: eager interpret-mode Pallas dispatches op by op
    grads = jax.jit(lambda g, *a: jax.vjp(fn, *a)[1](g))(
        jnp.asarray(gout), *(jnp.asarray(a) for a in inputs))
    return [np.asarray(g) for g in grads]


# (id, s2d r, (h, w), shared): c = 8 channels in f32; shared taps and mask
# in one group (dcn_3's mode), where the training grid (band 8 x xtile 16) is
# not the inference one (8 x 32); per-tap in 2 groups (4 channels a group,
# column quantum 32), where the two grids coincide (8 x 32) and a grid of
# 16-row cells stands for another one
DCN_CASES = [("r1", 1, (24, 40), True), ("s2d4", 4, (40, 56), True),
             ("per_tap_r1", 1, (24, 40), False)]


@pytest.mark.parametrize("case", DCN_CASES, ids=[c[0] for c in DCN_CASES])
def test_plain_anchored_dcn_grads_match_pallas_vjp(case):
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.dcn import deform_conv2d_pallas_vjp
    from crfp_tpu.ops.shuffle import pixel_shuffle, pixel_unshuffle

    _, r, (h, w), shared = case
    d, n, c = 16, 1, 8
    g, k = (1, 1) if shared else (2, 9)
    rng = np.random.default_rng(10 + r + (not shared))
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = _field(rng, n, h, w, d)
    if not shared:  # each tap its own offset: the field plus +-3 px a tap
        off = (off[:, :, :, None, None] + rng.uniform(-3, 3, (n, h, w, g, k, 2))
               ).astype(np.float32)
    mk = rng.uniform(0, 1, (n, h, w, g * k)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, c)) * 0.2).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    gout = rng.standard_normal((n, h, w, c)).astype(np.float32)
    geom = an.dcn_geometry(h, w, c, c, g, 3, d, bf16=False, shared_taps=shared,
                           shared_mask=shared, s2d=r, fullgrad=True)
    infer = an.dcn_geometry(h, w, c, c, g, 3, d, bf16=False, shared_taps=shared,
                            shared_mask=shared, s2d=r)
    if shared:
        assert (geom.band, geom.xtile) == (8, 16) and (infer.band, infer.xtile) == (8, 32)
    else:
        assert geom == infer and (geom.band, geom.xtile) == (8, 32)
        infer = an.AnchorGeometry(**{**geom.__dict__, "band": 16})

    def jax_fn(x, off, mk, wt, b):
        o6, m5 = off.reshape(n, h, w, g, k, 2), mk.reshape(n, h, w, g, k)
        kw = dict(max_displacement=d, band=8, shared_taps=shared, shared_mask=shared,
                  anchor=True, anchor_vjp=True, interpret=True)
        if r == 1:
            return deform_conv2d_pallas_vjp(x, o6, m5, wt, b, **kw)
        hs, ws = h // r, w // r
        o_s = pixel_unshuffle(o6.reshape(n, h, w, 2), r).reshape(n, hs, ws, 1, 1, 2, r * r)
        m_s = pixel_unshuffle(m5.reshape(n, h, w, 1), r).reshape(n, hs, ws, 1, 1, r * r)
        return pixel_shuffle(deform_conv2d_pallas_vjp(pixel_unshuffle(x, r), o_s, m_s, wt, b,
                                                      s2d=r, **kw), r)

    want = _jax_grads(jax_fn, (x, off, mk, wt, b), gout)

    def port(**kw):
        def fn(x, off, mk, wt, b):
            out = deform_conv2d_windowed_ref(
                x.permute(0, 3, 1, 2), off.reshape(n, h, w, -1).permute(0, 3, 1, 2),
                mk.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), b, shared_taps=shared,
                shared_mask=shared, **kw)
            return out.permute(0, 2, 3, 1)
        return _torch_grads(fn, (x, off, mk, wt, b), gout)

    got = port(anchor=geom)
    for i, (g_, wnt) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g_, wnt, err_msg=f"gradient {i}", **TOL)
    assert _miss(port(max_displacement=d), want) > MISS
    assert _miss(port(anchor=infer), want) > MISS


# (id, s2d r, c): the full-resolution grid at dcn_3's mid-32 width (training
# band 40, inference 64) and the s2d(4) one at mid 16's (16 and 32)
WARP_CASES = [("full_c4", 1, 4), ("s2d4_c2", 4, 2)]


@pytest.mark.parametrize("case", WARP_CASES, ids=[c[0] for c in WARP_CASES])
def test_plain_anchored_warp_grads_match_pallas_vjp(case):
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.warp import (flow_warp_windowed_pallas,
                                          flow_warp_windowed_pallas_s2d)
    from crfp_tpu.ops.shuffle import pixel_shuffle, pixel_unshuffle

    _, r, c = case
    d, n, h, w = 16, 1, 88, 72
    rng = np.random.default_rng(20 + r)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = _field(rng, n, h, w, d)
    flow = np.stack([off[..., 1], off[..., 0]], -1)  # (dx, dy)
    gout = rng.standard_normal((n, h, w, c)).astype(np.float32)
    geom = an.warp_geometry(h, w, c, d, bf16=False, s2d=r, fullgrad=True)
    infer = an.warp_geometry(h, w, c, d, bf16=False, s2d=r)
    assert (geom.band, infer.band) == ((40, 64) if r == 1 else (16, 32))

    def jax_fn(x, flow):
        kw = dict(max_displacement=d, anchor=True, anchor_vjp=True, interpret=True)
        if r == 1:
            return flow_warp_windowed_pallas(x, flow, **kw)
        return pixel_shuffle(flow_warp_windowed_pallas_s2d(
            pixel_unshuffle(x, r), pixel_unshuffle(flow, r), r=r, **kw), r)

    want = _jax_grads(jax_fn, (x, flow), gout)

    def port(geom, clamp=d):
        def fn(x, flow):
            return flow_warp_windowed_ref(x.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2),
                                          clamp, geom).permute(0, 2, 3, 1)
        return _torch_grads(fn, (x, flow), gout)

    got = port(geom)
    for i, (g, wnt) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, wnt, err_msg=f"gradient {i}", **TOL)
    assert _miss(port(None), want) > MISS
    assert _miss(port(infer), want) > MISS


def test_plain_anchored_grads_fallback_geometry():
    """tests/test_pallas_dcn.py:401-430's case: the k = 1 DCN of an identity
    weight, no mask, D 64, C 64, 16x16, requested band 8 / xtile 8. JAX's
    Pallas backward is over its VMEM guard even at the floor geometry (band
    8, xtile 16), so it differentiates the effective offsets in XLA at that
    resolved grid; the port's training grid is that grid, and there the
    inference request resolves the same cells, so the guard holds the port
    to it against the clamp and the requested, unrounded 8 x 8 cells."""
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.dcn import deform_conv2d_pallas_vjp

    rng = np.random.default_rng(31)
    n, h, w, c, d = 1, 16, 16, 64, 64
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = rng.uniform(-40, 40, (n, h, w, 2)).astype(np.float32)
    gout = rng.standard_normal((n, h, w, c)).astype(np.float32)
    kw = dict(bf16=False, shared_taps=False, has_mask=False, band=8, xtile=8)
    geom = an.anchor_geometry(h, w, c, c, 1, 1, d, fullgrad=True, **kw)
    assert (geom.band, geom.xtile) == (8, 16)
    assert an.anchor_geometry(h, w, c, c, 1, 1, d, **kw) == geom
    eye = np.eye(c, dtype=np.float32).reshape(1, 1, c, c)

    def jax_fn(x, flow):
        off = jnp.stack([flow[..., 1], flow[..., 0]], -1).reshape(n, h, w, 1, 1, 2)
        return deform_conv2d_pallas_vjp(x, off, None, jnp.asarray(eye), None,
                                        max_displacement=d, band=8, xtile=8, anchor=True,
                                        anchor_vjp=True, interpret=True)

    want = _jax_grads(jax_fn, (x, flow), gout)

    def port(geom, clamp=d):
        def fn(x, flow):
            return flow_warp_windowed_ref(x.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2),
                                          clamp, geom).permute(0, 2, 3, 1)
        return _torch_grads(fn, (x, flow), gout)

    got = port(geom)
    for i, (g, wnt) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, wnt, err_msg=f"gradient {i}", **TOL)
    assert _miss(port(None), want) > MISS
    asked = an.AnchorGeometry(**{**geom.__dict__, "xtile": 8})
    assert _miss(port(asked), want) > MISS


# (id, op, bf16, training band, inference band, rows a motion band spans, h):
# row motion that changes every ``rows`` rows, so cells of the training and
# of the inference height see different means
GRID_CASES = [("dcn3_bf16", "dcn", True, 16, 32, 16, 72),
              ("warp_f32", "warp", False, 40, 64, 40, 104),
              ("warp_bf16", "warp", True, 48, 64, 48, 120)]


@pytest.mark.parametrize("case", GRID_CASES, ids=[c[0] for c in GRID_CASES])
def test_training_grid_through_outputs(case):
    """``anchor_geometry(fullgrad=True)`` is the grid JAX's anchored VJP
    resolves (crfp_tpu/ops/pallas/dcn.py:884-900): the forward of
    ``deform_conv2d_pallas_vjp(anchor=True, anchor_vjp=True)`` agrees with
    the port at the training grid and not at the inference one, at dcn_3's
    and the HR warp's mid-32 width (4 channels), D = 32."""
    import jax
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.dcn import deform_conv2d_pallas_vjp

    _, op, bf16, band, infer_band, rows, h = case
    n, w, c, d = 1, 64, 4, 32
    rng = np.random.default_rng(40)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = np.zeros((n, h, w, 2), np.float32)
    off[..., 0] = np.where((np.arange(h) // rows) % 2 == 0, 40.0, -8.0)[None, :, None]
    off[..., 1] = 20.0
    off += rng.uniform(-2, 2, off.shape).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jx = jnp.asarray(x, jdt)
    tx = _nchw(np.asarray(jx.astype(jnp.float32)))
    tx = tx.bfloat16() if bf16 else tx
    kw = dict(bf16=bf16)
    if op == "dcn":
        mk = rng.uniform(0, 1, (n, h, w)).astype(np.float32)
        wt = (rng.standard_normal((3, 3, c, c)) * 0.2).astype(np.float32)
        want = jax.jit(lambda x, o, m, k: deform_conv2d_pallas_vjp(
            x, o.reshape(n, h, w, 1, 1, 2), m.reshape(n, h, w, 1, 1), k, None,
            max_displacement=d, band=32 if bf16 else 8, shared_taps=True, shared_mask=True,
            anchor=True, anchor_vjp=True, interpret=True))(jx, off, mk, wt)
        geom = an.dcn_geometry(h, w, c, c, 1, 3, d, shared_taps=True, shared_mask=True,
                               fullgrad=True, **kw)
        infer = an.dcn_geometry(h, w, c, c, 1, 3, d, shared_taps=True, shared_mask=True, **kw)

        def port(g):
            return deform_conv2d_windowed_ref(tx, _nchw(off), torch.from_numpy(mk)[:, None],
                                              torch.from_numpy(wt).permute(3, 2, 0, 1),
                                              shared_taps=True, shared_mask=True, anchor=g)
    else:
        from crfp_tpu.ops.pallas.warp import flow_warp_windowed_pallas

        flow = np.stack([off[..., 1], off[..., 0]], -1)
        want = jax.jit(lambda x, f: flow_warp_windowed_pallas(
            x, f, max_displacement=d, anchor=True, anchor_vjp=True, interpret=True))(jx, flow)
        geom = an.warp_geometry(h, w, c, d, fullgrad=True, **kw)
        infer = an.warp_geometry(h, w, c, d, **kw)

        def port(g):
            return flow_warp_windowed_ref(tx, _nchw(flow), d, g)
    assert (geom.band, infer.band) == (band, infer_band)
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-2 * float(np.abs(want).max()) if bf16 else 5e-5

    def err(g):
        return _err(port(g).float().permute(0, 2, 3, 1).numpy(), want)

    assert err(geom) <= tol, err(geom)
    assert err(infer) > MISS * tol, err(infer)


# ---- model level ------------------------------------------------------------

_WIN = dict(dcn_window=8, dcn_window_hr=32)


def _trunk_leaves(scale):
    """(batch, leaves) of tests/test_torch_train.py's setup (mid 16, T 3,
    LR 8, B 1): the port's seeded init through ``to_jax`` (a JAX ``init``
    would compile the trunk once more), with perturbed heads and the flow
    net's bias and ``scale`` times its own variation."""
    import torch_parity as tp
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import to_jax
    from test_torch_train import MID, clip_batch

    flat = to_jax(CRFP(ModelConfig(mid_channels=MID), device="cpu", seed=0).state_dict())
    flat = tp.perturb_heads(flat, seed=1)
    return clip_batch(), tp.set_flow_bias(flat, dy=4.6, dx=-5.3, scale=scale)


@pytest.fixture(scope="module")
def trunk():
    """:func:`_trunk_leaves` at 1.25 times the flow net's variation, so
    that the HR flow passes ±32 on part of the frame and varies within the
    warp's cells by more than their ±14 px margin: the training grid (band
    16) and the inference one (band 32) then give other gradients."""
    return _trunk_leaves(1.25)


def _port_step(flat, batch, **cfg):
    """(output, loss, every leaf's gradient in the JAX tree's names) of the
    port's trunk on the CPU, remat on."""
    from crfp_torch.params import to_jax
    from crfp_torch.train.loop import charbonnier_loss
    from test_torch_train import torch_crfp

    model = torch_crfp(flat, remat=True, **cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    sr = model(tb["lr"], tb["fv"], tb["mk"])
    loss = charbonnier_loss(sr, tb["hr"])
    loss.backward()
    grads = to_jax({n: p.grad for n, p in model.named_parameters()})
    return sr.detach().numpy(), float(loss.detach()), grads


@pytest.mark.parametrize("hr_s2d", [False, True], ids=["full_grid", "s2d_grid"])
def test_trunk_anchored_loss_and_every_gradient_match_jax(trunk, monkeypatch, hr_s2d):
    import jax
    import jax.numpy as jnp
    import torch_parity as tp
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from test_torch_train import _jloss, jax_cfg

    tp.anchored_jax_dispatch(monkeypatch)
    batch, flat = trunk
    cfg = dict(**_WIN, hr_s2d=hr_s2d, dcn_anchor=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jsr), jg = jax.jit(jax.value_and_grad(_jloss(JCRFP(jax_cfg(
        **cfg, dcn_anchor_vjp=True))), has_aux=True))(tp.unflatten(flat), jb)
    want_sr, want = np.asarray(jsr), tp.flat_params(jg)

    def miss(got):
        """(max output |d| / 1e-4, the worst leaf's |d| / (1e-4 max|ref|))."""
        sr, _, grads = got
        assert sorted(grads) == sorted(want) and len(want) == len(flat)
        return _err(sr, want_sr) / 1e-4, max(
            float(np.abs(grads[k] - w).max()) / (1e-4 * float(np.abs(w).max())) for k, w in
            want.items())

    got = _port_step(flat, batch, **cfg, dcn_anchor_vjp=True)
    np.testing.assert_allclose(got[1], float(jl), rtol=1e-5)
    out_miss, grad_miss = miss(got)
    assert out_miss <= 1.0 and grad_miss <= 1.0, (out_miss, grad_miss)
    # the HR motion passes the window on part of the frame
    from test_torch_train import torch_crfp

    with torch.no_grad():
        lr = torch.from_numpy(batch["lr"]).permute(0, 1, 4, 2, 3)
        hr_flow = torch_crfp(flat).compute_flow(lr[:, 1], lr[:, 0]) * 8.0
    assert 0.02 < float((hr_flow.abs() > 32).float().mean()) < 0.9
    # the clamp and the inference grid miss JAX by far more
    assert max(miss(_port_step(flat, batch, **_WIN))) > MISS
    assert max(miss(_port_step(flat, batch, **cfg))) > MISS


def test_trunk_anchored_gradients_at_2x_flow_are_f32_noise(monkeypatch):
    """ROADMAP queue 3 item F1, settled on the CPU. At twice the flow net's
    variation of the case above, JAX's and the port's f32 gradients leave
    each other by ~5 tolerances on a few leaves (dcn_3's
    dcn_block_conv1 bias first). The JAX package cannot run this case in
    float64: its anchored kernel and its XLA mirror compute in float32
    (crfp_tpu/ops/pallas/dcn.py:1275 casts the offsets; under
    jax_enable_x64 a 1e-12 change of x leaves the Pallas kernel's output
    bit for bit). The port's plain versions run it in float64 here
    (``Tensor.float`` kept from narrowing float64 inside the test, the
    trunk and batch in float64). Against that answer JAX's f32 gradients
    lie no farther than the port's own f32 ones (read on the CPU: JAX
    1.67, the port 3.41 tolerances, on that bias; at 1.25x both 0.15-0.19):
    the gap between the two f32 runs is f32 rounding on both sides, not a
    fault. The loss agrees to 1e-5 either way."""
    import jax
    import jax.numpy as jnp
    import torch_parity as tp
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from test_torch_train import _jloss, jax_cfg, torch_crfp

    from crfp_torch.params import to_jax
    from crfp_torch.train.loop import charbonnier_loss

    batch, flat = _trunk_leaves(2.0)
    cfg = dict(**_WIN, dcn_anchor=True)
    with monkeypatch.context() as m:
        tp.anchored_jax_dispatch(m)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (jl, _), jg = jax.jit(jax.value_and_grad(_jloss(JCRFP(jax_cfg(
            **cfg, dcn_anchor_vjp=True))), has_aux=True))(tp.unflatten(flat), jb)
    want = {k: np.asarray(v, np.float64) for k, v in tp.flat_params(jg).items()}

    def port64():
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "float",
                      lambda self: self if self.dtype == torch.float64 else self.to(torch.float32))
            model = torch_crfp(flat, remat=True, **cfg, dcn_anchor_vjp=True).double()
            tb = {k: torch.from_numpy(v).double() for k, v in batch.items()}
            loss = charbonnier_loss(model(tb["lr"], tb["fv"], tb["mk"]), tb["hr"])
            loss.backward()
            return float(loss.detach()), to_jax({n: p.grad for n, p in model.named_parameters()})

    loss64, truth = port64()
    _, loss32, got = _port_step(flat, batch, **cfg, dcn_anchor_vjp=True)

    def miss(grads):
        """The worst leaf's |d| from the f64 gradients, in 1e-4 of its max|ref|."""
        return max(float(np.abs(grads[k].astype(np.float64) - w).max())
                   / (1e-4 * float(np.abs(w).max())) for k, w in truth.items())

    assert sorted(want) == sorted(truth) == sorted(got)
    np.testing.assert_allclose([float(jl), loss32], loss64, rtol=1e-5)
    jax_miss, port_miss = miss(want), miss(got)
    assert jax_miss <= max(port_miss, 1.0), (jax_miss, port_miss)


def test_anchored_tree_round_trips():
    """An anchored-trained parameter tree (checkpoints/v18_mid32_struct_anchored.npz)
    through ``from_jax`` into the trunk trained with ``dcn_anchor_vjp``
    (strictly) and back through ``to_jax``, bit for bit: the anchored
    configuration adds no parameter."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, load_npz, to_jax

    flat = load_npz("checkpoints/v18_mid32_struct_anchored.npz")
    model = CRFP(ModelConfig(mid_channels=32, **_WIN, hr_s2d=True, dcn_anchor=True,
                             dcn_anchor_vjp=True), device="cpu")
    model.load_state_dict(from_jax(flat), strict=True)
    back = to_jax(model.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_anchored_backward_entries_take_the_forward_table(monkeypatch):
    """Kernel D's dispatchers hand their C entry the forward's table and
    the anchored geometry (``kernel_args``, as kernels A and B take it),
    sized from the reach, in the order of the entry's argument types; a call
    without its table, or with another table, raises before any launch."""
    from crfp_torch.ops.cuda import _build, dcn, warp

    sent = []
    monkeypatch.setattr(_build, "launch", lambda lib, entry, argtypes, device, *a:
                        sent.append((entry, argtypes, a)))
    monkeypatch.setattr(dcn, "_check", lambda *a: 1)
    monkeypatch.setattr(dcn, "sm_count", lambda device: 132)
    monkeypatch.setattr(warp, "_check", lambda x, flow: x.shape)
    n, c, h, w = 2, 4, 192, 192
    geom = an.dcn_geometry(h, w, c, c, 1, 3, 32, bf16=True, shared_taps=True,
                           shared_mask=True, fullgrad=True)
    x, gout = torch.zeros(n, c, h, w, dtype=torch.bfloat16), torch.zeros(n, c, h, w,
                                                                         dtype=torch.bfloat16)
    off, mask, wt = torch.zeros(n, 2, h, w), torch.zeros(n, 1, h, w), torch.zeros(c, c, 3, 3)
    table = torch.zeros(n, 1, *geom.cells(h, w), 2)
    kw = dict(max_displacement=32, shared_taps=True, shared_mask=True, anchor=geom)
    before = dcn.bwd_anchor_launches
    dcn.dcn_backward(x, off, mask, wt, gout, table=table, **kw)
    entry, argtypes, args = sent[-1]
    assert entry == "crfp_dcn_bwd" and len(args) + 1 == len(argtypes)
    plan = dcn.bwd_plan(n, c, h, w, c, 1, geom.reach, shared_taps=True)
    assert plan.pad == 62 and tuple(args[-7:]) == plan.args()
    assert args[19] == geom.reach and args[23] == table.data_ptr()
    assert tuple(args[24:32]) == an.kernel_args(geom)
    assert dcn.bwd_anchor_launches == before + 1
    for bad in (None, table[:, :, :-1].contiguous()):
        with pytest.raises(ValueError, match="table"):
            dcn.dcn_backward(x, off, mask, wt, gout, table=bad, **kw)
    wgeom = an.warp_geometry(h, w, c, 32, bf16=True, fullgrad=True)
    wtable = torch.zeros(n, 1, *wgeom.cells(h, w), 2)
    warp.flow_warp_backward(x, off, gout, 32, anchor=wgeom, table=wtable)
    entry, argtypes, args = sent[-1]
    assert entry == "crfp_flow_warp_bwd" and len(args) + 1 == len(argtypes)
    assert args[12] == wtable.data_ptr() and tuple(args[13:]) == an.kernel_args(wgeom)
    with pytest.raises(ValueError, match="table"):
        warp.flow_warp_backward(x, off, gout, 32, anchor=wgeom)
    monkeypatch.setattr(dcn, "bwd_anchor_launches", before)
    monkeypatch.setattr(warp, "bwd_anchor_launches", warp.bwd_anchor_launches - 1)


# ---- on a card ----------------------------------------------------------------
#   python -m pytest tests/test_torch_anchor_train.py --noconftest -m cuda -q

_NEEDS_CARD = pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs an NVIDIA GPU and nvcc")


def _card_operands(n, c, h, w, d, seed, dtype):
    """x in ``dtype``, a smooth offset field (dy, dx) whose cell anchors
    reach ±D, the output gradient in ``dtype``; on the card."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32))
    off = _nchw(_field(rng, n, h, w, d, amp=(1.7, 1.8), noise=1.0))
    gout = torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32))
    return x.to(dtype).cuda(), off.cuda(), gout.to(dtype).cuda()


def _card_grads(fn, inputs, gout):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, gout)


def _assert_close(got, want, rel):
    for i, (g, w) in enumerate(zip(got, want)):
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * float(w.abs().max()), (i, err, float(w.abs().max()))


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_anchored_kernel_d_dcn_matches_plain_on_card(dtype):
    """Kernel D's anchored shared-tap mode (dcn_3) against autograd of the
    plain version at the training grid: f32 to 1e-4 and bf16 to 2e-2 of
    max|ref|, d-offset, d-mask and dW bit-equal over two runs, d-offset
    other than the clamped backward's."""
    from crfp_torch.ops.cuda import dcn

    n, c, h, w, d = 2, 4, 75, 83, 32
    bf16 = dtype == torch.bfloat16
    x, off, gout = _card_operands(n, c, h, w, d, 5, dtype)
    gen = torch.Generator().manual_seed(5)
    mask = torch.rand(n, 1, h, w, generator=gen).cuda()
    wt = (torch.randn(c, c, 3, 3, generator=gen) * 0.2).cuda()
    b = torch.randn(c, generator=gen).cuda()
    geom = an.dcn_geometry(h, w, c, c, 1, 3, d, bf16=bf16, shared_taps=True,
                           shared_mask=True, fullgrad=True)
    kw = dict(shared_taps=True, shared_mask=True, max_displacement=d)
    before = dcn.bwd_anchor_launches
    got = _card_grads(lambda *a: dcn.deform_conv2d_windowed(*a, anchor=geom, **kw),
                      (x, off, mask, wt, b), gout)
    assert dcn.bwd_anchor_launches == before + 1
    want = _card_grads(lambda *a: deform_conv2d_windowed_ref(*a, anchor=geom, **kw),
                       (x.float(), off, mask, wt, b), gout.float())
    torch.cuda.synchronize()
    _assert_close(got, want, 2e-2 if bf16 else 1e-4)
    _, table = dcn.dcn_forward(x, off, mask, wt, b, anchor=geom, with_table=True, **kw)
    first = dcn.dcn_backward(x, off, mask, wt, gout, anchor=geom, table=table, **kw)
    again = dcn.dcn_backward(x, off, mask, wt, gout, anchor=geom, table=table, **kw)
    clamp = dcn.dcn_backward(x, off, mask, wt, gout, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first[1:], again[1:]))
    assert not torch.equal(first[1], clamp[1])


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("s2d", [1, 4], ids=["full_grid", "s2d_grid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_anchored_kernel_d_warp_matches_plain_on_card(dtype, s2d):
    """Kernel D at k = 1 in anchored mode (the HR state warp) against
    autograd of the plain version at the training grid: f32 to 1e-4 and
    bf16 to 2e-2 of max|ref|, d-flow bit-equal over two runs and other than
    the clamped backward's."""
    from crfp_torch.ops.cuda import warp

    n, c, h, w, d = 2, 4, 75, 83, 32
    bf16 = dtype == torch.bfloat16
    x, off, gout = _card_operands(n, c, h, w, d, 6, dtype)
    flow = off.flip(1).contiguous()
    geom = an.warp_geometry(h, w, c, d, bf16=bf16, s2d=s2d, fullgrad=True)
    before = warp.bwd_anchor_launches
    got = _card_grads(lambda x_, f_: warp.flow_warp_windowed(x_, f_, d, anchor=geom),
                      (x, flow), gout)
    assert warp.bwd_anchor_launches == before + 1
    want = _card_grads(lambda x_, f_: flow_warp_windowed_ref(x_, f_, d, geom),
                       (x.float(), flow), gout.float())
    torch.cuda.synchronize()
    _assert_close(got, want, 2e-2 if bf16 else 1e-4)
    _, table = warp.flow_warp_forward_table(x, flow, d, geom)
    first = warp.flow_warp_backward(x, flow, gout, d, anchor=geom, table=table)[1]
    again = warp.flow_warp_backward(x, flow, gout, d, anchor=geom, table=table)[1]
    clamp = warp.flow_warp_backward(x, flow, gout, d)[1]
    torch.cuda.synchronize()
    assert torch.equal(first, again) and not torch.equal(first, clamp)
