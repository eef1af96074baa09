"""Per-cell anchored windows (``ModelConfig.dcn_anchor``) in the port against
the JAX package, on the CPU.

- Kernel level: the port's plain anchored DCN (shared taps at r = 1 and in
  the s2d(4) operand form, per-tap) and warp (the full-resolution grid,
  band 64, and the s2d(4) one, band 32) against ``crfp_tpu``'s Pallas
  kernel with ``anchor=True`` in interpret mode, on motion that varies
  from cell to cell and reaches past ±D, over frames that no cell size
  divides (edge cells average over their zero padding). f32 within JAX's
  own ``atol 5e-5, rtol 1e-4`` (tests/test_pallas_dcn.py:256); bf16 x
  (row quantum 16) within 1e-2 of max|ref| (the outputs round to bf16).
  In every case the plain ±D clamp misses JAX by more than 20 times the
  tolerance, and so does another cell grid.
- The geometry: the resolved band, xtile and margins for the requests of
  crfp_tpu/nn/align.py:59 and crfp_tpu/ops/pallas/warp.py:48-52, :84-86,
  the VMEM guard's shrink (dcn_3 at mid 16 in bf16: band 16, xtile 64)
  held through the Pallas kernel's outputs, and kernel A's padded planes,
  sized from the anchored reach, holding every corner.
- Model level (JAX's dispatch routed to the anchored Pallas kernels inside
  the test, ``torch_parity.anchored_jax_dispatch``: off the TPU JAX drops
  ``anchor``): ``CRFPRuntimeV18`` with ``hr_s2d`` off and on, the batch
  trunk's ``StreamingRunner`` on the anchored checkpoint at a reduced size,
  and ``python -m crfp_torch.main --test`` with ``--dcn_anchor true``
  against JAX's ``evaluate_clips``; 3 frames, HR motion past ±dcn_window_hr,
  within 1e-4 (the evaluator: 1e-3 dB, SSIM 1e-5).
- Training (slice 15, tests/test_torch_anchor_train.py holds it against
  JAX): shared-tap anchored calls differentiate through the dispatchers,
  and ``main`` and ``train_procedural`` train with ``--dcn_anchor``.
- Per-tap anchored stages and the height-sharded runner take anchored
  calls: tests/test_torch_anchor_per_tap.py and
  tests/test_torch_spatial.py hold them against JAX.
- On a card (marker ``cuda``): kernels A and B in anchored mode against
  their plain versions, bit-equal over two runs, different from the clamp.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crfp_torch.ops import anchor as an  # noqa: E402
from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref  # noqa: E402
from crfp_torch.ops.warp import flow_warp_windowed_ref  # noqa: E402

torch.set_num_threads(1)

F32_TOL = dict(atol=5e-5, rtol=1e-4)
BF16_REL = 1e-2
# "far more than the tolerance": what a port that ignores the anchor, or
# takes another cell grid, misses JAX by at the least
MISS = 20


def _field(rng, n, h, w, g, k, d, amp=(1.6, 1.5)):
    """(n, h, w, g, k, 2) offsets (dy, dx): a smooth field of amplitude
    ``amp`` x D that changes from cell to cell, plus +-3 px per tap."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([amp[0] * d * np.sin(yy / 9.0 + xx / 13.0),
                     -amp[1] * d * np.cos(xx / 11.0 - yy / 17.0)], -1)
    return (base[None, :, :, None, None] + rng.uniform(-3, 3, (n, h, w, g, k, 2))
            ).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def _packed(a):
    """(n, h, w, ...) numpy -> the port's packed (n, prod(...), h, w)."""
    n, h, w = a.shape[:3]
    return _nchw(a.reshape(n, h, w, -1))


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())


def _close(got, want, bf16):
    if bf16:
        return _err(got, want) <= BF16_REL * float(np.abs(want).max())
    return np.allclose(got, want, **F32_TOL)


def _tol(want, bf16):
    return BF16_REL * float(np.abs(want).max()) if bf16 else F32_TOL["atol"]


# (id, shared, s2d r, bf16, (h, w), c, g)
DCN_CASES = [
    ("shared_f32", True, 1, False, (24, 40), 4, 1),
    ("shared_s2d4_f32", True, 4, False, (40, 56), 4, 1),
    ("per_tap_f32", False, 1, False, (24, 40), 8, 2),
    ("shared_bf16", True, 1, True, (40, 56), 4, 1),
]


@pytest.mark.parametrize("case", DCN_CASES, ids=[c[0] for c in DCN_CASES])
def test_plain_anchored_dcn_matches_pallas(case):
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.dcn import deform_conv2d_pallas
    from crfp_tpu.ops.shuffle import pixel_shuffle, pixel_unshuffle

    _, shared, r, bf16, (h, w), c, g = case
    d, n, k = 16, 1, 1 if case[1] else 9
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = _field(rng, n, h, w, g, k, d)
    mk = rng.uniform(0, 1, (n, h, w, g, k)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, c)) * 0.2).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jx = jnp.asarray(x, jdt)
    kw = dict(max_displacement=d, band=32 if bf16 else 8, shared_taps=shared,
              shared_mask=shared, anchor=True, interpret=True)
    if r == 1:
        want = deform_conv2d_pallas(jx, jnp.asarray(off), jnp.asarray(mk), jnp.asarray(wt),
                                    None, **kw)
    else:
        hs, ws = h // r, w // r
        off_s = pixel_unshuffle(jnp.asarray(off).reshape(n, h, w, -1), r).reshape(
            n, hs, ws, g, k, 2, r * r)
        mk_s = pixel_unshuffle(jnp.asarray(mk).reshape(n, h, w, -1), r).reshape(
            n, hs, ws, g, k, r * r)
        want = pixel_shuffle(deform_conv2d_pallas(pixel_unshuffle(jx, r), off_s, mk_s,
                                                  jnp.asarray(wt), None, s2d=r, **kw), r)
    want = np.asarray(want.astype(jnp.float32))

    tx = _nchw(np.asarray(jx.astype(jnp.float32)))
    tx = tx.bfloat16() if bf16 else tx
    args = (tx, _packed(off), _packed(mk), torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous())
    geom = an.dcn_geometry(h, w, c, c, g, 3, d, bf16=bf16, shared_taps=shared,
                           shared_mask=shared, s2d=r)

    def port(**a):
        out = deform_conv2d_windowed_ref(*args, None, shared_taps=shared, shared_mask=shared,
                                         **a)
        return out.float().permute(0, 2, 3, 1).numpy()

    got = port(anchor=geom)
    assert _close(got, want, bf16), _err(got, want)
    # a port that ignores the anchor, or takes another cell grid, fails
    assert _err(port(max_displacement=d), want) > MISS * _tol(want, bf16)
    other = an.AnchorGeometry(**{**geom.__dict__, "band": 2 * geom.band})
    assert _err(port(anchor=other), want) > MISS * _tol(want, bf16)


# (id, s2d r, bf16)
WARP_CASES = [("full_f32", 1, False), ("s2d4_f32", 4, False), ("full_bf16", 1, True),
              ("s2d4_bf16", 4, True)]


@pytest.mark.parametrize("case", WARP_CASES, ids=[c[0] for c in WARP_CASES])
def test_plain_anchored_warp_matches_pallas(case):
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.warp import (flow_warp_windowed_pallas,
                                          flow_warp_windowed_pallas_s2d)
    from crfp_tpu.ops.shuffle import pixel_shuffle, pixel_unshuffle

    _, r, bf16 = case
    d, n, h, w, c = 16, 1, 72, 56, 4
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = _field(rng, n, h, w, 1, 1, d)[:, :, :, 0, 0]
    flow = np.stack([off[..., 1], off[..., 0]], -1)  # (dx, dy)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    if r == 1:
        want = flow_warp_windowed_pallas(jx, jnp.asarray(flow), max_displacement=d,
                                         anchor=True, interpret=True)
    else:
        want = pixel_shuffle(flow_warp_windowed_pallas_s2d(
            pixel_unshuffle(jx, r), pixel_unshuffle(jnp.asarray(flow), r), r=r,
            max_displacement=d, anchor=True, interpret=True), r)
    want = np.asarray(want.astype(jnp.float32))
    tx = _nchw(np.asarray(jx.astype(jnp.float32)))
    tx = tx.bfloat16() if bf16 else tx
    tf = _nchw(flow)

    def port(geom, clamp=d):
        return flow_warp_windowed_ref(tx, tf, clamp, geom).float().permute(0, 2, 3, 1).numpy()

    geom = an.warp_geometry(h, w, c, d, bf16=bf16, s2d=r)
    assert geom.band == (64 if r == 1 else 32)
    got = port(geom)
    assert _close(got, want, bf16), _err(got, want)
    assert _err(port(None), want) > MISS * _tol(want, bf16)
    # the other grid (hr_s2d flips it) samples elsewhere on this field
    other = an.warp_geometry(h, w, c, d, bf16=bf16, s2d=4 if r == 1 else 1)
    assert _err(port(other), want) > MISS * _tol(want, bf16)


def test_geometry_of_the_deployment_requests():
    """The worked example of the deployment shapes (dcn_3 and the HR warp,
    (1, 4, 720, 720), D = 32): rows A = 32 and dl 21 (the warp 22), columns
    lane_q 32, A = 32, dl 29 (30); f32 quanta 8; the reach sizes kernel A's
    padding."""
    g = an.dcn_geometry(720, 720, 4, 4, 1, 3, 32, bf16=True, shared_taps=True,
                        shared_mask=True)
    assert (g.band, g.xtile, g.sub_tile, g.lane_q, g.a_y, g.a_x, g.dl_r, g.dl_c) == (
        32, 32, 16, 32, 32, 32, 21.0, 29.0)
    assert g.a_y + g.dl_r == 53 and g.a_x + g.dl_c == 61 == g.reach
    # dcn_3's grid is the same in both operand forms at every width, so
    # DCNAlign takes no s2d factor; only the HR warp's grid reads hr_s2d
    for c in range(1, 65):
        for bf16 in (True, False):
            kw = dict(bf16=bf16, shared_taps=True, shared_mask=True)
            assert an.dcn_geometry(720, 720, c, c, 1, 3, 32, s2d=4, **kw) == \
                an.dcn_geometry(720, 720, c, c, 1, 3, 32, **kw), (c, bf16)
    f = an.dcn_geometry(720, 720, 4, 4, 1, 3, 32, bf16=False, shared_taps=True,
                        shared_mask=True)
    assert (f.band, f.xtile, f.sub_tile, f.dl_r, f.dl_c) == (8, 32, 8, 13.0, 29.0)
    wf = an.warp_geometry(720, 720, 4, 32, bf16=True)
    ws = an.warp_geometry(720, 720, 4, 32, bf16=True, s2d=4)
    assert (wf.band, wf.xtile, wf.dl_r, wf.dl_c) == (64, 32, 22.0, 30.0)
    assert (ws.band, ws.xtile, ws.dl_r, ws.dl_c) == (32, 32, 22.0, 30.0)
    x = torch.zeros(1, 4, 720, 720, dtype=torch.bfloat16)
    assert an.hr_warp_geometry(x, 32, True) == wf
    assert an.hr_warp_geometry(x, 32, True, 4) == ws
    assert an.hr_warp_geometry(x, None, True) is None and an.hr_warp_geometry(x, 32, False) is None


def test_vmem_guard_shrink_through_outputs():
    """dcn_3 at mid 16 (2 channels) in bf16: the VMEM guard shrinks the
    requested band 32 to 16, and xtile lands at 64 (lane_q 64). The Pallas
    kernel's anchored output agrees with the port at the shrunk grid and
    not at the requested one."""
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.dcn import deform_conv2d_pallas

    d, n, h, w, c = 32, 1, 40, 72, 2
    g = an.dcn_geometry(720, 720, c, c, 1, 3, d, bf16=True, shared_taps=True, shared_mask=True)
    assert (g.band, g.xtile, g.lane_q, g.a_x, g.dl_c) == (16, 64, 64, 64, 61.0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    # row motion that changes every 16 rows, so 16- and 32-row cells differ
    off = np.zeros((n, h, w, 1, 1, 2), np.float32)
    off[..., 0] = np.where((np.arange(h) // 16) % 2 == 0, 40.0, -8.0)[None, :, None, None, None]
    off[..., 1] = 70.0
    off += rng.uniform(-2, 2, off.shape).astype(np.float32)
    mk = rng.uniform(0, 1, (n, h, w, 1, 1)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, c)) * 0.2).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(deform_conv2d_pallas(
        jx, jnp.asarray(off), jnp.asarray(mk), jnp.asarray(wt), None, max_displacement=d,
        band=32, shared_taps=True, shared_mask=True, anchor=True, interpret=True
    ).astype(jnp.float32))
    args = (_nchw(np.asarray(jx.astype(jnp.float32))).bfloat16(), _packed(off), _packed(mk),
            torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous())
    geom = an.dcn_geometry(h, w, c, c, 1, 3, d, bf16=True, shared_taps=True, shared_mask=True)
    assert geom == g  # the guard reads widths, not the frame

    def port(geom):
        return deform_conv2d_windowed_ref(*args, None, shared_taps=True, shared_mask=True,
                                          anchor=geom).float().permute(0, 2, 3, 1).numpy()

    assert _close(port(geom), want, True), _err(port(geom), want)
    asked = an.AnchorGeometry(**{**geom.__dict__, "band": 32})
    assert _err(port(asked), want) > MISS * _tol(want, True)


def test_anchor_table_and_effective_offsets():
    """The table's half-to-even rounding and ±A clip, edge cells averaged
    over their zero padding, and eff = F + clip(off - F, ±dl)."""
    g = an.AnchorGeometry(band=8, xtile=32, sub_tile=8, lane_q=32, a_y=32, a_x=32,
                          dl_r=13.0, dl_c=29.0)
    h, w = 12, 40  # the second band and tile are edge cells
    off = torch.zeros(1, 2, h, w)
    off[:, 0, :8] = 12.0        # 12 / 8 = 1.5 -> 2 (half to even)
    off[:, 0, 8:] = 20.0        # edge band: 4 rows of 8 -> mean 10 -> 1.25 -> 1
    off[:, 1, :, :32] = 500.0   # clipped to A + dl = 61 first, anchor clipped to 32
    off[:, 1, :, 32:] = -80.0   # edge tile: -61 * 8 / 32 = -15.25 -> -0.48 -> 0
    t = an.anchor_table(off, g, 1)
    assert t.shape == (1, 1, 2, 2, 2)
    assert t[0, 0, :, :, 0].tolist() == [[16.0, 0.0], [8.0, 0.0]]  # edge tiles: 12 * 8 / 32
    assert t[0, 0, :, :, 1].tolist() == [[32.0, 0.0], [32.0, 0.0]]
    eff = an.effective_offsets(off, g, 1)
    assert float(eff[0, 0, 0, 0]) == 12.0 and float(eff[0, 0, 9, 0]) == 20.0
    assert float(eff[0, 1, 0, 0]) == 32.0 + 29.0 and float(eff[0, 1, 0, 39]) == -29.0


def test_padded_planes_hold_every_anchored_corner():
    """Kernel A reads an anchored call's corners unchecked from planes
    padded by ceil(reach) + 1: every corner of an extreme offset field
    (effective offsets at ±reach) lies inside, for dcn_3's geometries."""
    from crfp_torch.ops.cuda.dcn import tile_plan

    for bf16, c in ((True, 4), (False, 4), (True, 2)):
        n, h, w = 1, 75, 83
        geom = an.dcn_geometry(h, w, c, c, 1, 3, 32, bf16=bf16, shared_taps=True,
                               shared_mask=True)
        plan = tile_plan(n, c, h, w, c, 1, geom.reach, bf16=bf16, shared_mask=True)
        assert plan.pad == int(np.ceil(geom.reach)) + 1
        hp, wp = h + 2 * plan.pad + 1, w + 2 * plan.pad + 1
        for sign in (1.0, -1.0):
            off = torch.full((n, 2, h, w), sign * 1e4)
            eff = an.effective_offsets(off, geom, 1)
            assert float(eff.abs().max()) <= geom.reach
            gy = torch.arange(h, dtype=torch.float32).view(1, h, 1)
            gx = torch.arange(w, dtype=torch.float32).view(1, 1, w)
            for k in (-1, 0, 1):  # the taps' shifts
                sy = (gy + k) + eff[:, 0]
                sx = (gx + k) + eff[:, 1]
                y0 = torch.floor(sy).long() + plan.pad
                x0 = torch.floor(sx).long() + plan.pad
                assert int(y0.min()) >= 0 and int(y0.max()) + 1 < hp, (bf16, c, sign)
                assert int(x0.min()) >= 0 and int(x0.max()) + 1 < wp, (bf16, c, sign)


# ---- model level -----------------------------------------------------------

_WINDOWS = dict(mid_channels=16, dcn_window=8, dcn_window_hr=32)


@pytest.fixture(scope="module")
def runtime_weights():
    import torch_parity as tp

    lrs, fvs = tp.clip(t=3, seed=5)
    w = tp.perturb_heads(tp.jax_init(tp.jax_model(**_WINDOWS), lrs, fvs), seed=2)
    # the flow net moves the HR state by about (37, -42) px, past 32
    return lrs, fvs, tp.set_flow_bias(w, dy=4.6, dx=-5.3)


@pytest.mark.parametrize("hr_s2d", [False, True], ids=["full_grid", "s2d_grid"])
def test_runtime_v18_anchored_matches_jax(runtime_weights, monkeypatch, hr_s2d):
    import torch_parity as tp

    tp.anchored_jax_dispatch(monkeypatch)
    lrs, fvs, weights = runtime_weights
    want = tp.jax_frames(tp.jax_model(**_WINDOWS, hr_s2d=hr_s2d, dcn_anchor=True),
                         weights, lrs, fvs)
    got = tp.torch_frames(tp.torch_model(weights, **_WINDOWS, hr_s2d=hr_s2d, dcn_anchor=True),
                          lrs, fvs)
    clamp = tp.torch_frames(tp.torch_model(weights, **_WINDOWS), lrs, fvs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, 128, 192, 3)
        assert _err(g, w) <= 1e-4, (i, _err(g, w))
    assert min(_err(c, w) for c, w in zip(clamp[1:], want[1:])) > 1e-3


def _moving_clip(t=3, h=16, w=24, v=(4.5, -5.5), seed=0):
    """(lr, fv = hr, mk) NHWC numpy, (t, 1, ...): a texture panning v LR
    px a frame, so the trained flow net's HR flow passes ±32."""
    from crfp_torch.bench.quality_window import panning_clip

    lr, hrs = panning_clip(t, (h, w), v, seed)
    mk = np.zeros((t, h * 8, w * 8, 1), np.float32)
    mk[:, 40:80, 60:120] = 1.0
    return lr[:, None], (hrs * mk)[:, None], mk[:, None]


def test_streaming_runner_anchored_checkpoint_matches_jax(monkeypatch):
    """The batch trunk's StreamingRunner on checkpoints/v18_mid32_struct_anchored.npz
    (loaded strictly), LR 16x24, windows 8/32, anchored on the s2d grid, in
    f32: frame by frame against JAX's StreamingRunner."""
    import jax.numpy as jnp
    import torch_parity as tp
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from crfp_tpu.models.crfp import ModelConfig as JConfig
    from crfp_tpu.models.streaming import StreamingRunner as JRunner
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.models.streaming import StreamingRunner
    from crfp_torch.params import from_jax, load_npz

    tp.anchored_jax_dispatch(monkeypatch)
    flat = load_npz("checkpoints/v18_mid32_struct_anchored.npz")
    cfg = dict(mid_channels=32, dcn_window=8, dcn_window_hr=32, hr_s2d=True, dcn_anchor=True)
    lr, fv, mk = _moving_clip()
    jr = JRunner(JCRFP(JConfig(variant="v18", **cfg)), tp.unflatten(flat), donate=False)
    want = [np.asarray(jr(jnp.asarray(lr[i]), jnp.asarray(fv[i]), jnp.asarray(mk[i])))
            for i in range(len(lr))]
    model = CRFP(ModelConfig(**cfg), device="cpu")
    model.load_state_dict(from_jax(flat), strict=True)
    runner = StreamingRunner(model)
    got = [runner(lr[i], fv[i], mk[i]).numpy() for i in range(len(lr))]
    clamp_model = CRFP(ModelConfig(mid_channels=32, dcn_window=8, dcn_window_hr=32),
                       device="cpu")
    clamp_model.load_state_dict(from_jax(flat), strict=True)
    clamp = StreamingRunner(clamp_model)
    plain = [clamp(lr[i], fv[i], mk[i]).numpy() for i in range(len(lr))]
    with torch.no_grad():
        hr_flow = model.compute_flow(torch.from_numpy(lr[1]).permute(0, 3, 1, 2),
                                     torch.from_numpy(lr[0]).permute(0, 3, 1, 2)) * 8.0
    assert float(hr_flow.abs().max()) > 32.0  # the HR motion passes the window
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, 128, 192, 3)
        assert _err(g, w) <= 1e-4, (i, _err(g, w))
    assert max(_err(p, w) for p, w in zip(plain[1:], want[1:])) > 1e-3


def test_main_test_mode_anchored_matches_jax_evaluator(tmp_path, monkeypatch):
    """``python -m crfp_torch.main --test true --dcn_anchor true --hr_s2d
    true`` (windows 8 and 8) on a tiny REDS tree, the port's seeded weights
    with the flow pushed past the HR window, against JAX's
    ``evaluate_clips`` with the same flags (``dcn_anchor_vjp`` off, as
    JAX's test mode sets it)."""
    import torch_parity as tp
    import crfp_torch.main as tmain
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, save_npz, to_jax
    from crfp_tpu.config import model_config, parse_args
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from tests.test_data import _make_fake_reds
    from tests.test_torch_main import _argv
    from tests.test_torch_main_eval import _jax_eval

    tp.anchored_jax_dispatch(monkeypatch)
    tmp = str(tmp_path)
    _make_fake_reds(tmp, n_frames=4, gt_hw=(64, 96))
    sd = CRFP(ModelConfig(mid_channels=16), device="cpu", seed=1).state_dict()
    ckpt = os.path.join(tmp, "anchored.npz")
    save_npz(from_jax(tp.set_flow_bias(tp.perturb_heads(to_jax(sd), seed=3), 3.0, -3.5)),
             ckpt)
    flags = ["--test", "true", "--model_path", ckpt, "--dcn_window", "8",
             "--dcn_window_hr", "8", "--dcn_anchor", "true", "--hr_s2d", "true"]
    built = []
    model_fn = tmain._model
    monkeypatch.setattr(tmain, "_model", lambda a, d: built.append(model_fn(a, d)) or built[-1])
    res = tmain.main(_argv(tmp, "exp_anchor", flags))
    assert built[-1].cfg.dcn_anchor and built[-1].cfg.hr_s2d
    log = open(os.path.join(tmp, "exp_anchor", "MRCF.log")).read()
    assert "--hr_s2d: the anchored HR ops take the cell grid" in log
    jcfg = model_config(parse_args(_argv(tmp, extra=flags)))
    assert jcfg.dcn_anchor and not jcfg.dcn_anchor_vjp
    want = _jax_eval(JCRFP(jcfg), ckpt, "test", tmp)
    assert res.n_frames == want.n_frames
    for k, tol in (("psnr", 1e-3), ("ssim", 1e-5), ("psnr_y", 1e-3), ("ssim_y", 1e-5)):
        assert abs(getattr(res, k) - getattr(want, k)) <= tol, (k, getattr(res, k))
    plain = tmain.main(_argv(tmp, "exp_plain", flags[:-4]))
    assert abs(plain.psnr - want.psnr) > 1e-3  # the anchored run is the one that matches


# ---- training (slice 15) and refusals ------------------------------------------


def test_anchored_calls_under_autograd_raise():
    """The refusal this test once held is gone (slice 15): shared-tap
    anchored calls under autograd differentiate through the dispatchers, on
    the CPU through the plain version, with its gradients bit for bit, at
    the training grid and at the inference one; inference still runs."""
    from crfp_torch.ops.cuda.dcn import deform_conv2d_windowed
    from crfp_torch.ops.cuda.warp import flow_warp_windowed

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 16, 24, generator=gen)
    off = torch.randn(1, 2, 16, 24, generator=gen) * 12.0
    mask = torch.rand(1, 1, 16, 24, generator=gen)
    wt = torch.randn(4, 4, 3, 3, generator=gen)
    gout = torch.randn(1, 4, 16, 24, generator=gen)
    kw = dict(shared_taps=True, shared_mask=True, max_displacement=8)

    def grads(fn, *inputs):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, gout)

    for fullgrad in (True, False):
        geom = an.dcn_geometry(16, 24, 4, 4, 1, 3, 8, bf16=False, shared_taps=True,
                               shared_mask=True, fullgrad=fullgrad)
        got = grads(lambda *a: deform_conv2d_windowed(*a, anchor=geom, **kw), x, off, mask, wt)
        want = grads(lambda *a: deform_conv2d_windowed_ref(*a, anchor=geom, **kw),
                     x, off, mask, wt)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert float(got[1].abs().max()) > 0
        wgeom = an.warp_geometry(16, 24, 4, 8, bf16=False, fullgrad=fullgrad)
        flow = off.flip(1).contiguous()
        got = grads(lambda a, f: flow_warp_windowed(a, f, 8, anchor=wgeom), x, flow)
        want = grads(lambda a, f: flow_warp_windowed_ref(a, f, 8, wgeom), x, flow)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():  # inference runs
        assert deform_conv2d_windowed(x, off, mask, wt, anchor=geom, **kw).shape == x.shape
        assert flow_warp_windowed(x, flow, 8, anchor=wgeom).shape == x.shape


def test_training_with_the_flag_raises(tmp_path, monkeypatch):
    """The refusal this test once held is gone (slice 15): ``python -m
    crfp_torch.main`` and ``train_procedural --cpu --dcn_anchor`` train
    with anchored HR windows on the training grid, which the log names;
    their losses are finite and fall."""
    import crfp_torch.train.loop as loop
    from crfp_torch.config import model_config, parse_args
    from crfp_torch.main import main
    from crfp_torch.tools.train_procedural import main as train_main
    from tests.test_data import _make_fake_reds
    from tests.test_torch_main import _argv

    tmp = str(tmp_path)
    _make_fake_reds(tmp, n_frames=4, gt_hw=(64, 96))
    flags = ["--dcn_anchor", "true", "--dcn_window", "8", "--dcn_window_hr", "32",
             "--lr_rate", "1e-3", "--num_epochs", "2"]
    cfg = model_config(parse_args(_argv(tmp, extra=flags)))
    assert cfg.dcn_anchor and cfg.dcn_anchor_vjp
    out = main(_argv(tmp, extra=flags))
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 8 and all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    log = open(os.path.join(tmp, "exp", "MRCF.log")).read()
    assert "--dcn_anchor: anchored HR windows on the training grid (dcn_anchor_vjp)" in log
    assert "HR warp band 16 x xtile 64" in log  # the mid-16 HR state's training grid

    seen = []
    make = loop.make_train_step

    def recording(model, tcfg, group=None):
        assert model.cfg.dcn_anchor and model.cfg.dcn_anchor_vjp
        step = make(model, tcfg, group)

        def run(opt, batch, it):
            m = step(opt, batch, it)
            seen.append(float(m["loss"]))
            return m
        return run

    monkeypatch.setattr(loop, "make_train_step", recording)
    monkeypatch.chdir(tmp_path)  # the clip-pool cache goes under runs/ here
    train_main(["--cpu", "--dcn_anchor", "--iters", "6", "--b", "1", "--t", "3", "--gt", "64",
                "--mid", "16", "--pool", "2", "--flow_freeze", "0", "--lr", "1e-3",
                "--save", str(tmp_path / "anchored.npz")])
    assert len(seen) == 6 and all(np.isfinite(seen)) and seen[-1] < seen[0], seen
    assert (tmp_path / "anchored.npz").exists()


# ---- on a card ----------------------------------------------------------------
#   python -m pytest tests/test_torch_anchor.py --noconftest -m cuda -q

_NEEDS_CARD = pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs an NVIDIA GPU and nvcc")


def _card_field(n, h, w, d, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(_field(rng, n, h, w, 1, 1, d, amp=(1.7, 1.8))[:, :, :, 0, 0]
                            ).permute(0, 3, 1, 2).contiguous()


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_anchored_kernel_a_matches_plain_on_card(dtype):
    from crfp_torch.ops.cuda import dcn

    n, c, h, w, d = 2, 4, 75, 83, 32
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, c, h, w, generator=gen).to(dtype).cuda()
    off = _card_field(n, h, w, d, 1).cuda()
    mask = torch.rand(n, 1, h, w, generator=gen).cuda()
    wt = (torch.randn(c, c, 3, 3, generator=gen) * 0.2).cuda()
    b = torch.randn(c, generator=gen).cuda()
    geom = an.dcn_geometry(h, w, c, c, 1, 3, d, bf16=dtype == torch.bfloat16,
                           shared_taps=True, shared_mask=True)
    kw = dict(shared_taps=True, shared_mask=True, max_displacement=d)
    want = deform_conv2d_windowed_ref(x, off, mask, wt, b, anchor=geom, **kw).float()
    got = dcn.dcn_forward(x, off, mask, wt, b, anchor=geom, **kw)
    again = dcn.dcn_forward(x, off, mask, wt, b, anchor=geom, **kw)
    clamp = dcn.dcn_forward(x, off, mask, wt, b, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= tol
    assert torch.equal(got, again)
    assert float((clamp.float() - want).abs().max()) > MISS * tol


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("s2d", [1, 4], ids=["full_grid", "s2d_grid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_anchored_kernel_b_matches_plain_on_card(dtype, s2d):
    from crfp_torch.ops.cuda import warp

    n, c, h, w, d = 2, 4, 75, 83, 32
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(n, c, h, w, generator=gen).to(dtype).cuda()
    flow = _card_field(n, h, w, d, 2).flip(1).contiguous().cuda()
    geom = an.warp_geometry(h, w, c, d, bf16=dtype == torch.bfloat16, s2d=s2d)
    want = flow_warp_windowed_ref(x, flow, d, geom).float()
    with torch.no_grad():
        got = warp.flow_warp_windowed(x, flow, d, anchor=geom)
        again = warp.flow_warp_windowed(x, flow, d, anchor=geom)
        clamp = warp.flow_warp_windowed(x, flow, d)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2 * float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= tol
    assert torch.equal(got, again)
    assert float((clamp.float() - want).abs().max()) > MISS * tol
