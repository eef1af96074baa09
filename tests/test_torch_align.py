"""crfp_torch DCNAlign vs crfp_tpu DCNAlign on the CPU, f32: per-tap mode
(G=4, offset feature fused through conv_fuse) and repeat mode (G=1, the
previous stage's offset feature through PixelShufflePack x4), each with
the window (the dispatcher: plain version on CPU tensors) and without
(the exact DCN). The heads and the DCN weight are random, non-zero."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("windowed", [True, False], ids=["windowed", "exact"])
@pytest.mark.parametrize("mode", ["per_tap", "repeat"])
def test_dcn_align_matches_jax(mode, windowed):
    from crfp_tpu.nn.align import DCNAlign as JAlign
    from crfp_torch.nn.align import DCNAlign
    from crfp_torch.params import from_jax

    rng = np.random.default_rng(7)
    n = 1
    if mode == "per_tap":
        m, g, h, w, d = 16, 4, 12, 14, 8
        kw = dict(pre_offset=True)
        pre_feat = rng.standard_normal((n, h, w, m)).astype(np.float32)
        pre_ch = None
    else:
        m, g, h, w, d = 2, 1, 16, 20, 32
        kw = dict(repeat=True, pre_offset=True, interpolate="pixelshuffle")
        pre_ch = 8
        pre_feat = rng.standard_normal((n, h // 4, w // 4, pre_ch)).astype(np.float32)
    window = d if windowed else None
    cur = rng.standard_normal((n, h, w, m)).astype(np.float32)
    # a smooth field to sample: the offsets are 10*tanh of conv features, so
    # f32 rounding in the features moves samples by ~1e-6 px, which white
    # noise would turn into ~1e-5 differences
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fr = rng.uniform(-0.3, 0.3, (2, m)).astype(np.float32)
    ph = rng.uniform(0, 6.3, (m,)).astype(np.float32)
    pre = np.sin(yy[..., None] * fr[0] + xx[..., None] * fr[1] + ph)[None]
    pre = pre.astype(np.float32)
    pre_al = rng.standard_normal((n, h, w, m)).astype(np.float32)
    flow = (rng.standard_normal((n, h, w, 2)) * 2).astype(np.float32)
    args = [jnp.asarray(a) for a in (cur, pre, pre_al, flow, pre_feat)]

    jm = JAlign(m, g, 3, 10.0, window=window, **kw)
    flat = tp.perturb_heads(tp.flat_params(jm.init(jax.random.PRNGKey(0), *args)),
                            seed=3, offset_std=0.3)
    want_al, want_feat = jm.apply(tp.unflatten(flat), *args)

    tm = DCNAlign(m, g, 3, 10.0, window=window, pre_offset_channels=pre_ch, **kw)
    tm.load_state_dict(from_jax(flat), strict=True)
    with torch.no_grad():
        got_al, got_feat = tm(*(_nchw(a) for a in (cur, pre, pre_al, flow, pre_feat)))
    np.testing.assert_allclose(got_feat.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_feat), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_al.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_al), atol=1e-5, rtol=0)
    assert float(np.abs(np.asarray(want_al) - pre).max()) > 0.1  # not the identity


def _per_tap_stage(fused_prep, window=8, seed=11):
    """A per-tap DCNAlign with random non-zero heads and DCN weight, and its
    NCHW inputs: a smooth field to sample and an anisotropic flow."""
    from crfp_torch.nn.align import DCNAlign

    rng = np.random.default_rng(seed)
    m, g, h, w = 16, 4, 12, 14
    tm = DCNAlign(m, g, 3, 10.0, window=window, pre_offset=True, fused_prep=fused_prep)
    sd = {k: torch.from_numpy(rng.normal(0, 0.3 if "dcn_offset" in k else 0.2,
                                         tuple(v.shape)).astype(np.float32))
          for k, v in tm.state_dict().items()}
    tm.load_state_dict(sd, strict=True)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fr = rng.uniform(-0.3, 0.3, (2, m, 1, 1)).astype(np.float32)
    ph = rng.uniform(0, 6.3, (m, 1, 1)).astype(np.float32)
    pre = np.sin(yy[None] * fr[0] + xx[None] * fr[1] + ph)[None].astype(np.float32)
    cur = rng.standard_normal((1, m, h, w)).astype(np.float32)
    pre_al = rng.standard_normal((1, m, h, w)).astype(np.float32)
    flow = np.stack([rng.normal(3.0, 1.0, (1, h, w)),     # dx
                     rng.normal(-1.5, 4.0, (1, h, w))],   # dy
                    axis=1).astype(np.float32)
    pre_feat = rng.standard_normal((1, m, h, w)).astype(np.float32)
    return tm, [torch.from_numpy(a) for a in (cur, pre, pre_al, flow, pre_feat)]


def test_fused_prep_equals_structured_path():
    """DCNAlign(fused_prep=True) hands the raw heads to kernel E's
    dispatcher (its plain version on the CPU); the result equals the
    structured path's to f32 rounding (1e-5)."""
    from crfp_torch.nn import align

    fused, args = _per_tap_stage(True)
    plain, _ = _per_tap_stage(False)
    calls = []
    orig = align.deform_conv2d_fusedprep
    align.deform_conv2d_fusedprep = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        with torch.no_grad():
            got_al, got_feat = fused(*args)
            want_al, want_feat = plain(*args)
    finally:
        align.deform_conv2d_fusedprep = orig
    assert calls == [1]
    assert torch.equal(got_feat, want_feat)
    assert float((got_al - want_al).abs().max()) <= 1e-5
    assert float((want_al - args[1]).abs().max()) > 0.1  # not the identity
    assert fused.state_dict().keys() == plain.state_dict().keys()


@pytest.mark.parametrize("case", ["grad", "no_window", "repeat"])
def test_fused_prep_keeps_structured_path_where_required(case, monkeypatch):
    """Under autograd, without a window and in repeat mode the flag is
    ignored (crfp_tpu/nn/align.py:141-147): kernel E's dispatcher is never
    called, and gradients reach the heads."""
    from crfp_torch.nn import align

    def refuse(*a, **k):
        raise AssertionError("fused-prep dispatcher called")

    monkeypatch.setattr(align, "deform_conv2d_fusedprep", refuse)
    if case == "repeat":
        tm = align.DCNAlign(2, 1, 3, 10.0, repeat=True, window=32, fused_prep=True)
        gen = torch.Generator().manual_seed(0)
        args = [torch.randn(1, 2, 8, 9, generator=gen) for _ in range(3)]
        args.append(torch.randn(1, 2, 8, 9, generator=gen))
        with torch.no_grad():
            out, _ = tm(*args)
        assert out.shape == (1, 2, 8, 9)
        return
    tm, args = _per_tap_stage(True, window=None if case == "no_window" else 8)
    if case == "no_window":
        with torch.no_grad():
            out, _ = tm(*args)
        assert torch.isfinite(out).all()
        return
    out, _ = tm(*args)
    out.square().sum().backward()
    assert float(tm.dcn_offset.conv.weight.grad.abs().max()) > 0
    assert float(tm.dcn_mask.conv.weight.grad.abs().max()) > 0
