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
