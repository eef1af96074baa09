"""crfp_torch ops vs their crfp_tpu counterparts on the CPU, f32, on the
same numpy inputs: shuffle, resize, FNet, the windowed flow warp (plain
version of kernel B), the windowed DCN (plain version of kernel A) and
frame emission (plain version of kernel C)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("f", [2, 4])
def test_pixel_shuffle_unshuffle_match_jax(f):
    from crfp_tpu.ops import shuffle as js
    from crfp_torch.ops import shuffle as ts

    rng = np.random.default_rng(f)
    a = rng.standard_normal((2, 3, 5, 3 * f * f)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(ts.pixel_shuffle(_nchw(a), f)),
                               np.asarray(js.pixel_shuffle(jnp.asarray(a), f)),
                               atol=1e-5, rtol=0)
    b = rng.standard_normal((2, 3 * f, 5 * f, 3)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(ts.pixel_unshuffle(_nchw(b), f)),
                               np.asarray(js.pixel_unshuffle(jnp.asarray(b), f)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["up2", "up8", "down", "odd", "align_corners"])
def test_resize_matches_jax(case):
    from crfp_tpu.ops import resize as jr
    from crfp_torch.ops import resize as tr

    rng = np.random.default_rng(0)
    a = rng.standard_normal((1, 9, 14, 3)).astype(np.float32)
    if case == "up2":
        want, got = jr.upsample(jnp.asarray(a), 2), tr.upsample(_nchw(a), 2)
    elif case == "up8":
        want, got = jr.upsample(jnp.asarray(a), 8), tr.upsample(_nchw(a), 8)
    elif case == "down":
        want = jr.resize_bilinear(jnp.asarray(a), (4, 6))
        got = tr.resize_bilinear(_nchw(a), (4, 6))
    elif case == "odd":
        want = jr.resize_bilinear(jnp.asarray(a), (13, 17))
        got = tr.resize_bilinear(_nchw(a), (13, 17))
    else:
        want = jr.resize_bilinear(jnp.asarray(a), (20, 31), align_corners=True)
        got = tr.resize_bilinear(_nchw(a), (20, 31), align_corners=True)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def test_avg_pool_matches_jax():
    from crfp_tpu.ops.resize import avg_pool_2x as jpool
    from crfp_torch.ops.resize import avg_pool_2x as tpool

    a = np.random.default_rng(1).standard_normal((2, 9, 12, 4)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(tpool(_nchw(a))), np.asarray(jpool(jnp.asarray(a))),
                               atol=1e-5, rtol=0)


def test_fnet_matches_jax():
    import flax

    from crfp_tpu.nn.flow import FNet as JFNet
    from crfp_torch.nn.flow import FNet
    from crfp_torch.params import from_jax

    rng = np.random.default_rng(2)
    x1 = rng.uniform(0, 1, (1, 16, 24, 3)).astype(np.float32)
    x2 = rng.uniform(0, 1, (1, 16, 24, 3)).astype(np.float32)
    jm = JFNet()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2))
    want = np.asarray(jm.apply(params, jnp.asarray(x1), jnp.asarray(x2)))
    flat = {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}
    tm = FNet()
    tm.load_state_dict(from_jax(flat), strict=True)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x1), _nchw(x2)))
    assert got.shape == (1, 16, 24, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [2, 8, 32])
def test_flow_warp_windowed_ref_matches_jax(d):
    from crfp_tpu.ops.warp import flow_warp as jwarp
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 20, 28, 5)).astype(np.float32)
    flow = (rng.standard_normal((2, 20, 28, 2)) * 1.5 * d).astype(np.float32)
    assert (np.abs(flow) > d).mean() > 0.2  # the clamp is exercised
    want = np.asarray(jwarp(jnp.asarray(x), jnp.clip(jnp.asarray(flow), -d, d)))
    got = flow_warp_windowed_ref(_nchw(x), _nchw(flow), d)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


def _dcn_inputs(shared: bool, seed: int):
    rng = np.random.default_rng(seed)
    n, h, w, c, o, g, k2 = 1, 18, 20, 16, 8, 4, 9
    gg = 1 if shared else g
    taps = 1 if shared else k2
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = (rng.standard_normal((n, h, w, gg, taps, 2)) * 5).astype(np.float32)
    mask = rng.uniform(0, 1, (n, h, w, gg, taps)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, o)) * 0.1).astype(np.float32)
    b = rng.standard_normal((o,)).astype(np.float32)
    return x, off, mask, wt, b


def _dcn_to_torch(x, off, mask, wt, b):
    n, h, w = x.shape[:3]
    return (_nchw(x),
            _nchw(off.reshape(n, h, w, -1)),
            _nchw(mask.reshape(n, h, w, -1)),
            torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))),
            torch.from_numpy(b))


@pytest.mark.parametrize("mode", ["per_tap", "shared"])
def test_dcn_windowed_ref_matches_jax(mode):
    from crfp_tpu.ops.dcn_windowed import deform_conv2d_windowed
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    shared = mode == "shared"
    x, off, mask, wt, b = _dcn_inputs(shared, seed=11)
    d = 4
    assert (np.abs(off) > d).mean() > 0.2  # the clamp is exercised
    j_off, j_mask = off, mask
    if shared:  # the JAX op takes the broadcast form (crfp_tpu/nn/align.py:80-83)
        j_off = np.broadcast_to(off, off.shape[:4] + (9, 2))
        j_mask = np.broadcast_to(mask, mask.shape[:4] + (9,))
    want = np.asarray(deform_conv2d_windowed(
        jnp.asarray(x), jnp.asarray(j_off), jnp.asarray(j_mask), jnp.asarray(wt),
        jnp.asarray(b), max_displacement=d))
    got = deform_conv2d_windowed_ref(*_dcn_to_torch(x, off, mask, wt, b),
                                     max_displacement=d, shared_taps=shared,
                                     shared_mask=shared)
    np.testing.assert_allclose(_nhwc(got), want, atol=6e-6, rtol=0)


def test_dcn_ref_unclamped_matches_jax_exact_dcn():
    from crfp_tpu.ops.dcn import deform_conv2d
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    x, off, mask, wt, b = _dcn_inputs(False, seed=12)
    want = np.asarray(deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                                    jnp.asarray(mask), jnp.asarray(wt),
                                    jnp.asarray(b)))
    got = deform_conv2d_windowed_ref(*_dcn_to_torch(x, off, mask, wt, b),
                                     max_displacement=None)
    np.testing.assert_allclose(_nhwc(got), want, atol=6e-6, rtol=0)


def test_emit_frame_ref_r4_matches_jax_emit_kernel():
    from crfp_tpu.ops.pallas.emit import (
        depth_to_space_add_chw,
        emit_res_rows,
        upsample_planar,
    )
    from crfp_torch.ops.cuda.emit import emit_frame_ref

    rng = np.random.default_rng(3)
    n, hs, ws, c, r = 1, 8, 32, 3, 4  # 32x128 frame from a 4x16 LR frame
    y = rng.standard_normal((n, hs, ws, c * r * r)).astype(np.float32)
    lr = rng.uniform(0, 1, (n, hs * r // 8, ws * r // 8, c)).astype(np.float32)
    res = upsample_planar(jnp.asarray(lr), 8, pad_to=emit_res_rows(hs))
    want = np.asarray(depth_to_space_add_chw(jnp.asarray(y), res, r=r,
                                             interpret=True)).transpose(0, 2, 3, 1)
    got = emit_frame_ref(_nchw(y), _nchw(lr), r=r)
    assert got.shape == (n, hs * r, ws * r, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_emit_frame_ref_r1_matches_jax_base_add():
    from crfp_tpu.ops.resize import upsample
    from crfp_torch.ops.cuda.emit import emit_frame_ref

    rng = np.random.default_rng(4)
    y = rng.standard_normal((2, 40, 48, 3)).astype(np.float32)
    lr = rng.uniform(0, 1, (2, 5, 6, 3)).astype(np.float32)
    want = np.asarray(jnp.asarray(y) + upsample(jnp.asarray(lr), 8))
    got = emit_frame_ref(_nchw(y), _nchw(lr), r=1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
