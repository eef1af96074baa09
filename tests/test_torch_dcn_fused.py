"""Kernel E's plain version (crfp_torch.ops.dcn_windowed.deform_conv2d_fusedprep_ref)
against the JAX package on the CPU, f32: the fused-prep Pallas kernel in
interpret mode at the shapes of tests/test_pallas_dcn.py (atol 5e-5, rtol
1e-4: f32 reassociation of the per-column sums), with the clipped offsets
computed on the JAX side from the same raw heads and flow by
crfp_tpu/nn/align.py:293-296's formula; the gather oracle
crfp_tpu.ops.dcn.deform_conv2d on those offsets (same tolerance); bf16 x;
and the dispatcher's rules (plain version on CPU tensors, no gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N, H, W, C, G, O, K2, D, MAG = 1, 19, 27, 16, 4, 24, 9, 6, 10.0


def _inputs(seed=7):
    """Raw heads large enough that tanh saturates some taps and the clip
    cuts others; an anisotropic flow (dx and dy differ in mean and size),
    so a (dx, dy) swap shows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    raw = rng.normal(0, 0.6, (N, H, W, G * K2 * 2)).astype(np.float32)
    rawm = rng.normal(0, 1.5, (N, H, W, G * K2)).astype(np.float32)
    flow = np.stack([rng.normal(2.5, 1.0, (N, H, W)),      # dx
                     rng.normal(-1.0, 3.0, (N, H, W))],    # dy
                    axis=-1).astype(np.float32)
    wt = (rng.standard_normal((3, 3, C, O)) * 0.2).astype(np.float32)
    b = rng.standard_normal((O,)).astype(np.float32)
    return x, raw, rawm, flow, wt, b


def _jax_offc(raw, flow, d=D):
    """crfp_tpu/nn/align.py:293-296."""
    flow_t = jnp.tile(jnp.asarray(flow)[..., ::-1], (1, 1, 1, G * K2))
    return jnp.clip(MAG * jnp.tanh(jnp.asarray(raw)) + flow_t, -float(d), float(d))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _port(x, raw, rawm, flow, wt, b, fn=None, dtype=torch.float32, d=D):
    from crfp_torch.ops.dcn_windowed import deform_conv2d_fusedprep_ref

    fn = fn or deform_conv2d_fusedprep_ref
    w_t = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    out = fn(_nchw(x).to(dtype), _nchw(raw).to(dtype), _nchw(rawm).to(dtype),
             _nchw(flow), w_t, torch.from_numpy(b), max_residue_magnitude=MAG,
             max_displacement=d)
    return out.float().permute(0, 2, 3, 1).numpy()


def test_plain_version_matches_pallas_fusedprep_interpret():
    from crfp_tpu.ops.pallas.dcn import deform_conv2d_pallas_fusedprep

    x, raw, rawm, flow, wt, b = _inputs()
    offc = _jax_offc(raw, flow)
    assert float(jnp.mean(jnp.abs(offc) == D)) > 0.05  # the clip is active
    want = np.asarray(deform_conv2d_pallas_fusedprep(
        jnp.asarray(x), offc, jax.nn.sigmoid(jnp.asarray(rawm)), jnp.asarray(wt),
        jnp.asarray(b), max_displacement=D, band=8, xtile=32, interpret=True))
    got = _port(x, raw, rawm, flow, wt, b)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("window", [D, None], ids=["clipped", "unclipped"])
def test_plain_version_matches_gather_oracle(window):
    from crfp_tpu.ops.dcn import deform_conv2d

    x, raw, rawm, flow, wt, b = _inputs(seed=8)
    offc = _jax_offc(raw, flow, 1e9 if window is None else window)
    want = np.asarray(deform_conv2d(
        jnp.asarray(x), offc.reshape(N, H, W, G, K2, 2),
        jax.nn.sigmoid(jnp.asarray(rawm)).reshape(N, H, W, G, K2),
        jnp.asarray(wt), jnp.asarray(b)))
    got = _port(x, raw, rawm, flow, wt, b, d=window)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_flow_channel_order_matters():
    """dy takes flow[..., 1] and dx flow[..., 0]: swapping the flow's
    channels must change the result (guards the test above against inputs
    that could not tell)."""
    x, raw, rawm, flow, wt, b = _inputs()
    a = _port(x, raw, rawm, flow, wt, b)
    s = _port(x, raw, rawm, flow[..., ::-1].copy(), wt, b)
    assert float(np.abs(a - s).max()) > 0.1


def test_plain_version_bf16_x_and_heads():
    """bf16 x and heads: upcast to f32 inside, output in bf16; against the
    f32 result within bf16's resolution of the heads (2e-2 of max|ref|)."""
    x, raw, rawm, flow, wt, b = _inputs()
    want = _port(x, raw, rawm, flow, wt, b)
    from crfp_torch.ops.dcn_windowed import deform_conv2d_fusedprep_ref

    w_t = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    out = deform_conv2d_fusedprep_ref(
        _nchw(x).bfloat16(), _nchw(raw).bfloat16(), _nchw(rawm).bfloat16(),
        _nchw(flow), w_t, torch.from_numpy(b), max_residue_magnitude=MAG,
        max_displacement=D)
    assert out.dtype == torch.bfloat16
    got = out.float().permute(0, 2, 3, 1).numpy()
    assert float(np.abs(got - want).max()) <= 2e-2 * float(np.abs(want).max())


def test_dispatcher_takes_plain_version_on_cpu_and_counts_nothing():
    from crfp_torch.ops.cuda import dcn_fused

    args = _inputs()
    before = dcn_fused.launches
    got = _port(*args, fn=dcn_fused.deform_conv2d_fusedprep)
    np.testing.assert_array_equal(got, _port(*args))
    assert dcn_fused.launches == before


def test_dispatcher_raises_on_grad_and_on_other_devices():
    from crfp_torch.ops.cuda.dcn_fused import deform_conv2d_fusedprep

    x, raw, rawm, flow, wt, b = _inputs()
    w_t = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    ops = [_nchw(x), _nchw(raw), _nchw(rawm), _nchw(flow), w_t, torch.from_numpy(b)]
    for i in range(len(ops)):
        leaf = [t.clone().requires_grad_(j == i) for j, t in enumerate(ops)]
        with pytest.raises(ValueError, match="no backward"):
            deform_conv2d_fusedprep(*leaf, max_displacement=D)
        with torch.no_grad():  # not recorded: allowed
            deform_conv2d_fusedprep(*leaf, max_displacement=D)
    with pytest.raises(ValueError, match="CUDA tensor"):
        deform_conv2d_fusedprep(*(t.to("meta") for t in ops), max_displacement=D)
