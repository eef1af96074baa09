"""Gradients of the port's plain versions of kernels A and B (which the CPU
takes, and which kernel D matches on the card) against jax.vjp of the JAX
package's CPU path, f32, on the same numpy inputs and cotangents: the
windowed DCN (crfp_tpu/ops/dcn_windowed.py) per-tap with G=8 and
shared-tap/shared-mask with G=1, clamped and unclamped, for x, offset,
mask, weight and bias; the warp (crfp_tpu/ops/warp.py::flow_warp) on the
clipped flow, for x and flow. Every gradient to 1e-5 of its max|ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _close(got: np.ndarray, want: np.ndarray, name: str) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), (name, err, float(np.abs(want).max()))


@pytest.mark.parametrize("window", [2, None], ids=["clamped", "unclamped"])
@pytest.mark.parametrize("mode", ["per_tap", "shared"])
def test_dcn_ref_gradients_match_jax_vjp(mode, window):
    from crfp_tpu.ops.dcn_windowed import deform_conv2d_windowed
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    shared = mode == "shared"
    rng = np.random.default_rng(21 if shared else 22)
    n, h, w, k2 = 1, 12, 14, 9
    c, o, g = (4, 4, 1) if shared else (16, 8, 8)
    taps = 1 if shared else k2
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = (rng.standard_normal((n, h, w, g, taps, 2)) * 3).astype(np.float32)
    mask = rng.uniform(0, 1, (n, h, w, g, taps)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, o)) * 0.3).astype(np.float32)
    b = rng.standard_normal((o,)).astype(np.float32)
    ct = rng.standard_normal((n, h, w, o)).astype(np.float32)
    # the JAX window: the clamp, or one wider than every offset (the same
    # function as no clamp)
    d = window if window is not None else int(np.ceil(np.abs(off).max())) + 1
    if window is not None:
        assert (np.abs(off) > d).mean() > 0.2  # the clamp is exercised

    def jfn(x_, off_, mask_, wt_, b_):
        if shared:  # the JAX op takes the broadcast form; its vjp sums the taps
            off_ = jnp.broadcast_to(off_, off_.shape[:4] + (k2, 2))
            mask_ = jnp.broadcast_to(mask_, mask_.shape[:4] + (k2,))
        return deform_conv2d_windowed(x_, off_, mask_, wt_, b_, max_displacement=d)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, off, mask, wt, b)))
    jx, joff, jmask, jwt, jb = vjp(jnp.asarray(ct))

    leaves = [_nchw(x), _nchw(off.reshape(n, h, w, -1)), _nchw(mask.reshape(n, h, w, -1)),
              torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))),
              torch.from_numpy(b)]
    for t in leaves:
        t.requires_grad_(True)
    out = deform_conv2d_windowed_ref(*leaves, max_displacement=window,
                                     shared_taps=shared, shared_mask=shared)
    out.backward(_nchw(ct))
    tx, toff, tmask, twt, tb = (t.grad for t in leaves)
    _close(_nhwc(tx), jx, "x")
    _close(_nhwc(toff).reshape(off.shape), joff, "offset")
    _close(_nhwc(tmask).reshape(mask.shape), jmask, "mask")
    _close(twt.numpy().transpose(2, 3, 1, 0), jwt, "weight")
    _close(tb.numpy(), jb, "bias")


@pytest.mark.parametrize("d", [8, 32, None], ids=["d8", "d32", "unclamped"])
def test_warp_ref_gradients_match_jax_vjp(d):
    from crfp_tpu.ops.warp import flow_warp
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 20, 28, 5)).astype(np.float32)
    flow = (rng.standard_normal((2, 20, 28, 2)) * 1.5 * (d or 8)).astype(np.float32)
    ct = rng.standard_normal((2, 20, 28, 5)).astype(np.float32)
    if d is not None:
        assert (np.abs(flow) > d).mean() > 0.2  # the clamp is exercised

    def jfn(x_, f_):
        return flow_warp(x_, f_ if d is None else jnp.clip(f_, -d, d))

    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(flow))
    jx, jflow = vjp(jnp.asarray(ct))
    tx, tflow = _nchw(x).requires_grad_(True), _nchw(flow).requires_grad_(True)
    flow_warp_windowed_ref(tx, tflow, d).backward(_nchw(ct))
    _close(_nhwc(tx.grad), jx, "x")
    _close(_nhwc(tflow.grad), jflow, "flow")


def test_dispatchers_are_differentiable_on_cpu():
    """On CPU tensors the dispatchers of kernels A and B run the plain
    versions, so autograd of plain PyTorch gives the gradients."""
    from crfp_torch.ops.cuda import dcn, warp

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 6, 7, generator=gen, requires_grad=True)
    off = (torch.randn(1, 2, 6, 7, generator=gen) * 2).requires_grad_(True)
    mask = torch.rand(1, 1, 6, 7, generator=gen, requires_grad=True)
    w = torch.randn(4, 4, 3, 3, generator=gen, requires_grad=True)
    out = dcn.deform_conv2d_windowed(x, off, mask, w, None, max_displacement=1,
                                     shared_taps=True, shared_mask=True)
    flow = (torch.randn(1, 2, 6, 7, generator=gen) * 2).requires_grad_(True)
    warp.flow_warp_windowed(out, flow, 1).sum().backward()
    for t in (x, off, mask, w, flow):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)
