"""Kernels C (frame emission) and F (SSIM map) of the port, on the CPU.

- Their plans: ``crfp_torch.ops.cuda.ssim.ssim_plan`` and
  ``crfp_torch.ops.cuda.emit.emit_plan`` write every output pixel exactly
  once (the kernels' index math, mirrored by the plans) at the main paths'
  shapes and at ragged ones, and the main paths take the wide tile and the
  row route.
- The plain versions against the JAX package at ragged shapes, f32, on the
  same numpy inputs: ``ssim_map_ref`` against the Pallas SSIM kernel in
  interpret mode, ``emit_frame_ref`` at r = 1 against y plus JAX's
  bilinear resize and at r = 4 against the Pallas emission kernel in
  interpret mode, each to 1e-5.
- ``masked_ssim`` hands kernel F the NHWC images as NCHW views, each in
  its own layout; on CPU tensors the plain version takes them and equals
  the NCHW copies' route and JAX's Pallas masked SSIM to 1e-6.
- The dispatchers' operand checks name every fault, the device last.
- On the card (``cuda`` marker, skipped here): C and F against their plain
  versions at the ragged shapes and on views with a storage offset, and
  bit-equal over two runs and a CUDA-graph replay.

JAX is imported inside the tests that use it as the oracle, so that the
card's tests run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

_NEEDS_CARD = pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs an NVIDIA GPU and nvcc")
# (N, C, H, W): the main paths' calls, then ragged shapes
_PATH_SHAPES = [(14, 3, 192, 192), (14, 1, 192, 192), (1, 3, 720, 1280), (1, 3, 1080, 1920)]
_EDGE_SHAPES = [(1, 1, 5, 7), (2, 1, 33, 65), (1, 3, 11, 11)]
# an LR frame for each ragged frame (any ratio: the bilinear base resizes)
_EDGE_LR = {(1, 1, 5, 7): (2, 3), (2, 1, 33, 65): (5, 9), (1, 3, 11, 11): (2, 2)}


def _shape_id(s):
    return "x".join(map(str, s))


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _images(shape_nhwc, seed):
    rng = np.random.default_rng(seed)
    hr = rng.uniform(0, 1, shape_nhwc).astype(np.float32)
    sr = np.clip(hr + 0.1 * rng.standard_normal(shape_nhwc), 0, 1).astype(np.float32)
    mask = (rng.uniform(0, 1, (*shape_nhwc[:3], 1)) > 0.3).astype(np.float32)
    return sr, hr, mask


# ---- (a) the plans ----------------------------------------------------------

@pytest.mark.parametrize("shape", _PATH_SHAPES + _EDGE_SHAPES, ids=_shape_id)
def test_ssim_plan_writes_every_pixel_once(shape):
    """Every (row, column) of an image is stored by exactly one thread of
    one block in the horizontal pass, and every (tile row, halo column) of
    a tile is summed by exactly one vertical-pass item of the 64 x 16 tile
    with 8-row strips."""
    from crfp_torch.ops.cuda import ssim

    n, c, h, w = shape
    tile_h, tile_w, strip = ssim.TILE_H, ssim.TILE_W, ssim.STRIP
    cols = tile_w + ssim.WINDOW - 1
    plan = ssim.ssim_plan(n, c, h, w)
    gx, gy, gz = plan.grid
    assert (gx, gy, gz) == (-(-w // tile_w), -(-h // tile_h), n)
    assert plan.runs == tile_h * tile_w // ssim.RUN and plan.items == cols * (tile_h // strip)
    assert plan.threads == max(plan.items, plan.runs) == 148
    runs = np.array([plan.run(t) for t in range(plan.runs)])  # (runs, 2)
    assert runs[:, 0].max() < tile_h and runs[:, 1].max() + ssim.RUN <= tile_w
    count = np.zeros((gy * tile_h, gx * tile_w), np.int32)
    for by in range(gy):
        for bx in range(gx):
            rows = by * tile_h + runs[:, 0]
            for o in range(ssim.RUN):
                np.add.at(count, (rows, bx * tile_w + runs[:, 1] + o), 1)
    assert (count == 1).all()  # the kernel stores those inside the image
    tile = np.zeros((tile_h, cols), np.int32)
    for t in range(plan.threads):
        item = plan.vertical_item(t)
        if item is not None:
            tile[item[0]:item[0] + strip, item[1]] += 1
    assert (tile == 1).all()


@pytest.mark.parametrize("shape", _PATH_SHAPES + _EDGE_SHAPES, ids=_shape_id)
def test_emit_plan_writes_every_pixel_once(shape):
    """Every output pixel of each image is written by exactly one thread;
    the main paths' frames (r = 1, width a multiple of 8, aligned) take the
    row route, ragged widths, r = 4 and a misaligned y the pixel route."""
    from crfp_torch.ops.cuda import emit

    n, c, h, w = shape
    # (r, dtype, y's offset from an aligned address in bytes, row route expected)
    cases = [(1, torch.bfloat16, 0, w % 8 == 0), (1, torch.float32, 0, w % 8 == 0),
             (1, torch.bfloat16, 2, False), (4, torch.float32, 0, False)]
    for r, dtype, y_off, vector in cases:
        plan = emit.emit_plan(n, c, h, w, r, dtype, 256 + y_off, 512, w // 8 or 1)
        assert plan.vector == vector, (r, dtype, y_off, plan)
        assert plan.grid[1] == n and (plan.height, plan.width) == (h, w)
        idx = plan.outputs(np.arange(plan.grid[0])[:, None], np.arange(plan.threads))
        count = np.bincount(idx[idx >= 0], minlength=h * w)
        assert len(count) == h * w and (count == 1).all(), (r, y_off, plan)


def test_emit_plan_row_route_limits():
    """The row route's block and staged row stay inside what the C entry
    admits; beyond them the pixel route takes the call."""
    from crfp_torch.ops.cuda import emit

    bf16, f32 = torch.bfloat16, torch.float32
    assert emit.emit_plan(1, 3, 1080, 1920, 1, bf16, 0, 0, 240).threads == 256
    assert emit.emit_plan(1, 3, 8, 4096, 1, bf16, 0, 0, 512).vector
    assert not emit.emit_plan(1, 3, 8, 4104, 1, bf16, 0, 0, 513).vector  # 513 threads
    assert not emit.emit_plan(1, 3, 8, 4096, 1, f32, 0, 0, 512).vector  # 54 KB of row
    assert emit.emit_plan(1, 3, 8, 3072, 1, f32, 0, 0, 384).vector  # 40.5 KB
    assert not emit.emit_plan(1, 2, 8, 64, 1, f32, 0, 0, 8).vector  # 2 channels
    assert not emit.emit_plan(1, 3, 8, 64, 1, f32, 0, 8, 8).vector  # frame misaligned


# ---- (b) the plain versions against JAX at ragged shapes ---------------------

@pytest.mark.parametrize("shape", _EDGE_SHAPES, ids=_shape_id)
def test_ssim_map_ref_matches_jax_pallas_at_ragged_shapes(shape):
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.ssim import ssim_map_pallas
    from crfp_torch.ops.cuda.ssim import ssim_map_ref

    n, c, h, w = shape
    sr, hr, _ = _images((n, h, w, c), seed=sum(shape))
    want = np.asarray(ssim_map_pallas(jnp.asarray(sr), jnp.asarray(hr), interpret=True))
    got = ssim_map_ref(_nchw(sr), _nchw(hr))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", _EDGE_SHAPES, ids=_shape_id)
def test_emit_frame_ref_r1_matches_jax_resize_at_ragged_widths(shape):
    """At widths that are not a multiple of 8 the x8 ``upsample`` does not
    apply; JAX's bilinear resize to the frame size is the oracle."""
    import jax.numpy as jnp
    from crfp_tpu.ops.resize import resize_bilinear
    from crfp_torch.ops.cuda.emit import emit_frame_ref

    n, c, h, w = shape
    rng = np.random.default_rng(sum(shape))
    y = rng.standard_normal((n, h, w, c)).astype(np.float32)
    lr = rng.uniform(0, 1, (n, *_EDGE_LR[shape], c)).astype(np.float32)
    want = np.asarray(jnp.asarray(y) + resize_bilinear(jnp.asarray(lr), (h, w)))
    got = emit_frame_ref(_nchw(y), _nchw(lr), r=1)
    assert got.shape == (n, h, w, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,hs,ws,c", [(2, 10, 32, 1), (1, 6, 64, 3)])
def test_emit_frame_ref_r4_matches_jax_emit_kernel_at_more_shapes(n, hs, ws, c):
    """Two batch items, one channel, several bands and lane groups (the
    JAX kernel takes s2d widths in multiples of 128 / r)."""
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.emit import (
        depth_to_space_add_chw,
        emit_res_rows,
        upsample_planar,
    )
    from crfp_torch.ops.cuda.emit import emit_frame_ref

    r = 4
    rng = np.random.default_rng(hs + ws)
    y = rng.standard_normal((n, hs, ws, c * r * r)).astype(np.float32)
    lr = rng.uniform(0, 1, (n, hs * r // 8, ws * r // 8, c)).astype(np.float32)
    res = upsample_planar(jnp.asarray(lr), 8, pad_to=emit_res_rows(hs))
    want = np.asarray(depth_to_space_add_chw(jnp.asarray(y), res, r=r,
                                             interpret=True)).transpose(0, 2, 3, 1)
    got = emit_frame_ref(_nchw(y), _nchw(lr), r=r)
    assert got.shape == (n, hs * r, ws * r, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---- (c) masked_ssim reads the NHWC images in place --------------------------

@pytest.mark.parametrize("shape", _EDGE_SHAPES + [(2, 3, 24, 40)], ids=_shape_id)
def test_masked_ssim_in_place_matches_copies_and_jax(shape):
    import jax.numpy as jnp
    from crfp_tpu.ops.pallas.ssim import masked_ssim_pallas
    from crfp_torch.bench.emit_ssim import masked_ssim_copies
    from crfp_torch.ops.metrics import masked_ssim

    n, c, h, w = shape
    arrays = _images((n, h, w, c), seed=3 + sum(shape))
    got = float(masked_ssim(*(torch.from_numpy(a) for a in arrays)))
    old = float(masked_ssim_copies(*(torch.from_numpy(a) for a in arrays)))
    want = float(masked_ssim_pallas(*(jnp.asarray(a) for a in arrays), interpret=True))
    assert abs(got - old) <= 1e-6
    assert abs(got - want) <= 1e-6


# ---- the dispatchers' operand checks -----------------------------------------

def _ssim_good():
    return torch.zeros(2, 3, 6, 7), torch.zeros(2, 3, 6, 7)


def _nhwc_view(t):
    return t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def _hw_transposed(t):
    return t.transpose(2, 3).contiguous().transpose(2, 3)


def _spread(t):
    """``t``'s shape on the meta device at a channel stride of 2^30."""
    return torch.empty(2 ** 33, device="meta").as_strided(
        t.shape, (2 ** 31, 2 ** 30, t.shape[3], 1))


_SSIM_BAD = {
    "meta_device": (lambda x, y: (x.to("meta"), y.to("meta")), "CUDA tensor"),
    "cpu_tensor": (lambda x, y: (x, y), "CUDA tensor"),
    "y_on_meta": (lambda x, y: (x, y.to("meta")), "y on meta, x on cpu"),
    "x_3d": (lambda x, y: (x[0], y[0]), r"share one \(N, C, H, W\) shape"),
    "shape_mismatch": (lambda x, y: (x, y[:, :2]), r"share one \(N, C, H, W\) shape"),
    "x_float64": (lambda x, y: (x.double(), y), "must be float32"),
    "y_bfloat16": (lambda x, y: (x, y.bfloat16()), "must be float32"),
    "requires_grad": (lambda x, y: (x.requires_grad_(True), y), "no backward"),
    "image_spans_2_31": (lambda x, y: (torch.empty(1, 3, 2 ** 15, 2 ** 15, device="meta"),) * 2,
                         "x's image .* spans more than 2\\^31 elements"),
    "x_strides_span_2_31": (lambda x, y: (_spread(x), y), "x's image .* spans more than 2\\^31"),
    "y_strides_span_2_31": (lambda x, y: (x, _spread(y)), "y's image .* spans more than 2\\^31"),
}
# layouts the kernel reads in place: NCHW, NHWC views, H and W transposed,
# and x and y each in its own (the train step's output and ground truth)
_SSIM_LAYOUTS = {
    "nchw": lambda x, y: (x, y),
    "nhwc": lambda x, y: (_nhwc_view(x), _nhwc_view(y)),
    "hw_transposed": lambda x, y: (_hw_transposed(x), _hw_transposed(y)),
    "one_of_each": lambda x, y: (x, _nhwc_view(y)),
}


@pytest.mark.parametrize("case", sorted(_SSIM_BAD))
def test_ssim_check_refuses_every_wrong_operand(case):
    """The check names each fault; the device comes last, so the other
    faults can be told apart on CPU tensors. Every layout passes, x and y
    each in its own."""
    from crfp_torch.ops.cuda import ssim

    make, message = _SSIM_BAD[case]
    x, y = make(*_ssim_good())
    with pytest.raises(ValueError, match=message):
        ssim._check(x, y)
    if x.device.type != "cpu":  # the dispatcher itself refuses it too
        with pytest.raises(ValueError, match=message):
            ssim.ssim_map(x, y)
    for layout in _SSIM_LAYOUTS.values():  # what the kernel takes: only the device
        with pytest.raises(ValueError, match="CUDA tensor"):
            ssim._check(*layout(*_ssim_good()))


def _emit_good():
    return torch.zeros(1, 3, 16, 24), torch.zeros(1, 3, 2, 3)


_EMIT_BAD = {
    "meta_device": (lambda y, lr: (y.to("meta"), lr.to("meta"), 1), "CUDA tensor"),
    "cpu_tensor": (lambda y, lr: (y, lr, 1), "CUDA tensor"),
    "lr_on_meta": (lambda y, lr: (y, lr.to("meta"), 1), "lr on meta, y on cpu"),
    "y_3d": (lambda y, lr: (y[0], lr, 1), "must be 4-D"),
    "lr_3d": (lambda y, lr: (y, lr[0], 1), "must be 4-D"),
    "channels": (lambda y, lr: (torch.zeros(1, 4, 16, 24), lr, 1), r"not the s2d\(1\) form"),
    "r_not_s2d": (lambda y, lr: (y, lr, 4), r"not the s2d\(4\) form"),
    "r_zero": (lambda y, lr: (y, lr, 0), r"not the s2d\(0\) form"),
    "batch": (lambda y, lr: (torch.zeros(2, 3, 16, 24), lr, 1), r"not the s2d\(1\) form"),
    "y_float16": (lambda y, lr: (y.half(), lr.half(), 1), "must share float32 or bfloat16"),
    "lr_dtype": (lambda y, lr: (y, lr.bfloat16(), 1), "must share float32 or bfloat16"),
    "y_not_contiguous": (lambda y, lr: (torch.zeros(1, 3, 24, 16).transpose(2, 3), lr, 1),
                         "must be contiguous"),
    "lr_not_contiguous": (lambda y, lr: (y, torch.zeros(1, 3, 3, 2).transpose(2, 3), 1),
                          "must be contiguous"),
}


@pytest.mark.parametrize("case", sorted(_EMIT_BAD))
def test_emit_check_refuses_every_wrong_operand(case):
    """The check names each fault; the device comes last, so the other
    faults can be told apart on CPU tensors."""
    from crfp_torch.ops.cuda import emit

    make, message = _EMIT_BAD[case]
    y, lr, r = make(*_emit_good())
    with pytest.raises(ValueError, match=message):
        emit._check(y, lr, r)
    if y.device.type != "cpu":  # the dispatcher itself refuses it too
        with pytest.raises(ValueError, match=message):
            emit.emit_frame(y, lr, r)
    with pytest.raises(ValueError, match="CUDA tensor"):  # only the device
        emit._check(*_emit_good(), 1)


# ---- (d) on the card ---------------------------------------------------------

def _offset(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view one element past an aligned address."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view_as(t).copy_(t)


def _replayed(fn):
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
@pytest.mark.parametrize("shape", _EDGE_SHAPES + [(2, 3, 40, 136)], ids=_shape_id)
@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset_view"])
def test_kernel_f_matches_plain_and_repeats_on_card(shape, offset):
    from crfp_torch.ops.cuda import ssim

    n, c, h, w = shape
    gen = torch.Generator().manual_seed(sum(shape))
    hr = torch.rand(n, c, h, w, generator=gen).cuda()
    sr = (hr + 0.1 * torch.randn(n, c, h, w, generator=gen).cuda()).clamp(0, 1)
    if offset:
        sr, hr = _offset(sr), _offset(hr)
    want = ssim.ssim_map_ref(sr, hr)
    got = ssim.ssim_map(sr, hr)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got.double().mean() - want.double().mean()).abs()) <= 1e-6
    nhwc = [_offset(t.permute(0, 2, 3, 1)) if offset else t.permute(0, 2, 3, 1).contiguous()
            for t in (sr, hr)]
    assert torch.equal(ssim.ssim_map(*(t.permute(0, 3, 1, 2) for t in nhwc)), got)
    for layout in _SSIM_LAYOUTS.values():  # every layout reads the same bits
        assert torch.equal(ssim.ssim_map(*layout(sr, hr)), got)
    assert torch.equal(ssim.ssim_map(sr, hr), got)
    assert torch.equal(_replayed(lambda: ssim.ssim_map(sr, hr)), got)


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("shape", _EDGE_SHAPES + [(2, 3, 40, 136), (1, 1, 16, 64)],
                         ids=_shape_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_c_matches_plain_and_repeats_on_card(shape, dtype):
    """The aligned call (the row route where the width allows) and the same
    values through an offset view (the pixel route) give the same bits;
    f32 to 1e-5 and bf16 to 2e-2 of max|ref| against the plain version."""
    from crfp_torch.ops.cuda import emit

    n, c, h, w = shape
    gen = torch.Generator().manual_seed(sum(shape))
    lr_hw = _EDGE_LR.get(shape, (h // 8, w // 8))
    y = torch.randn(n, c, h, w, generator=gen).to("cuda", dtype)
    lr = torch.rand(n, c, *lr_hw, generator=gen).to("cuda", dtype)
    want = emit.emit_frame_ref(y.float(), lr.float())
    got = emit.emit_frame(y, lr)
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    assert err <= (1e-5 if dtype == torch.float32 else 2e-2 * float(want.abs().max()))
    assert torch.equal(emit.emit_frame(_offset(y), lr), got)
    assert torch.equal(emit.emit_frame(y, lr), got)
    assert torch.equal(_replayed(lambda: emit.emit_frame(y, lr)), got)
