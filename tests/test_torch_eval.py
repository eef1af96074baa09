"""crfp_torch's evaluation modules against the JAX package's on the CPU,
from the same numpy inputs: zone masks and rectangle bounds exactly over
gazes that leave the frame; OnChipZoneEval and StreamingZoneEval over a
streamed clip (PSNR to 1e-3 dB, SSIM to 1e-5: f32 sums in another order),
including the empty "past" zone of a first frame; foveated heat-maps,
psnr_and_ssim with its range heuristic, rgb2yuv / yuv2rgb, the
MATLAB-compatible metrics and evaluate_clips over 3 batches."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import test_torch_train as tt  # noqa: E402
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)


def test_zone_masks_and_rect_bounds_equal_jax_exactly():
    from crfp_tpu.eval import zones as jz
    from crfp_torch.eval import zones as tz

    rng = np.random.default_rng(0)
    h, w, fv = 72, 104, 24
    n_out = 0
    for i in range(60):
        gaze = (rng.normal(h / 2, h), rng.normal(w / 2, w))  # often outside
        kw = dict(active=bool(i % 5), regional_dcn=bool(i % 2), dcn_size=48)
        a, b = jz.zone_masks_step(h, w, gaze, fv, **kw), tz.zone_masks_step(h, w, gaze, fv, **kw)
        assert a.top_left == b.top_left
        for f in ("fovea", "mask", "outskirt", "fg"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        n_out += a.fovea.sum() < fv * fv
    assert n_out > 10  # the sweep does leave the frame
    for c0 in range(-40, 90, 3):
        for size in (1, 24, 96):
            assert jz._rect_bounds(c0, size, 72) == tz._rect_bounds(c0, size, 72)


@pytest.mark.parametrize("density", [0.0, 0.002, 0.05], ids=["empty", "sparse", "dense"])
def test_cropped_dilation_equals_full_frame_dilation(density):
    """The outskirt's dilation over the mask's grown bounding box equals
    scipy's over the whole frame, for scattered points and for rectangles
    cut by every edge."""
    from scipy import ndimage

    from crfp_torch.eval.zones import _dilate

    rng = np.random.default_rng(7)
    for i in range(40):
        h, w = (int(v) for v in rng.integers(3, 90, 2))
        m = rng.uniform(0, 1, (h, w)) < density
        if i % 2 and density:
            y, x, s = int(rng.integers(-15, h + 15)), int(rng.integers(-15, w + 15)), 1 + i
            m[max(y, 0):max(y + s, 0), max(x, 0):max(x + s, 0)] = True
        want = ndimage.binary_dilation(m, np.ones((3, 3), bool), iterations=10)
        np.testing.assert_array_equal(_dilate(m, 10), want, err_msg=f"case {i}")


def _zone_clip(seed=1, t=6, h=64, w=96, fv=16):
    from crfp_torch.eval.zones import zone_masks_step

    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (t, 1, h, w, 3)).astype(np.float32)
    sr = np.clip(gt + rng.normal(0, 0.08, gt.shape), 0, 1).astype(np.float32)
    # gazes inside, at the border and outside the frame
    gazes = [(h / 2, w / 2), (2.0, 3.0), (h - 1.0, w + 30.0), (h / 2 + 9, w / 2 - 7),
             (-40.0, 10.0), (h / 2, w / 2)][:t]
    zones = [zone_masks_step(h, w, g, fv, active=i != 3) for i, g in enumerate(gazes)]
    return sr, gt, zones, fv


@pytest.mark.parametrize("kind", ["on_chip", "streaming"])
def test_zone_eval_matches_jax(kind):
    from crfp_tpu.eval import zones as jz
    from crfp_torch.eval import zones as tz

    sr, gt, zones, fv = _zone_clip()
    if kind == "on_chip":
        je, te = jz.OnChipZoneEval(fv), tz.OnChipZoneEval(fv, device="cpu")
    else:
        je, te = jz.StreamingZoneEval(), tz.StreamingZoneEval(device="cpu")
    for i, z in enumerate(zones):
        je.update(jnp.asarray(sr[i]), jnp.asarray(gt[i]), z)
        te.update(torch.from_numpy(sr[i]), gt[i], z)
        if i == 0:  # first frame: no past zone yet, and nothing non-finite
            assert te.results["psnr_past"] == [] and te.results["ssim_past"] == []
    for k, want in je.results.items():
        got = te.results[k]
        assert len(got) == len(want) > 0, k
        if kind == "on_chip":  # an empty zone scores 0 there, never 0/0
            assert np.isfinite(got).all(), k
        else:  # the host-mask evaluator divides by an empty fovea's 0, as JAX's does
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=k)
        tol = 1e-3 if k.startswith("psnr") else 1e-5
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=k)
    js, ts = je.summary(), te.summary()
    assert js.keys() == ts.keys()
    # a second clip starts with an empty past again
    te.new_clip()
    n = len(te.results["psnr_past"])
    te.update(sr[0], gt[0], zones[0])
    assert len(te.results["psnr_past"]) == n


def test_on_chip_eval_equals_streaming_eval():
    """The rectangle masks rebuilt on the device are the host masks."""
    from crfp_torch.eval import zones as tz

    sr, gt, zones, fv = _zone_clip(seed=2)
    a, b = tz.OnChipZoneEval(fv, device="cpu"), tz.StreamingZoneEval(device="cpu")
    for i, z in enumerate(zones):
        a.update(sr[i], gt[i], z)
        b.update(sr[i], gt[i], z)
    n_empty = 0
    for k in a.results:
        got, want = np.array(a.results[k]), np.array(b.results[k])
        empty = np.isnan(want)  # a gaze outside the frame: empty fovea and ring
        n_empty += int(empty.sum())
        assert (got[empty] == 0).all(), k
        np.testing.assert_allclose(got[~empty], want[~empty], atol=1e-4, rtol=0, err_msg=k)
    assert n_empty > 0


def test_foveated_metric_matches_jax():
    from crfp_tpu.eval.foveated import foveated_metric as jf
    from crfp_torch.eval.foveated import foveated_metric as tf

    rng = np.random.default_rng(3)
    hr = rng.uniform(0, 1, (43, 57, 3)).astype(np.float32)
    sr = np.clip(hr + rng.normal(0, 0.05, hr.shape), 0, 1).astype(np.float32)
    sr[:10, :10] = hr[:10, :10]  # one patch with zero error: the PSNR floor
    want = jf(jnp.asarray(sr), jnp.asarray(hr))
    got = tf(torch.from_numpy(sr), torch.from_numpy(hr))
    assert got[0].shape == (7, 10)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5, rtol=0)
    for g, w in zip(got[2] + got[3], want[2] + want[3]):
        np.testing.assert_allclose(float(g), float(w), atol=1e-3, rtol=0)


@pytest.mark.parametrize("scale", ["unit", "pm1", "255"])
def test_psnr_and_ssim_range_heuristic_matches_jax(scale):
    from crfp_tpu.ops.metrics import psnr_and_ssim as jp
    from crfp_torch.ops.metrics import psnr_and_ssim as tp_

    rng = np.random.default_rng(4)
    hr = rng.uniform(0, 1, (1, 40, 56, 3)).astype(np.float32)
    sr = np.clip(hr + rng.normal(0, 0.05, hr.shape), 0, 1).astype(np.float32)
    if scale == "pm1":
        sr, hr = sr * 2 - 1, hr * 2 - 1
    elif scale == "255":
        sr, hr = sr * 255, hr * 255
    mask = (rng.uniform(0, 1, (1, 40, 56, 1)) > 0.4).astype(np.float32)
    want = jp(jnp.asarray(sr), jnp.asarray(hr), jnp.asarray(mask))
    got = tp_(torch.from_numpy(sr), torch.from_numpy(hr), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got[0]), float(want[0]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-5, rtol=0)


def test_yuv_pair_matches_jax():
    from crfp_tpu.ops import color as jc
    from crfp_torch.ops import color as tc

    rgb = np.random.default_rng(5).uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    yuv = tc.rgb2yuv(torch.from_numpy(rgb))
    np.testing.assert_allclose(yuv.numpy(), np.asarray(jc.rgb2yuv(jnp.asarray(rgb))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tc.yuv2rgb(yuv).numpy(),
                               np.asarray(jc.yuv2rgb(jnp.asarray(yuv.numpy()))),
                               atol=1e-6, rtol=0)


def test_matlab_metrics_equal_jax_package():
    from crfp_tpu.eval import matlab_metrics as jm
    from crfp_torch.eval import matlab_metrics as tm

    rng = np.random.default_rng(6)
    hr = rng.uniform(-1, 1, (1, 36, 44, 3)).astype(np.float32)
    sr = np.clip(hr + rng.normal(0, 0.1, hr.shape), -1, 1).astype(np.float32)
    assert tm.calc_psnr_and_ssim(sr, hr) == jm.calc_psnr_and_ssim(sr, hr)
    a, b = (sr[0] + 1) * 127.5, (hr[0] + 1) * 127.5
    assert tm.calc_psnr(a, b) == jm.calc_psnr(a, b)
    assert tm.calc_ssim(a, b) == jm.calc_ssim(a, b)


def test_evaluate_clips_matches_jax(tmp_path):
    """3 batches through both evaluators: batch 0 drops its first frame
    (the every-50th-window rule), so 8 of 9 frames count."""
    from crfp_tpu.eval.evaluator import evaluate_clips as jeval
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from crfp_torch.eval.evaluator import evaluate_clips as teval

    batches = [tt.clip_batch(seed=s) for s in range(3)]
    loader = [{"LR": b["lr"], "Ref": b["fv"], "Ref_sp": b["mk"], "HR": b["hr"]}
              for b in batches]
    jmodel = JCRFP(tt.jax_cfg(dcn_window=8, dcn_window_hr=32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *(jnp.asarray(batches[0][k])
                                                          for k in ("lr", "fv", "mk")))
    flat = tp.perturb_heads(tp.flat_params(params), seed=1)
    want = jeval(jmodel, tp.unflatten(flat), loader)
    logs = []
    tmodel = tt.torch_crfp(flat, dcn_window=8, dcn_window_hr=32)
    got = teval(tmodel, loader, log=logs.append, save_dir=str(tmp_path / "sr"))
    assert got.n_frames == want.n_frames == 3 * tt.T - 1
    np.testing.assert_allclose(got.psnr, want.psnr, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.psnr_y, want.psnr_y, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.ssim, want.ssim, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.ssim_y, want.ssim_y, atol=1e-5, rtol=0)
    assert len(logs) == 1 and "PSNR" in str(got)
    assert len(list((tmp_path / "sr").glob("sr_*.png"))) == 3 * tt.T
    # the y_only evaluation reads the UV of LR_sr, which these batches lack
    # (tests/test_torch_variants_stream.py holds it against JAX)
    with pytest.raises(KeyError, match="LR_sr"):
        teval(tmodel, loader[:1], y_only=True)
