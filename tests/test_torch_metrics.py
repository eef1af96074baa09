"""crfp_torch metrics, color, schedule and loss against the JAX package on
the CPU, f32, on the same numpy inputs: masked PSNR (with its zero floor),
masked SSIM (the JAX XLA path, use_pallas=False), the plain SSIM map
against the JAX Pallas kernel in interpret mode, the metric luma, the
cosine-restart schedule and the Charbonnier loss."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    hr = rng.uniform(0, 1, shape).astype(np.float32)
    sr = np.clip(hr + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    mask = (rng.uniform(0, 1, (*shape[:3], 1)) > 0.3).astype(np.float32)
    return sr, hr, mask


def test_gaussian_window_matches_jax():
    from crfp_tpu.ops.metrics import _gaussian_window as jwin
    from crfp_torch.ops.metrics import _gaussian_window

    np.testing.assert_array_equal(_gaussian_window(), jwin())


@pytest.mark.parametrize("channels", [3, 1], ids=["rgb", "y"])
def test_masked_psnr_and_ssim_match_jax(channels):
    from crfp_tpu.ops import metrics as jm
    from crfp_torch.ops import metrics as tm

    sr, hr, mask = _images((2, 37, 45, channels), seed=channels)
    jargs = [jnp.asarray(a) for a in (sr, hr, mask)]
    targs = [torch.from_numpy(a) for a in (sr, hr, mask)]
    np.testing.assert_allclose(float(tm.masked_psnr(*targs)),
                               float(jm.masked_psnr(*jargs)), rtol=1e-6)
    np.testing.assert_allclose(float(tm.masked_ssim(*targs)),
                               float(jm.masked_ssim(*jargs, use_pallas=False)),
                               rtol=0, atol=1e-6)


def test_masked_psnr_zero_floor_matches_jax():
    from crfp_tpu.ops.metrics import masked_psnr as jpsnr
    from crfp_torch.ops.metrics import masked_psnr

    sr, _, mask = _images((1, 8, 9, 3), seed=4)
    want = float(jpsnr(jnp.asarray(sr), jnp.asarray(sr), jnp.asarray(mask)))
    got = float(masked_psnr(*(torch.from_numpy(a) for a in (sr, sr, mask))))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_ssim_map_ref_matches_jax_pallas_interpret():
    """The map to 4e-6: both f32 versions are ~2e-6 from the float64 map at
    these inputs (<x^2> - mu^2 cancels), so 1e-6 is below their own
    rounding; the masked mean, where the rounding averages out, to 1e-6."""
    from crfp_tpu.ops.pallas.ssim import masked_ssim_pallas, ssim_map_pallas
    from crfp_torch.ops.cuda.ssim import ssim_map_ref
    from crfp_torch.ops.metrics import masked_ssim

    sr, hr, mask = _images((2, 40, 48, 3), seed=5)
    want = np.asarray(ssim_map_pallas(jnp.asarray(sr), jnp.asarray(hr), interpret=True))
    got = ssim_map_ref(torch.from_numpy(sr).permute(0, 3, 1, 2).contiguous(),
                       torch.from_numpy(hr).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=4e-6)
    want_mean = float(masked_ssim_pallas(*(jnp.asarray(a) for a in (sr, hr, mask)),
                                         interpret=True))
    got_mean = float(masked_ssim(*(torch.from_numpy(a) for a in (sr, hr, mask))))
    np.testing.assert_allclose(got_mean, want_mean, rtol=0, atol=1e-6)


def test_color_matches_jax():
    from crfp_tpu.ops import color as jc
    from crfp_torch.ops import color as tc

    img = np.random.default_rng(6).uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(tc.bgr2ycbcr_y(torch.from_numpy(img)).numpy(),
                               np.asarray(jc.bgr2ycbcr_y(jnp.asarray(img))), rtol=1e-6)
    np.testing.assert_allclose(tc.rgb2y(torch.from_numpy(img)).numpy(),
                               np.asarray(jc.rgb2y(jnp.asarray(img))), rtol=0, atol=1e-6)


def test_schedule_matches_jax():
    from crfp_tpu.train.schedule import cosine_restart_schedule as jsched
    from crfp_torch.train.schedule import cosine_restart_schedule as tsched

    for args in [(2e-4,), (1e-4, (100, 200), (1.0, 0.5)), (2.5e-5, (4,), (1.0,), 1e-6)]:
        j, t = jsched(*args), tsched(*args)
        # the JAX schedule runs in f32: near the end of a period its value
        # carries an error of ~1e-7 of the base rate
        for it in [0, 1, 2, 3, 4, 5, 50, 99, 100, 150, 299, 300, 5000, 599_999]:
            np.testing.assert_allclose(t(it), float(j(it)), rtol=1e-6, atol=1e-6 * args[0])
    with pytest.raises(ValueError):
        tsched(1e-4, (10, 20), (1.0,))


def test_charbonnier_matches_jax():
    from crfp_tpu.train.loop import charbonnier_loss as jloss
    from crfp_torch.train.loop import charbonnier_loss

    rng = np.random.default_rng(7)
    a, b = (rng.standard_normal((2, 3, 4, 5, 3)).astype(np.float32) for _ in range(2))
    mk = (rng.uniform(0, 1, (2, 3, 4, 5, 1)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(float(charbonnier_loss(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jloss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_allclose(
        float(charbonnier_loss(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(mk))),
        float(jloss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mk))), rtol=1e-6)
