"""The port's StreamingRunner (crfp_torch.models.streaming) against the JAX
one (crfp_tpu.models.streaming) on the CPU, f32, frame by frame over a
5-frame clip (mid 16, LR 16x24): random weights with non-zero heads carried
across by ``params.from_jax`` and the trained
``checkpoints/v18_mid16_procedural.npz``; with and without the regional
gate ``fg``; with windows 4/16 and unclamped; with ``dcn_fused`` on and off
on the port's side (off the TPU the JAX flag is ignored, so one JAX run is
the reference for both). Every frame agrees to 1e-4 (f32 rounding through
10*tanh offsets over a smooth clip). Also: the port's batch forward
against its own streaming to 2e-5 (the JAX package's bound for the same
pair), and ``clear_states``."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

MID, T, H, W, S = 16, 5, 16, 24, 8
CKPT = "checkpoints/v18_mid16_procedural.npz"
WIN = dict(dcn_window=4, dcn_window_hr=16)


def _clip(seed=0):
    """A smooth moving clip with a gaze that wanders: lr (T, 1, h, w, 3), fv
    = hr (T, 1, 8h, 8w, 3), mk and fg (T, 1, 8h, 8w, 1)."""
    from crfp_torch.eval.zones import zone_masks_step

    rng = np.random.default_rng(seed)
    hh, hw = H * S, W * S
    yy, xx = np.mgrid[0:hh, 0:hw].astype(np.float32)
    fr = rng.uniform(-0.12, 0.12, (2, 3)).astype(np.float32)
    ph = rng.uniform(0, 6.3, (3,)).astype(np.float32)
    hr = np.stack([0.5 + 0.4 * np.sin((yy[..., None] + 3.0 * t) * fr[0]
                                      + (xx[..., None] + 5.0 * t) * fr[1] + ph)
                   for t in range(T)]).astype(np.float32)
    lr = hr.reshape(T, H, S, W, S, 3).mean((2, 4))
    zones = [zone_masks_step(hh, hw, (hh / 2 + 20 * rng.standard_normal(),
                                      hw / 2 + 30 * rng.standard_normal()),
                             32, regional_dcn=True, dcn_size=96) for _ in range(T)]
    mk = np.stack([z.mask for z in zones])
    fg = np.stack([z.fg for z in zones])
    return lr[:, None], (hr * mk)[:, None], mk[:, None], fg[:, None]


@pytest.fixture(scope="module")
def clip():
    return _clip()


@pytest.fixture(scope="module")
def weights(clip):
    """{"random": JAX init leaves with perturbed heads, "ckpt": the trained
    checkpoint's leaves}."""
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from crfp_tpu.models.crfp import ModelConfig as JConfig
    from crfp_torch.params import load_npz

    lr, fv, mk, _ = clip
    model = JCRFP(JConfig(variant="v18", mid_channels=MID, **WIN))
    args = [jnp.asarray(a[:2].transpose(1, 0, 2, 3, 4)) for a in (lr, fv, mk)]
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *args)
    return {"random": tp.perturb_heads(tp.flat_params(params), seed=2),
            "ckpt": load_npz(CKPT)}


_jax_runners = {}


def _jax_frames(flat, clip, use_fg, **cfg):
    """Frames of the JAX StreamingRunner; one compiled runner per config."""
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from crfp_tpu.models.crfp import ModelConfig as JConfig
    from crfp_tpu.models.streaming import StreamingRunner as JRunner

    key = (use_fg, tuple(sorted(cfg.items())))
    if key not in _jax_runners:
        _jax_runners[key] = JRunner(JCRFP(JConfig(variant="v18", mid_channels=MID, **cfg)),
                                    None, use_fg=use_fg, donate=False)
    runner = _jax_runners[key]
    runner.params = tp.unflatten(flat)
    runner.clear_states()
    lr, fv, mk, fg = clip
    return [np.asarray(runner(jnp.asarray(lr[i]), jnp.asarray(fv[i]), jnp.asarray(mk[i]),
                              jnp.asarray(fg[i]) if use_fg else None))
            for i in range(T)]


def _torch_runner(flat, use_fg=False, **cfg):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.models.streaming import StreamingRunner
    from crfp_torch.params import from_jax

    model = CRFP(ModelConfig(mid_channels=MID, **cfg), device="cpu")
    model.load_state_dict(from_jax(flat), strict=True)
    return StreamingRunner(model, use_fg=use_fg)


def _torch_frames(runner, clip, use_fg):
    lr, fv, mk, fg = clip
    runner.clear_states()
    return [runner(lr[i], fv[i], mk[i], fg[i] if use_fg else None).numpy()
            for i in range(T)]


def _assert_frames(got, want, tol=1e-4):
    assert len(got) == len(want) == T >= 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, H * S, W * S, 3), (g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= tol, (i, err)


@pytest.mark.parametrize("fused", [False, True], ids=["structured", "dcn_fused"])
@pytest.mark.parametrize("use_fg", [False, True], ids=["no_fg", "fg"])
def test_streaming_matches_jax_windowed(clip, weights, use_fg, fused):
    want = _jax_frames(weights["random"], clip, use_fg, **WIN)
    got = _torch_frames(_torch_runner(weights["random"], use_fg, dcn_fused=fused, **WIN),
                        clip, use_fg)
    _assert_frames(got, want)
    if use_fg:  # the gate is seen: it changes the frames
        plain = _jax_frames(weights["random"], clip, False, **WIN)
        assert max(float(np.abs(a - b).max()) for a, b in zip(want[1:], plain[1:])) > 1e-3


def test_streaming_matches_jax_unclamped(clip, weights):
    want = _jax_frames(weights["random"], clip, False)
    got = _torch_frames(_torch_runner(weights["random"]), clip, False)
    _assert_frames(got, want)


@pytest.mark.parametrize("fused", [False, True], ids=["structured", "dcn_fused"])
def test_streaming_matches_jax_trained_checkpoint(clip, weights, fused):
    want = _jax_frames(weights["ckpt"], clip, False, **WIN)
    got = _torch_frames(_torch_runner(weights["ckpt"], dcn_fused=fused, **WIN), clip, False)
    _assert_frames(got, want)
    assert float(np.abs(want[-1] - want[0]).max()) > 1e-2  # the clip moves


def test_batch_forward_equals_streaming(clip, weights):
    runner = _torch_runner(weights["random"], dcn_fused=True, **WIN)
    frames = _torch_frames(runner, clip, False)
    lr, fv, mk, _ = clip
    with torch.no_grad():
        batch = runner.model(*(torch.from_numpy(a.transpose(1, 0, 2, 3, 4))
                               for a in (lr, fv, mk))).numpy()
    for i in range(T):
        assert float(np.abs(batch[:, i] - frames[i]).max()) <= 2e-5, i


def test_clear_states_restarts_the_clip(clip, weights):
    runner = _torch_runner(weights["random"], **WIN)
    first = _torch_frames(runner, clip, False)
    lr, fv, mk, _ = clip
    # without a reset the next call is a steady step from the old state
    carried = runner(lr[0], fv[0], mk[0]).numpy()
    assert float(np.abs(carried - first[0]).max()) > 1e-4
    runner.clear_states()
    again = runner(lr[0], fv[0], mk[0]).numpy()
    np.testing.assert_array_equal(again, first[0])
    # the runner does not record a graph
    assert not runner(lr[1], fv[1], mk[1]).requires_grad


def test_dcn_fused_needs_a_window():
    from crfp_torch.models.config import ModelConfig

    with pytest.raises(ValueError, match="dcn_window"):
        ModelConfig(dcn_fused=True)
    assert ModelConfig(dcn_fused=True, dcn_window=8).dcn_fused
