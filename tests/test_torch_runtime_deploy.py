"""crfp_torch CRFPRuntimeV18 vs the JAX model with the deployment flags of
bench.py's _DEPLOY (hr_s2d, dcn_anchor, emit_s2d; windows 8/32), in f32 on
the CPU. ``hr_s2d`` and ``emit_s2d`` are TPU layouts of the same math, so
the s2d frames JAX returns, depth-to-spaced, are the port's frames;
``dcn_anchor`` is math. Off the TPU the JAX dispatch drops ``anchor`` and
computes the plain clamp, so the JAX side runs here with its dispatch
routed to the anchored Pallas kernels in interpret mode
(``torch_parity.anchored_jax_dispatch``), and the HR flow is pushed past
±dcn_window_hr (``torch_parity.set_flow_bias``): the port's anchored
frames match, its plain-clamp frames do not. Also the one-channel
``y_only`` configuration.

A file of its own so that pytest-xdist (--dist loadfile) runs it beside
test_torch_runtime.py."""

import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

_WINDOWS = dict(mid_channels=16, dcn_window=8, dcn_window_hr=32)


def test_runtime_matches_jax_deploy_layout(monkeypatch):
    from crfp_tpu.ops.shuffle import pixel_shuffle

    tp.anchored_jax_dispatch(monkeypatch)
    lrs, fvs = tp.clip(t=3, seed=5)
    # the layout flags leave the parameter tree unchanged: init the logical
    # model, run the deployment-layout one. The flow net moves the HR state
    # by about (37, -42) px, past the window of 32
    weights = tp.perturb_heads(tp.jax_init(tp.jax_model(**_WINDOWS), lrs, fvs), seed=2)
    weights = tp.set_flow_bias(weights, dy=4.6, dx=-5.3)
    deploy = tp.jax_model(**_WINDOWS, hr_s2d=True, dcn_anchor=True, emit_s2d=True)
    want = [np.asarray(pixel_shuffle(jnp.asarray(y), 4))
            for y in tp.jax_frames(deploy, weights, lrs, fvs)]
    got = tp.torch_frames(tp.torch_model(weights, **_WINDOWS, hr_s2d=True, dcn_anchor=True),
                          lrs, fvs)
    clamp = tp.torch_frames(tp.torch_model(weights, **_WINDOWS), lrs, fvs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, 128, 192, 3), (g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= 1e-4, (i, err)
    # the steady frames: anchoring is seen
    assert min(float(np.abs(c - w).max()) for c, w in zip(clamp[1:], want[1:])) > 1e-3


def test_runtime_y_only_matches_jax():
    """ModelConfig.y_only: one-channel LR, fovea and output frames."""
    cfg = dict(_WINDOWS, y_only=True)
    lrs, fvs = tp.clip(t=3, seed=6)
    lrs, fvs = lrs[..., :1].copy(), fvs[..., :1].copy()
    jm = tp.jax_model(**cfg)
    weights = tp.perturb_heads(tp.jax_init(jm, lrs, fvs), seed=4)
    want = tp.jax_frames(jm, weights, lrs, fvs)
    got = tp.torch_frames(tp.torch_model(weights, **cfg), lrs, fvs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, 128, 192, 1), (g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= 1e-4, (i, err)
