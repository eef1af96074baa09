"""The port's train step (crfp_torch.train.loop) against the JAX package's
(crfp_tpu.train.loop.make_train_step) on the CPU, from identical weights
and numpy batches (mid 16, T 3, LR 8x8, B 1, windows 8/32, random
offset/mask heads): 3 f32 steps of two-group Adam with the flow net frozen
for the first step and a 4-step schedule period, whose losses agree to
1e-5 relative, whose flow parameters do not move in step 1 and agree
with JAX's after step 3; and one amp step, whose loss agrees to 2e-2
relative and whose updated parameters are nowhere more than 2 lr from
JAX's and within 0.1 lr of them for 99 % of the elements."""

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

_TCFG = dict(flow_freeze_iters=1, periods=(4,))


@pytest.fixture(scope="module")
def start():
    """(three numpy batches, JAX init leaves with perturbed heads)."""
    from crfp_tpu.models.crfp import CRFP as JCRFP

    batches = [tt.clip_batch(seed=s) for s in range(3)]
    model = JCRFP(tt.jax_cfg(dcn_window=8, dcn_window_hr=32))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *(jnp.asarray(batches[0][k])
                                                         for k in ("lr", "fv", "mk")))
    return batches, tp.perturb_heads(tp.flat_params(params), seed=1)


def _jax_steps(flat, batches, **tcfg):
    """Losses, metrics and the leaves after each step of the JAX train step."""
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from crfp_tpu.train.loop import TrainConfig, TrainState, make_optimizer, make_train_step

    model = JCRFP(tt.jax_cfg(dcn_window=8, dcn_window_hr=32))
    cfg = TrainConfig(**tcfg)
    tx = make_optimizer(cfg)
    # private copies: the jitted step donates its state, and on the CPU
    # jnp.asarray may share the numpy leaves' memory
    params = tp.unflatten({k: np.array(v) for k, v in flat.items()})
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), tx=tx)
    step = make_train_step(model, cfg)
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(({k: float(v) for k, v in m.items()}, tp.flat_params(state.params)))
    return out


def _torch_steps(flat, batches, **tcfg):
    from crfp_torch.params import to_jax
    from crfp_torch.train.loop import TrainConfig, make_optimizer, make_train_step

    model = tt.torch_crfp(flat, dcn_window=8, dcn_window_hr=32, remat=True)
    cfg = TrainConfig(**tcfg)
    opt = make_optimizer(model, cfg)
    step = make_train_step(model, cfg)
    out = []
    for i, b in enumerate(batches):
        m = step(opt, b, i)
        out.append(({k: float(v) for k, v in m.items()}, to_jax(model.state_dict())))
    return out


def test_three_adam_steps_with_flow_freeze_match_jax(start):
    batches, flat = start
    want = _jax_steps(flat, batches, **_TCFG)
    got = _torch_steps(flat, batches, **_TCFG)
    flow = [k for k in flat if "/spynet/" in k]
    trunk = [k for k in flat if "/spynet/" not in k]
    assert flow and trunk
    for i, ((gm, gp), (wm, wp)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gm["loss"], wm["loss"], rtol=1e-5, err_msg=f"step {i}")
        for k in ("psnr", "ssim", "psnr_y", "ssim_y"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, err_msg=f"step {i} {k}")
    # step 1 (frozen): the flow net does not move, the trunk does
    for k in flow:
        np.testing.assert_array_equal(got[0][1][k], flat[k])
        np.testing.assert_array_equal(want[0][1][k], flat[k])
    assert any(not np.array_equal(got[0][1][k], flat[k]) for k in trunk)
    # after step 3: every parameter where JAX's is. The first two unfrozen
    # flow updates are Adam's t=1, 2 (lr_flow at schedule(0), schedule(1));
    # a gradient near 0 whose sign differs flips a whole +-lr step, so the
    # bound is one such step per leaf element and update
    cfg_lr = {"flow": 2.5e-5, "trunk": 2e-4}
    for k in flat:
        lr = cfg_lr["flow" if k in flow else "trunk"]
        err = float(np.abs(got[2][1][k] - want[2][1][k]).max())
        assert err <= 2 * lr * 3, (k, err)
    moved = max(float(np.abs(got[2][1][k] - flat[k]).max()) for k in flow)
    assert moved > 0
    # and nearly all of it agrees far more closely than that bound
    tight = np.mean([float(np.abs(got[2][1][k] - want[2][1][k]).max()) <= 1e-6
                     for k in flat])
    assert tight >= 0.9, tight


def test_one_amp_step_matches_jax(start):
    batches, flat = start
    want = _jax_steps(flat, batches[:1], amp=True, **_TCFG)
    got = _torch_steps(flat, batches[:1], amp=True, **_TCFG)
    np.testing.assert_allclose(got[0][0]["loss"], want[0][0]["loss"], rtol=2e-2)
    flow = [k for k in flat if "/spynet/" in k]
    for k in flow:  # frozen in step 1
        np.testing.assert_array_equal(got[0][1][k], flat[k])
    # Adam's first step moves every element by ~lr * sign(gradient), so the
    # updates agree where the bf16 gradients agree in sign: nowhere more than
    # one flipped step (2 lr, plus the f32 rounding of the two updated
    # values) apart, and nearly everywhere within 0.1 lr
    lr = 2e-4
    n_close = n_all = 0
    for k in flat:
        assert np.isfinite(got[0][1][k]).all(), k
        d = np.abs(got[0][1][k] - want[0][1][k])
        limit = 2 * lr + 2 * np.spacing(np.abs(flat[k]) + lr)
        assert (d <= limit).all(), (k, float((d - limit).max()))
        n_close += int((d <= 0.1 * lr).sum())
        n_all += d.size
    assert n_close >= 0.99 * n_all, n_close / n_all
