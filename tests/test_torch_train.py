"""The port's batch CRFP trunk (v18) against the JAX CRFP on the CPU, f32,
on the same numpy clip and weights (mid 16, T 3, LR 8x8, B 1, random
offset/mask heads and DCN weights): the clip forward with windows 8/32
and unclamped, to 1e-4; every parameter's gradient of the Charbonnier
loss, to 1e-4 of the leaf's max|ref|, with remat on the port's side. Also
the strict load of the trained checkpoint, the config's rules (the JAX
trunk's asserts) and the port's copies of the data modules."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

MID, T, B, LR = 16, 3, 1, 8


def clip_batch(seed: int = 0, b: int = B, t: int = T, h: int = LR):
    """A numpy batch of the recipe's form: HR frames, LR their box means,
    fv the HR frames, Nanascan masks of (4h)^2 patches."""
    from crfp_torch.data.fovea import fovea_generator

    rng = np.random.default_rng(seed)
    # a smooth clip: offsets are 10*tanh of conv features, so white noise
    # would turn f32 rounding in the features into ~1e-5 output differences
    yy, xx = np.mgrid[0:8 * h, 0:8 * h].astype(np.float32)
    fr = rng.uniform(-0.15, 0.15, (b, t, 2, 3)).astype(np.float32)
    ph = rng.uniform(0, 6.3, (b, t, 3)).astype(np.float32)
    hr = 0.5 + 0.4 * np.sin(yy[None, None, :, :, None] * fr[:, :, None, None, 0]
                            + xx[None, None, :, :, None] * fr[:, :, None, None, 1]
                            + ph[:, :, None, None])
    hr = hr.astype(np.float32)
    lr = hr.reshape(b, t, h, 8, h, 8, 3).mean((3, 5))
    mk = np.stack([fovea_generator(hr[i], method="Nanascan", fv_hw=(4 * h, 4 * h),
                                   rng=rng)[1] for i in range(b)])
    return {"lr": lr, "fv": hr, "hr": hr, "mk": mk}


def jax_cfg(**kw):
    from crfp_tpu.models.crfp import ModelConfig

    return ModelConfig(variant="v18", mid_channels=MID, **kw)


@pytest.fixture(scope="module")
def setup():
    """(batch, JAX init leaves with perturbed heads)."""
    from crfp_tpu.models.crfp import CRFP as JCRFP

    batch = clip_batch()
    model = JCRFP(jax_cfg(dcn_window=8, dcn_window_hr=32))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *(jnp.asarray(batch[k])
                                                         for k in ("lr", "fv", "mk")))
    return batch, tp.perturb_heads(tp.flat_params(params), seed=1)


def torch_crfp(flat, **cfg):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax

    model = CRFP(ModelConfig(mid_channels=MID, **cfg), device="cpu")
    model.load_state_dict(from_jax(flat), strict=True)
    return model


def _jloss(model):
    from crfp_tpu.train.loop import charbonnier_loss

    def loss(params, batch):
        sr = model.apply(params, batch["lr"], batch["fv"], batch["mk"])
        return charbonnier_loss(sr, batch["hr"]), sr

    return loss


def test_trunk_forward_and_every_gradient_match_jax(setup):
    """Windows 8/32: the forward to 1e-4 and every leaf's gradient of the
    Charbonnier loss to 1e-4 of its max|ref| (one JAX compile for both).
    Batch 1: a bias gradient of the 8x frames sums B*T*64*64 terms of
    +-1/N, and both packages' f32 sums drift by ~1e-4 of it at batch 2."""
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from crfp_torch.params import to_jax
    from crfp_torch.train.loop import charbonnier_loss

    batch, flat = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jsr), jg = jax.jit(jax.value_and_grad(_jloss(JCRFP(jax_cfg(
        dcn_window=8, dcn_window_hr=32))), has_aux=True))(tp.unflatten(flat), jb)

    model = torch_crfp(flat, dcn_window=8, dcn_window_hr=32, remat=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    sr = model(tb["lr"], tb["fv"], tb["mk"])
    assert sr.shape == (B, T, 8 * LR, 8 * LR, 3)
    np.testing.assert_allclose(sr.detach().numpy(), np.asarray(jsr), rtol=0, atol=1e-4)
    loss = charbonnier_loss(sr, tb["hr"])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    got = to_jax({n: p.grad for n, p in model.named_parameters()})
    want = tp.flat_params(jg)
    assert sorted(got) == sorted(want) and len(want) == len(flat)
    bad = {}
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        if not err <= 1e-4 * float(np.abs(w).max()):
            bad[k] = (err, float(np.abs(w).max()))
    assert not bad, bad


def test_trunk_forward_unclamped_matches_jax(setup):
    """dcn_window None: the exact DCNs and warps on both sides."""
    from crfp_tpu.models.crfp import CRFP as JCRFP

    batch, flat = setup
    jm = JCRFP(jax_cfg())
    want = jax.jit(jm.apply)(tp.unflatten(flat),
                             *(jnp.asarray(batch[k]) for k in ("lr", "fv", "mk")))
    model = torch_crfp(flat)
    with torch.no_grad():
        got = model(*(torch.from_numpy(batch[k]) for k in ("lr", "fv", "mk")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_trained_checkpoint_loads_strictly():
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, load_npz

    flat = load_npz("checkpoints/v18_mid32_struct.npz")
    model = CRFP(ModelConfig(mid_channels=32, dcn_window=8, dcn_window_hr=32, remat=True),
                 device="cpu")
    assert len(model.state_dict()) == len(flat) == 118
    model.load_state_dict(from_jax(flat), strict=True)


def test_config_rules():
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.nn.flow import SPyNet

    # flow_net="spynet" builds the trunk around SPyNet (crfp_tpu/models/crfp.py:191)
    model = CRFP(ModelConfig(flow_net="spynet", mid_channels=MID), device="cpu")
    assert isinstance(model.spynet, SPyNet)
    with pytest.raises(ValueError):
        ModelConfig(flow_net="raft")
    # the JAX trunk's asserts (crfp_tpu/models/crfp.py:162-187)
    with pytest.raises(ValueError, match="hr_dcn"):
        CRFP(ModelConfig(variant="v18", hr_dcn=False, mid_channels=MID), device="cpu")
    with pytest.raises(ValueError, match="hr_dcn=False"):
        CRFP(ModelConfig(variant="basic_fvsr", mid_channels=MID), device="cpu")
    with pytest.raises(ValueError, match="variant"):
        CRFP(ModelConfig(variant="v19", mid_channels=MID), device="cpu")


@pytest.mark.parametrize("method", ["Nanascan", "Rscan", "Cscan", "Zscan", "Evenscan"])
def test_fovea_generator_copy_equals_jax(method):
    from crfp_tpu.data.fovea import fovea_generator as jgen
    from crfp_torch.data.fovea import fovea_generator as tgen

    for seed in (0, 1, 2):
        gt = np.random.default_rng(seed).uniform(0, 1, (5, 96, 128, 3)).astype(np.float32)
        kw = dict(method=method, fv_hw=(32, 48))
        want = jgen(gt, rng=np.random.default_rng(seed), **kw)
        got = tgen(gt, rng=np.random.default_rng(seed), **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_procedural_clip_copy_equals_jax():
    from crfp_tpu.data.procedural import make_clip as jclip
    from crfp_torch.data.procedural import make_clip as tclip

    want = jclip(np.random.default_rng(3), 2, 48)
    got = tclip(np.random.default_rng(3), 2, 48)
    assert got.shape == (2, 48, 48, 3)
    np.testing.assert_array_equal(got, want)
