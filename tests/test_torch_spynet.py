"""SPyNet, the ``border`` warp, the batch trunk with ``flow_net="spynet"``
and the flow-warp evaluation of the port against the JAX package on the
CPU, f32, on the same numpy inputs and weights (the port's seeded init
through ``to_jax``): the border warp with samples off every edge to 1e-6;
SPyNet at an LR size that is not a multiple of 32 to 1e-5; the trunk's
forward and every gradient to 1e-4 (as tests/test_torch_train.py holds the
FNet trunk); ``flow_warp_propagation_eval`` for both flow nets at
tests/test_golden.py:14's size, PSNR to 1e-4 dB and SSIM to 1e-6."""

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


def test_border_warp_matches_jax():
    from crfp_torch.ops.warp import flow_warp
    from crfp_tpu.ops.warp import flow_warp as jflow_warp

    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 9, 13, 3)).astype(np.float32)
    # displacements of up to 20 px: samples land off every edge and corner
    flow = rng.uniform(-20, 20, (2, 9, 13, 2)).astype(np.float32)
    flow[0, 0, 0] = (-0.5, -0.5)
    flow[0, -1, -1] = (0.0, 0.0)  # exactly on the last row and column
    want = np.asarray(jflow_warp(jnp.asarray(x), jnp.asarray(flow), padding_mode="border"))
    got = flow_warp(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(flow).permute(0, 3, 1, 2), padding_mode="border")
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # zeros stays the default and differs off the frame
    zeros = flow_warp(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(flow).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert float(np.abs(zeros.numpy() - want).max()) > 0.1
    with pytest.raises(ValueError, match="padding_mode"):
        flow_warp(torch.zeros(1, 1, 2, 2), torch.zeros(1, 2, 2, 2), padding_mode="reflect")


def _spynet_leaves(seed=0):
    from crfp_torch.nn.flow import SPyNet
    from crfp_torch.nn.layers import init_parameters
    from crfp_torch.params import to_jax

    net = SPyNet()
    init_parameters(net, torch.Generator().manual_seed(seed))
    return net, to_jax(net.state_dict())


def test_spynet_matches_jax():
    """LR 40x56, resized up to 64x64 inside and the flow scaled back."""
    from crfp_tpu.nn.flow import SPyNet as JSPyNet

    net, flat = _spynet_leaves()
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(1, 2)) + rng.normal(0, 0.02, a.shape).astype(np.float32)
    want = np.asarray(jax.jit(JSPyNet().apply)(tp.unflatten(flat), jnp.asarray(a),
                                               jnp.asarray(b)))
    with torch.no_grad():
        got = net(torch.from_numpy(a).permute(0, 3, 1, 2),
                  torch.from_numpy(b).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 40, 56, 2)
    assert float(np.abs(want).max()) > 1e-3  # a flow, not zeros
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_spynet_trunk_forward_and_every_gradient_match_jax():
    """The v18 trunk with flow_net="spynet", windows 8/32, mid 16, on
    tests/test_torch_train.py's clip: the forward to 1e-4 and every leaf's
    gradient (the flow net's too) to 1e-4 of its max|ref|."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, to_jax
    from crfp_torch.train.loop import charbonnier_loss
    from crfp_tpu.models.crfp import CRFP as JCRFP

    cfg = dict(flow_net="spynet", dcn_window=8, dcn_window_hr=32)
    flat = tp.perturb_heads(to_jax(CRFP(ModelConfig(mid_channels=tt.MID, **cfg),
                                        device="cpu").state_dict()), seed=1)
    assert any(k.startswith("params/spynet/basic_module5/") for k in flat)
    batch = tt.clip_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jsr), jg = jax.jit(jax.value_and_grad(tt._jloss(JCRFP(tt.jax_cfg(**cfg))),
                                               has_aux=True))(tp.unflatten(flat), jb)

    model = CRFP(ModelConfig(mid_channels=tt.MID, remat=True, **cfg), device="cpu")
    model.load_state_dict(from_jax(flat), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    sr = model(tb["lr"], tb["fv"], tb["mk"])
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


def test_spynet_is_the_flow_group_of_the_train_step():
    """The port's param-group rule picks SPyNet's leaves by name, as
    crfp_tpu/train/loop.py:120 does."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.train.loop import _is_flow

    model = CRFP(ModelConfig(mid_channels=tt.MID, flow_net="spynet"), device="cpu")
    flow = [n for n, _ in model.named_parameters() if _is_flow(n)]
    assert len(flow) == 6 * 5 * 2 and all(n.startswith("spynet.basic_module") for n in flow)


@pytest.mark.parametrize("flow_net", ["spynet", "fnet"])
def test_flow_warp_propagation_eval_matches_jax(flow_net):
    """GOLDEN config 1 at tests/test_golden.py:14's size (t 4, h 12, w 16)."""
    from mint_golden import translating_clip

    from crfp_torch.eval.flow_warp_eval import flow_warp_propagation_eval
    from crfp_torch.params import to_jax
    from crfp_tpu.eval.flow_warp_eval import flow_warp_propagation_eval as jeval

    lrs, gts = translating_clip(t=4, h=12, w=16, seed=0)
    got = flow_warp_propagation_eval(lrs, gts, flow_net=flow_net, device="cpu",
                                     generator=torch.Generator().manual_seed(2))
    flat = {k[len("params/spynet/"):]: v
            for k, v in to_jax({f"spynet.{k}": v for k, v in got["params"].items()}).items()}
    want = jeval(lrs, gts, flow_net=flow_net, params={"params": tp.unflatten(flat)})
    assert len(got["psnr"]) == len(want["psnr"]) == 3
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0, atol=1e-6)
    assert all(np.isfinite(got["psnr"])) and all(0 < s <= 1 for s in got["ssim"])
