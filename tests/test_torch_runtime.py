"""crfp_torch CRFPRuntimeV18 vs the JAX CRFPRuntimeV18 on the CPU, f32:
one JAX-initialised weight tree (with random DCN heads and weights, moved
by crfp_torch.params.from_jax) and the same numpy clip, step0 + 2
recurrent steps, in the windowed configuration (dcn_window 8,
dcn_window_hr 32: about 40 % of the offsets exceed the window here) and
the exact one."""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

_CFGS = {
    "windowed": dict(mid_channels=16, dcn_window=8, dcn_window_hr=32),
    "exact": dict(mid_channels=16),
}


@pytest.fixture(scope="module")
def weights():
    # the window sizes do not change the parameter tree: one init serves both
    lrs, fvs = tp.clip(t=3, seed=3)
    return tp.perturb_heads(tp.jax_init(tp.jax_model(mid_channels=16), lrs, fvs),
                            seed=1)


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_runtime_matches_jax_over_three_frames(name, weights):
    cfg = _CFGS[name]
    lrs, fvs = tp.clip(t=3, seed=3)
    want = tp.jax_frames(tp.jax_model(**cfg), weights, lrs, fvs)
    got = tp.torch_frames(tp.torch_model(weights, **cfg), lrs, fvs)
    assert len(got) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, 128, 192, 3), (g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= 1e-4, (name, i, err)


def test_runtime_state_and_entry_layouts():
    """NHWC in and out, as the JAX model; state at the ROI sizes."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18

    lrs, fvs = tp.clip(t=2, seed=4)
    model = CRFPRuntimeV18(ModelConfig(mid_channels=16, dcn_window=8,
                                       dcn_window_hr=32),
                           warp_size=tp.WARP, device="cpu")
    with torch.no_grad():
        lr, fv = torch.from_numpy(lrs[0]), torch.from_numpy(fvs[0])
        x_lr, x_hr = model.encode(lr, fv)
        assert x_lr.shape == (1, 16, 24, 16) and x_hr.shape == (1, 32, 32, 2)
        state, out = model.step0(lr, x_lr, x_hr)
        assert out.shape == (1, 128, 192, 3)
        assert state["hr"].shape == (1, 64, 64, 2)
        assert [f.shape for f in state["lv"]] == [(1, 16, 16, 4)] * 3
        state, out = model.step(state, torch.from_numpy(lrs[1]), lr, x_lr, x_hr)
        assert out.shape == (1, 128, 192, 3)
        assert bool(torch.isfinite(out).all())


def test_runtime_init_is_seeded():
    """Parameters come from the seeded generator: same seed, same weights;
    another seed, other weights; DCN weights start at the identity."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18

    cfg = ModelConfig(mid_channels=16)
    a, b, c = (CRFPRuntimeV18(cfg, warp_size=tp.WARP, device="cpu", seed=s)
               for s in (0, 0, 1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["spynet.encoder1_conv1.conv.weight"],
                           sc["spynet.encoder1_conv1.conv.weight"])
    w = sa["dcn_0.dcn_weight"]
    assert torch.equal(w[:, :, 1, 1], torch.eye(16)) and float(w.abs().sum()) == 16.0
    assert float(sa["dcn_0.dcn_offset.conv.weight"].abs().sum()) == 0.0
