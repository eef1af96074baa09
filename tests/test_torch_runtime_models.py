"""The port's other runtime models against the JAX package on the CPU, f32:
``CRFPRuntimeSimple`` (v13, v15) and ``CRFPRuntimeV18(nofv=True)``, through
``encode`` / ``step0`` / ``step`` over 3 frames at mid 16 (warp 64x64, LR
16x24, fovea 32: the shapes of tests/test_runtime_model.py:78), unclamped
and with windows 8/32, to 1e-4. Weights: the port's seeded init through
``to_jax`` with random offset/mask heads and DCN weights; the parameter
trees are held against the JAX init's (``jax.eval_shape``, no compile).
Also ``runtime_params_from_batch`` on both trees against the JAX function
(the same leaves and the same ``n_unmapped``)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

MID = 16
WIN = dict(dcn_window=8, dcn_window_hr=32)
# (id, variant, nofv)
MODELS = [("v13", "v13", False), ("v15", "v15", False), ("v18_nofv", "v18", True)]
_IDS = [m[0] for m in MODELS]


def jax_model(variant, nofv, **cfg):
    from crfp_tpu.models.crfp import ModelConfig
    from crfp_tpu.models.runtime import CRFPRuntimeSimple, CRFPRuntimeV18

    c = ModelConfig(variant=variant, mid_channels=MID, **cfg)
    if variant == "v18":
        return CRFPRuntimeV18(c, warp_size=tp.WARP, nofv=nofv)
    return CRFPRuntimeSimple(c, warp_size=tp.WARP)


def torch_model(variant, nofv, flat=None, **cfg):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeSimple, CRFPRuntimeV18
    from crfp_torch.params import from_jax

    c = ModelConfig(variant=variant, mid_channels=MID, **cfg)
    if variant == "v18":
        model = CRFPRuntimeV18(c, warp_size=tp.WARP, nofv=nofv, device="cpu")
    else:
        model = CRFPRuntimeSimple(c, warp_size=tp.WARP, device="cpu")
    if flat is not None:
        model.load_state_dict(from_jax(flat), strict=True)
    return model.eval()


_LEAVES: dict[str, dict[str, np.ndarray]] = {}


def leaves(case) -> dict[str, np.ndarray]:
    from crfp_torch.params import to_jax

    name, variant, nofv = case
    if name not in _LEAVES:
        _LEAVES[name] = tp.perturb_heads(to_jax(torch_model(variant, nofv).state_dict()),
                                         seed=1)
    return _LEAVES[name]


def jax_frames(model, flat, lrs, fvs, nofv):
    params = tp.unflatten(flat)
    cls = type(model)
    enc = jax.jit(lambda p, a, b: model.apply(p, a, b, method=cls.encode))
    step0 = jax.jit(lambda p, a, xl, xh: model.apply(p, a, xl, xh, method=cls.step0))
    step = jax.jit(lambda p, s, a, pa, xl, xh: model.apply(p, s, a, pa, xl, xh,
                                                           method=cls.step))
    outs, state = [], None
    for i in range(len(lrs)):
        lr, fv = jnp.asarray(lrs[i]), jnp.asarray(fvs[i])
        x_lr, x_hr = enc(params, lr, fv)
        assert (x_hr is None) == nofv
        if i == 0:
            state, out = step0(params, lr, x_lr, x_hr)
        else:
            state, out = step(params, state, lr, jnp.asarray(lrs[i - 1]), x_lr, x_hr)
        outs.append(np.asarray(out))
    return outs, state


@torch.no_grad()
def torch_frames(model, lrs, fvs, nofv):
    outs, state = [], None
    for i in range(len(lrs)):
        lr = torch.from_numpy(lrs[i])
        x_lr, x_hr = model.encode(lr, None if nofv else torch.from_numpy(fvs[i]))
        assert (x_hr is None) == nofv
        if i == 0:
            state, out = model.step0(lr, x_lr, x_hr)
        else:
            state, out = model.step(state, lr, torch.from_numpy(lrs[i - 1]), x_lr, x_hr)
        outs.append(out.numpy())
    return outs, state


@pytest.mark.parametrize("win", ["exact", "windowed"])
@pytest.mark.parametrize("case", MODELS, ids=_IDS)
def test_runtime_model_matches_jax_over_three_frames(case, win):
    _, variant, nofv = case
    cfg = WIN if win == "windowed" else {}
    flat = leaves(case)
    lrs, fvs = tp.clip(t=3, seed=5)
    want, wstate = jax_frames(jax_model(variant, nofv, **cfg), flat, lrs, fvs, nofv)
    got, gstate = torch_frames(torch_model(variant, nofv, flat, **cfg), lrs, fvs, nofv)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, 128, 192, 3), (g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= 1e-4, (case[0], win, i, err)
    assert sorted(gstate) == sorted(wstate) == (["hr", "lv"] if variant == "v18" else ["hr"])
    err = float(np.abs(gstate["hr"].numpy() - np.asarray(wstate["hr"])).max())
    assert gstate["hr"].shape == (1, *tp.WARP, MID // 8) and err <= 1e-4, err


def _jax_tree(variant, nofv):
    """{flat key: shape} of the JAX model's init, traced, not compiled."""
    import flax

    model = jax_model(variant, nofv)
    lr = jnp.zeros((1, *tp.LR_HW, 3))
    fv = jnp.zeros((1, tp.FV, tp.FV, 3))

    def run(mdl):
        x_lr, x_hr = mdl.encode(lr, fv)
        state, _ = mdl.step0(lr, x_lr, x_hr)
        mdl.step(state, lr, lr, x_lr, x_hr)

    tree = jax.eval_shape(lambda k: model.init(k, method=run), jax.random.PRNGKey(0))
    return {k: tuple(v.shape)
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.mark.parametrize("case", MODELS, ids=_IDS)
def test_parameter_tree_is_the_jax_tree(case):
    """Key for key and shape for shape; nofv has no encoder_hr or conv_tttf
    (built by the JAX setup, never called, so absent from its tree)."""
    _, variant, nofv = case
    want = _jax_tree(variant, nofv)
    got = {k: v.shape for k, v in leaves(case).items()}
    assert got == want
    has_fovea = any(k.startswith(("params/encoder_hr/", "params/conv_tttf/")) for k in got)
    assert has_fovea == (not nofv)


@pytest.mark.parametrize("case", MODELS, ids=_IDS)
def test_runtime_params_from_batch_matches_jax(case):
    """The batch trunk's leaves of the same variant onto the runtime tree:
    the port's adapter keeps the JAX adapter's leaves and counts the same
    unmapped ones."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, runtime_params_from_batch, to_jax
    from crfp_tpu.models.runtime import runtime_params_from_batch as jax_adapt

    _, variant, nofv = case
    batch = to_jax(CRFP(ModelConfig(variant=variant, mid_channels=MID), device="cpu",
                        seed=3).state_dict())
    model = torch_model(variant, nofv)
    init = model.state_dict()
    got, n_got = runtime_params_from_batch(from_jax(batch), init)
    want, n_want = jax_adapt(tp.unflatten(batch), tp.unflatten(to_jax(init)))
    want = tp.flat_params(want)
    assert n_got == n_want > 0
    got = to_jax(got)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model.load_state_dict(runtime_params_from_batch(from_jax(batch), init)[0], strict=True)


def test_simple_state_and_seeded_init():
    """CRFPRuntimeSimple: the HR state alone, NHWC at the ROI; the same seed
    gives the same weights; a variant it does not take raises."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeSimple

    a, b = (torch_model("v15", False).state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["forward_resblocks_0.conv1.conv.weight"].shape[1] == 3 * MID
    assert a["forward_resblocks_0.conv2.conv.weight"].shape[1] == MID
    with pytest.raises(ValueError, match="v13"):
        CRFPRuntimeSimple(ModelConfig(variant="v18", mid_channels=MID), device="cpu")
