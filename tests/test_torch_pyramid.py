"""The gen-1 pyramids of the port against the JAX package on the CPU, f32,
on the same numpy clip and weights, at tests/test_pyramid_parity.py:340's
size (mid 16, dg 16, t 3, LR 8x8): ``CRFPPyramidX8`` and ``CRFPPyramidX4``
with ``cra`` both ways, unclamped and with ``dcn_window=8``, to 1e-4;
``PyramidLevelAlign`` alone; ``LTESimpleHRV1`` / ``LTESimpleHRX8`` to 1e-5;
``PCDAlign`` at tests/test_pcd.py's sizes to 1e-4; the parameter trees
against the JAX inits (traced, not compiled) and a ``from_jax`` ->
``to_jax`` round trip of the pyramid tree, key for key and bit for bit.
Weights: the port's seeded init through ``to_jax``, the offset heads'
random weights shrunk x0.05 as the JAX test shrinks them, random mask heads
and DCN weights."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

M, DG, T, H = 16, 16, 3, 8
CASES = [("x8", False), ("x8", True), ("x4", False), ("x4", True)]
_IDS = [f"{k}{'_cra' if c else ''}" for k, c in CASES]


def perturb_levels(flat, seed=1):
    """Random offset heads (x0.05 of a unit normal's scale 0.2), mask heads
    and DCN weights/biases for every pyramid level and DCNAlign."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for k, v in flat.items():
        leaf = k.split("/")
        if any(p.startswith("dcn_offset") for p in leaf):
            out[k] = rng.normal(0, 0.2 * 0.05, v.shape).astype(np.float32)
        elif any(p.startswith(("dcn_mask", "dcn_weight", "dcn_bias")) for p in leaf):
            out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
    return out


def torch_pyramid(kind, cra, **kw):
    from crfp_torch.models.pyramid import CRFPPyramidX4, CRFPPyramidX8

    cls = CRFPPyramidX8 if kind == "x8" else CRFPPyramidX4
    return cls(M, cra=cra, dg_num=DG, device="cpu", **kw).eval()


def jax_pyramid(kind, cra, **kw):
    from crfp_tpu.models.pyramid import CRFPPyramidX4, CRFPPyramidX8

    cls = CRFPPyramidX8 if kind == "x8" else CRFPPyramidX4
    return cls(mid_channels=M, cra=cra, dg_num=DG, **kw)


def clip(kind, cra, seed=3):
    """(lrs, fvs, mks) NHWC numpy: a fovea box under the mask, or the X8
    CRA's 16x16 patch and no mask."""
    s = 8 if kind == "x8" else 4
    rng = np.random.default_rng(seed)
    lrs = rng.uniform(0, 1, (1, T, H, H, 3)).astype(np.float32)
    if kind == "x8" and cra:
        return lrs, rng.uniform(0, 1, (1, T, 16, 16, 3)).astype(np.float32), None
    fvs = rng.uniform(0, 1, (1, T, s * H, s * H, 3)).astype(np.float32)
    mks = np.zeros((1, T, s * H, s * H, 1), np.float32)
    mks[:, :, s:5 * s, 2 * s:6 * s] = 1.0
    return lrs, fvs, mks


_LEAVES: dict = {}


def leaves(kind, cra):
    from crfp_torch.params import to_jax

    if (kind, cra) not in _LEAVES:
        _LEAVES[kind, cra] = perturb_levels(to_jax(torch_pyramid(kind, cra).state_dict()))
    return _LEAVES[kind, cra]


def _args(arrs, torch_side):
    arrs = [a for a in arrs if a is not None]
    return [torch.from_numpy(a) if torch_side else jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("window", [None, 8], ids=["exact", "window8"])
@pytest.mark.parametrize("case", CASES, ids=_IDS)
def test_pyramid_matches_jax(case, window):
    kind, cra = case
    flat = leaves(kind, cra)
    data = clip(kind, cra)
    jm = jax_pyramid(kind, cra, dcn_window=window)
    want = np.asarray(jax.jit(jm.apply)(tp.unflatten(flat), *_args(data, False)))
    from crfp_torch.params import from_jax

    model = torch_pyramid(kind, cra, dcn_window=window)
    model.load_state_dict(from_jax(flat), strict=True)
    got = model(*_args(data, True))  # inference only: forward records no graph
    assert not got.requires_grad
    got = got.numpy()
    s = 8 if kind == "x8" else 4
    assert got.shape == want.shape == (1, T, s * H, s * H, 3)
    err = np.abs(got - want).reshape(T, -1).max(1)
    assert float(err.max()) <= 1e-4, err


def _shapes(module, *args):
    """{flat key: shape} of a JAX module's init, traced, not compiled."""
    import flax

    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return {k: tuple(v.shape) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _jax_tree(kind, cra):
    return _shapes(jax_pyramid(kind, cra), *_args(clip(kind, cra), False))


@pytest.mark.parametrize("case", CASES, ids=_IDS)
def test_pyramid_tree_is_the_jax_tree_and_round_trips(case):
    """Key for key and shape for shape against the JAX init; from_jax then
    to_jax gives every leaf back bit for bit (dcn_weight_lv{k} transposed
    both ways, HWIO (3, 3, C, O) in the tree)."""
    from crfp_torch.params import from_jax, to_jax

    kind, cra = case
    flat = leaves(kind, cra)
    assert {k: v.shape for k, v in flat.items()} == _jax_tree(kind, cra)
    model = torch_pyramid(kind, cra)
    model.load_state_dict(from_jax(flat), strict=True)
    back = to_jax(model.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    w = from_jax(flat)["align_lv0.dcn_weight_lv0"]
    np.testing.assert_array_equal(w.numpy(), flat["params/align_lv0/dcn_weight_lv0"]
                                  .transpose(3, 2, 0, 1))


def test_pyramid_level_align_matches_jax():
    """One level alone, 4 groups, unclamped and at window 2 (both sides clamp
    there; flow of up to 3 px)."""
    from crfp_torch.models.pyramid import PyramidLevelAlign
    from crfp_torch.nn.layers import init_parameters
    from crfp_torch.params import from_jax, to_jax
    from crfp_tpu.models.pyramid import PyramidLevelAlign as JAlign

    rng = np.random.default_rng(4)
    cur, state, warped = (rng.normal(0, 1, (2, 12, 10, M)).astype(np.float32)
                          for _ in range(3))
    flow = rng.uniform(-3, 3, (2, 12, 10, 2)).astype(np.float32)
    for window in (None, 2):
        mod = PyramidLevelAlign(M, 4, 2, window=window)
        init_parameters(mod, torch.Generator().manual_seed(0))
        flat = perturb_levels(to_jax(mod.state_dict()), seed=5)
        want = np.asarray(JAlign(M, 4, 2, window=window).apply(
            tp.unflatten(flat), *(jnp.asarray(a) for a in (cur, state, warped, flow))))
        mod.load_state_dict(from_jax(flat), strict=True)
        with torch.no_grad():
            got = mod(*(torch.from_numpy(a).permute(0, 3, 1, 2)
                        for a in (cur, state, warped, flow))).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["v1", "x8"])
def test_lte_pyramids_match_jax(name):
    from crfp_torch.nn.layers import init_parameters
    from crfp_torch.nn.lte import LTESimpleHRV1, LTESimpleHRX8
    from crfp_torch.params import from_jax, to_jax
    from crfp_tpu.nn import lte as jlte

    mod = LTESimpleHRV1(M) if name == "v1" else LTESimpleHRX8()
    jmod = jlte.LTESimpleHRV1(M) if name == "v1" else jlte.LTESimpleHRX8()
    init_parameters(mod, torch.Generator().manual_seed(0))
    flat = to_jax(mod.state_dict())
    x = np.random.default_rng(6).uniform(0, 1, (1, 32, 24, 6)).astype(np.float32)
    want = jmod.apply(tp.unflatten(flat), jnp.asarray(x))
    assert _shapes(jmod, jnp.asarray(x)) == {k: v.shape for k, v in flat.items()}
    mod.load_state_dict(from_jax(flat), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == (3 if name == "v1" else 4)
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)


def test_pcd_align_matches_jax():
    """nf 16, 2 groups, 24x32, flow of up to 3 px (tests/test_pcd.py)."""
    from crfp_torch.nn.pcd import PCDAlign
    from crfp_torch.params import from_jax, to_jax
    from crfp_tpu.nn.pcd import PCDAlign as JPCD

    nf, g = 16, 2
    mod = PCDAlign(nf, g, device="cpu")
    flat = perturb_levels(to_jax(mod.state_dict()), seed=7)
    rng = np.random.default_rng(0)
    cur, pre, ali = (rng.standard_normal((1, 24, 32, nf)).astype(np.float32)
                     for _ in range(3))
    flow = rng.uniform(-3, 3, (1, 24, 32, 2)).astype(np.float32)
    args = [jnp.asarray(a) for a in (cur, pre, ali, flow)]
    jm = JPCD(nf=nf, groups=g)
    assert _shapes(jm, *args) == {k: v.shape for k, v in flat.items()}
    want = np.asarray(jax.jit(jm.apply)(tp.unflatten(flat), *args))
    mod.load_state_dict(from_jax(flat), strict=True)
    got = mod(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (cur, pre, ali, flow)))
    assert not got.requires_grad  # inference only: forward records no graph
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-4)


def test_pyramid_init_is_seeded_identity():
    a, b = (torch_pyramid("x8", False).state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["align_lv3.dcn_weight_lv3"]
    assert torch.equal(w[:, :, 1, 1], torch.eye(M)) and float(w.abs().sum()) == M
    assert float(a["align_lv0.dcn_offset_lv0.conv.weight"].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="MRCF_CRA_x8"):
        torch_pyramid("x8", True)(torch.zeros(1, 2, 8, 8, 3), torch.zeros(1, 2, 16, 16, 3),
                                  torch.zeros(1, 2, 64, 64, 1))
    with pytest.raises(ValueError, match="MRCF_CRA_x8"):
        torch_pyramid("x4", False)(torch.zeros(1, 2, 8, 8, 3), torch.zeros(1, 2, 32, 32, 3))
