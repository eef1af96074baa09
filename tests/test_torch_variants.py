"""Every variant of the port's batch CRFP trunk against the JAX CRFP on the
CPU, f32, on the same numpy clip and weights (mid 16, T 3, LR 8x8, B 1,
random offset/mask heads and DCN weights): v13 and v15 with ``hr_dcn`` on
and off, v18_cra, no_dcn, basic_fvsr and v18 with ``y_only``. The clip
forward with windows 8/32 and every parameter's gradient of the
Charbonnier loss (remat on the port's side), each to 1e-4 (a gradient to
1e-4 of its leaf's max|ref|). The new modules alone (``LTESimpleHR``,
``LTESimpleHRPS``, ``PlainAlign``) to 1e-5, and the config's rules, which
are the JAX trunk's asserts. The unclamped forwards and the parameter
trees are in ``test_torch_variants_exact.py``, so that the two files'
JAX compiles run on two workers."""

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

MID = tt.MID
WIN = dict(dcn_window=8, dcn_window_hr=32)
# (id, ModelConfig fields): every variant of the trunk beside v18's own tests
CASES = [
    ("v13", dict(variant="v13")),
    ("v13_lr_dcn", dict(variant="v13", hr_dcn=False)),
    ("v15", dict(variant="v15")),
    ("v15_lr_dcn", dict(variant="v15", hr_dcn=False)),
    ("v18_cra", dict(variant="v18_cra")),
    ("no_dcn", dict(variant="no_dcn", hr_dcn=False)),
    ("basic_fvsr", dict(variant="basic_fvsr", hr_dcn=False)),
    ("v18_y_only", dict(variant="v18", y_only=True)),
]
_IDS = [c[0] for c in CASES]


def jax_model(fields, **kw):
    from crfp_tpu.models.crfp import CRFP, ModelConfig

    return CRFP(ModelConfig(mid_channels=MID, **fields, **kw))


def torch_model(flat, fields, **kw):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax

    model = CRFP(ModelConfig(mid_channels=MID, **fields, **kw), device="cpu")
    model.load_state_dict(from_jax(flat), strict=True)
    return model


_LEAVES: dict[str, dict[str, np.ndarray]] = {}


def leaves(case) -> dict[str, np.ndarray]:
    """Flat JAX-format leaves of the variant: the port's seeded init
    through ``to_jax`` (the tree is the JAX trunk's,
    ``test_parameter_tree_is_the_jax_tree``), with random offset/mask heads
    and DCN weights (the init's zero heads would hide the DCN). Built once
    a case: a JAX ``init`` would compile the whole trunk again."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import to_jax

    name, fields = case
    if name not in _LEAVES:
        model = CRFP(ModelConfig(mid_channels=MID, **fields), device="cpu", seed=0)
        _LEAVES[name] = tp.perturb_heads(to_jax(model.state_dict()), seed=1)
    return _LEAVES[name]


def target(batch, fields):
    """The loss's target: the HR frames, their first channel for y_only."""
    return batch["hr"][..., :1] if fields.get("y_only") else batch["hr"]


@pytest.fixture(scope="module")
def batch():
    return tt.clip_batch()


@pytest.mark.parametrize("case", CASES, ids=_IDS)
def test_forward_and_every_gradient_match_jax(case, batch):
    """Windows 8/32: the forward to 1e-4 and every leaf's gradient of the
    Charbonnier loss to 1e-4 of its max|ref|. A leaf that no output reads
    (basic_fvsr's ``conv_lv2``/``conv_lv3``, which the port does not run)
    has gradient 0 in JAX and none in the port."""
    from crfp_tpu.train.loop import charbonnier_loss as jcharb
    from crfp_torch.params import to_jax
    from crfp_torch.train.loop import charbonnier_loss

    _, fields = case
    flat = leaves(case)
    jm = jax_model(fields, **WIN)
    hr = target(batch, fields)

    def jloss(params, b):
        sr = jm.apply(params, b["lr"], b["fv"], b["mk"])
        return jcharb(sr, b["hr"]), sr

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["hr"] = jnp.asarray(hr)
    (jl, jsr), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(tp.unflatten(flat), jb)

    model = torch_model(flat, fields, remat=True, **WIN)
    sr = model(*(torch.from_numpy(batch[k]) for k in ("lr", "fv", "mk")))
    assert sr.shape == jsr.shape == (tt.B, tt.T, 8 * tt.LR, 8 * tt.LR,
                                     1 if fields.get("y_only") else 3)
    np.testing.assert_allclose(sr.detach().numpy(), np.asarray(jsr), rtol=0, atol=1e-4)
    loss = charbonnier_loss(sr, torch.from_numpy(hr))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    got = to_jax({n: p.grad if p.grad is not None else torch.zeros_like(p)
                  for n, p in model.named_parameters()})
    want = tp.flat_params(jg)
    assert sorted(got) == sorted(want) and len(want) == len(flat)
    unread = {n for n, p in model.named_parameters() if p.grad is None}
    assert unread == ({f"encoder_hr.conv_lv{i}.conv.{k}" for i in (2, 3)
                       for k in ("weight", "bias")}
                      if fields["variant"] == "basic_fvsr" else set())
    bad = {}
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        if not err <= 1e-4 * float(np.abs(w).max()):
            bad[k] = (err, float(np.abs(w).max()))
    assert not bad, bad


def _module_pair(jmod, tmod_cls, x: np.ndarray, seed: int = 0, **tkw):
    """(JAX outputs, port outputs) of a module on the same NCHW input and
    the JAX module's random init."""
    from crfp_torch.params import from_jax

    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    params = jmod.init(jax.random.PRNGKey(seed), xj)
    want = jmod.apply(params, xj)
    tmod = tmod_cls(**tkw)
    tmod.load_state_dict(from_jax(tp.flat_params(params)), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return [np.asarray(w).transpose(0, 3, 1, 2) for w in want], [g.numpy() for g in got]


def _assert_outputs(got, want, shapes):
    assert [g.shape for g in got] == shapes
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_lte_simple_hr_matches_jax():
    """All three levels, at even and odd sizes."""
    from crfp_tpu.nn.lte import LTESimpleHR as J
    from crfp_torch.nn.lte import LTESimpleHR as T

    x = np.random.default_rng(0).uniform(0, 1, (2, 6, 36, 44)).astype(np.float32)
    want, got = _module_pair(J(MID), T, x, mid_channels=MID)
    _assert_outputs(got, want, [(2, MID, 9, 11), (2, MID, 18, 22), (2, MID, 36, 44)])
    # odd sizes: VALID 2x2 pooling drops the last row and column
    x = np.random.default_rng(1).uniform(0, 1, (1, 6, 37, 43)).astype(np.float32)
    want, got = _module_pair(J(MID), T, x, seed=1, mid_channels=MID)
    _assert_outputs(got, want, [(1, MID, 9, 10), (1, MID, 18, 21), (1, MID, 37, 43)])


def test_lte_simple_hr_lv1_alone_equals_its_level():
    from crfp_torch.nn.lte import LTESimpleHR

    torch.manual_seed(0)
    enc = LTESimpleHR(MID)
    x = torch.rand(2, 6, 32, 48)
    with torch.no_grad():
        assert torch.equal(enc.forward_lv1(x), enc(x)[0])


def test_lte_simple_hr_ps_matches_jax():
    from crfp_tpu.nn.lte import LTESimpleHRPS as J
    from crfp_torch.nn.lte import LTESimpleHRPS as T

    last = MID // 8
    x = np.random.default_rng(2).uniform(0, 1, (2, 6, 32, 48)).astype(np.float32)
    want, got = _module_pair(J(last), T, x, mid_channels=last)
    quarter = (2, 4 * last, 8, 12)
    _assert_outputs(got, want, [quarter, quarter, quarter, (2, last, 32, 48)])


def test_plain_align_matches_jax():
    from crfp_tpu.nn.align import PlainAlign as J
    from crfp_torch.nn.align import PlainAlign as T

    x = np.random.default_rng(3).normal(0, 1, (2, 2 * MID + 2, 12, 20)).astype(np.float32)
    want, got = _module_pair(J(MID), T, x, mid_channels=MID)
    _assert_outputs(got, want, [(2, MID, 12, 20)])


def test_config_rules_are_the_jax_asserts():
    """crfp_tpu/models/crfp.py:162-187: the DSV trunk needs hr_dcn, no_dcn
    and basic_fvsr refuse it, and the variant is one of six."""
    from crfp_tpu.models.crfp import VARIANTS as JVARIANTS
    from crfp_torch.models.config import VARIANTS, ModelConfig

    assert VARIANTS == JVARIANTS
    for v in ("v18", "v18_cra"):
        assert ModelConfig(variant=v).is_dsv
        with pytest.raises(ValueError, match="hr_dcn"):
            ModelConfig(variant=v, hr_dcn=False)
    for v in ("no_dcn", "basic_fvsr"):
        with pytest.raises(ValueError, match="hr_dcn=False"):
            ModelConfig(variant=v)
        assert not ModelConfig(variant=v, hr_dcn=False).is_dsv
    for v in ("v13", "v15"):
        assert not ModelConfig(variant=v, hr_dcn=False).is_dsv
        assert ModelConfig(variant=v).hr_dcn
    with pytest.raises(ValueError, match="variant"):
        ModelConfig(variant="v17")
