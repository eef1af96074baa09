"""crfp_torch.params against the JAX package: the trained checkpoint
checkpoints/v18_mid32_struct.npz through both packages'
runtime_params_from_batch, leaf for leaf, and 3 frames of the slice at
mid 32 on the CPU (f32, tiny frame) under the adapted weights; to_jax as
the exact inverse of from_jax, and a save_npz checkpoint that the JAX
package loads and applies."""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

CKPT = "checkpoints/v18_mid32_struct.npz"
_CFG = dict(mid_channels=32, dcn_window=8, dcn_window_hr=32)
# the runtime leaves a batch checkpoint cannot supply (tests/test_runtime_model.py)
_UNMAPPED = [
    "forward_resblocks_0_.input_conv.conv.weight",
    "forward_resblocks_1_.input_conv.conv.weight",
    "forward_resblocks_2_.input_conv.conv.weight",
    "forward_resblocks_3.conv2.conv.weight",
    "forward_resblocks_3_.input_conv.conv.weight",
]


def test_from_jax_gives_every_leaf_its_exact_value():
    from crfp_torch.params import from_jax, load_npz

    flat = load_npz(CKPT)
    assert len(flat) == 118
    sd = from_jax(flat)
    assert len(sd) == len(flat)
    for k, v in flat.items():
        parts = k.split("/")[1:]
        if parts[-1] == "kernel":
            t = sd[".".join(parts[:-1] + ["weight"])]
            np.testing.assert_array_equal(t.numpy().transpose(2, 3, 1, 0), v)
        elif parts[-1] == "dcn_weight":
            np.testing.assert_array_equal(sd[".".join(parts)].numpy()
                                          .transpose(2, 3, 1, 0), v)
        else:
            np.testing.assert_array_equal(sd[".".join(parts)].numpy(), v)
    assert sum(t.numel() for t in sd.values()) == sum(v.size for v in flat.values())


@pytest.fixture(scope="module")
def adapted():
    """(JAX model, JAX adapted leaves, port adapted state, port model,
    the two unmapped counts)."""
    from crfp_tpu.models.runtime import runtime_params_from_batch as jax_adapt
    from crfp_tpu.utils.params_io import load_params
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18
    from crfp_torch.params import from_jax, load_npz, runtime_params_from_batch

    lrs, fvs = tp.clip(t=1, seed=0)
    jm = tp.jax_model(**_CFG)
    j_tree, n_j = jax_adapt(load_params(CKPT), tp.unflatten(tp.jax_init(jm, lrs, fvs)))
    model = CRFPRuntimeV18(ModelConfig(**_CFG), warp_size=tp.WARP, device="cpu")
    sd, n_t = runtime_params_from_batch(from_jax(load_npz(CKPT)), model.state_dict())
    return jm, tp.flat_params(j_tree), sd, model, n_j, n_t


def test_runtime_params_from_batch_matches_jax(adapted):
    from crfp_torch.params import from_jax

    _, j_flat, sd, model, n_j, n_t = adapted
    assert n_j == n_t == len(_UNMAPPED)
    want = from_jax(j_flat)
    assert sorted(want) == sorted(sd) == sorted(model.state_dict())
    init = model.state_dict()
    for k in sd:
        if k in _UNMAPPED:
            assert torch.equal(sd[k], init[k]), k  # kept from the seeded init
        else:
            assert torch.equal(sd[k], want[k]), k


def test_trained_weights_three_frames_match_jax(adapted):
    from crfp_torch.params import from_jax

    jm, j_flat, sd, model, _, _ = adapted
    # the unmapped cold-start leaves are copied from the JAX init
    j_sd = from_jax(j_flat)
    model.load_state_dict({k: (j_sd[k] if k in _UNMAPPED else v)
                           for k, v in sd.items()}, strict=True)
    lrs, fvs = tp.clip(t=3, seed=8)
    want = tp.jax_frames(jm, j_flat, lrs, fvs)
    got = tp.torch_frames(model.eval(), lrs, fvs)
    for i, (g, w) in enumerate(zip(got, want)):
        err = float(np.abs(g - w).max())
        assert err <= 1e-4, (i, err)


def test_to_jax_inverts_from_jax_exactly():
    from crfp_torch.params import from_jax, load_npz, to_jax

    flat = load_npz(CKPT)
    back = to_jax(from_jax(flat))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)


def test_save_npz_loads_in_the_jax_package(tmp_path):
    """A checkpoint the port writes loads through the JAX package's loader,
    and the JAX CRFP applies it to the port's output (f32, CPU)."""
    import jax
    import jax.numpy as jnp

    from crfp_tpu.models.crfp import CRFP as JCRFP
    from crfp_tpu.models.crfp import ModelConfig as JConfig
    from crfp_tpu.utils.params_io import load_params
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import save_npz

    model = CRFP(ModelConfig(mid_channels=16), device="cpu", seed=3)
    path = str(tmp_path / "port.npz")
    save_npz(model.state_dict(), path)
    rng = np.random.default_rng(9)
    lr = rng.uniform(0, 1, (1, 2, 8, 8, 3)).astype(np.float32)
    fv = rng.uniform(0, 1, (1, 2, 64, 64, 3)).astype(np.float32)
    mk = np.zeros((1, 2, 64, 64, 1), np.float32)
    mk[:, :, 8:40, 16:48] = 1.0
    want = jax.jit(JCRFP(JConfig(variant="v18", mid_channels=16)).apply)(
        load_params(path), jnp.asarray(lr), jnp.asarray(fv), jnp.asarray(mk))
    with torch.no_grad():
        got = model(torch.from_numpy(lr), torch.from_numpy(fv), torch.from_numpy(mk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
