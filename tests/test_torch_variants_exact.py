"""Every variant of the port's batch CRFP trunk against the JAX CRFP on the
CPU, unclamped (``dcn_window`` None: the exact DCNs and warps on both
sides), on the clip and weights of ``test_torch_variants.py``, to 1e-4;
and the port's parameter tree of each variant equal to the JAX trunk's."""

import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import test_torch_train as tt  # noqa: E402
import torch_parity as tp  # noqa: E402
from test_torch_variants import CASES, _IDS, jax_model, leaves, torch_model  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    return tt.clip_batch()


@pytest.mark.parametrize("case", CASES, ids=_IDS)
def test_forward_unclamped_matches_jax(case, batch):
    """dcn_window None: the exact DCNs and warps on both sides."""
    _, fields = case
    flat = leaves(case)
    args = [batch[k] for k in ("lr", "fv", "mk")]
    want = jax.jit(jax_model(fields).apply)(tp.unflatten(flat), *map(jnp.asarray, args))
    with torch.no_grad():
        got = torch_model(flat, fields)(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=_IDS)
def test_parameter_tree_is_the_jax_tree(case, batch):
    """The port's tree is the JAX trunk's: every leaf of its ``init`` (traced,
    not compiled) with its shape, and no other."""
    _, fields = case
    args = [jnp.asarray(batch[k]) for k in ("lr", "fv", "mk")]
    shapes = jax.eval_shape(jax_model(fields).init, jax.random.PRNGKey(0), *args)
    want = {k: tuple(v.shape) for k, v in
            flax.traverse_util.flatten_dict(shapes, sep="/").items()}
    assert {k: v.shape for k, v in leaves(case).items()} == want
