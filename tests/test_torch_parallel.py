"""Data parallelism of the port (crfp_torch.parallel.sharding and the
data-parallel train step) on the CPU, in gloo ranks spawned on localhost
(tests/torch_dist.py), against the JAX package's meshed step.

- Bring-up: ``initialize_distributed()`` is a no-op returning False without
  the environment (as tests/test_spatial.py holds for JAX); two ranks
  initialise, all-reduce, see world 2 and a 2-rank ``data`` mesh.
- The train step, 2 f32 steps of v18 mid 8, B 2, T 2, h 8 on the batch of
  tests/test_distributed.py's two-process case: two port ranks against
  JAX's ``make_train_step(model, tcfg, data_parallel_mesh(2))`` on the
  conftest's virtual devices, from the same weights (``params.from_jax``),
  loss, PSNR and SSIM (RGB and luma) to 1e-5 relative, as
  tests/test_torch_train_step.py holds the unsharded step; against the
  one-process port step, the JAX test's bounds: first-step gradient norm
  2e-4, losses 1e-4 and parameter delta 2e-4 relative; the two ranks'
  parameters bit-equal.
- ``shard_batch`` raises on a batch the world does not divide, as JAX's
  ``device_put`` does.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist as td  # noqa: E402
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

MID, B, T, H, S = 8, 2, 2, 8, 8
_TCFG = dict(periods=(10,), flow_freeze_iters=0)


def test_initialize_distributed_single_process_noop():
    from crfp_torch.parallel import initialize_distributed

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        assert not os.environ.get(k), f"test assumes {k} unset"
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_two_ranks_bring_up_and_all_reduce(tmp_path):
    out = td.run_ranks(td.bringup, 2, tmp_path)
    for rank, o in enumerate(out):
        assert o["world"] == 2 and o["rank"] == rank and o["mesh_rank"] == rank
        assert o["sum"] == 3.0 and o["again"] is True
        assert o["mesh"] == (2, ("data",)) and o["global"] == (2, ("data",))


@pytest.fixture(scope="module")
def case():
    """(host batch, JAX init leaves) of tests/test_distributed.py's case."""
    from crfp_tpu.models.crfp import CRFP, ModelConfig

    rng = np.random.default_rng(7)
    host = {
        "lr": rng.uniform(0, 1, (B, T, H, H, 3)).astype(np.float32),
        "hr": rng.uniform(0, 1, (B, T, H * S, H * S, 3)).astype(np.float32),
        "mk": np.zeros((B, T, H * S, H * S, 1), np.float32),
    }
    host["mk"][:, :, 16:48, 16:48] = 1.0
    host["fv"] = host["hr"]
    model = CRFP(ModelConfig(variant="v18", mid_channels=MID))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *(
        jnp.asarray(host[k][:1]) for k in ("lr", "fv", "mk")))
    return host, tp.flat_params(params)


@pytest.fixture(scope="module")
def two_ranks(case, tmp_path_factory):
    host, flat = case
    return td.run_ranks(td.train_steps, 2, tmp_path_factory.mktemp("dp"), flat, host, 2,
                        MID, _TCFG)


def test_two_rank_train_step_matches_jax_meshed_step(case, two_ranks):
    from crfp_tpu.models.crfp import CRFP, ModelConfig
    from crfp_tpu.parallel import data_parallel_mesh
    from crfp_tpu.train.loop import TrainConfig, TrainState, make_optimizer, make_train_step

    host, flat = case
    model = CRFP(ModelConfig(variant="v18", mid_channels=MID))
    cfg = TrainConfig(**_TCFG)
    tx = make_optimizer(cfg)
    params = tp.unflatten({k: np.array(v) for k, v in flat.items()})
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), tx=tx)
    mesh = data_parallel_mesh(2)
    step = make_train_step(model, cfg, mesh)
    from crfp_tpu.parallel import shard_batch

    want = []
    for _ in range(2):
        state, m = step(state, shard_batch({k: jnp.asarray(v) for k, v in host.items()},
                                           mesh))
        want.append({k: float(v) for k, v in m.items()})
    for rank, out in enumerate(two_ranks):
        for i, (g, w) in enumerate(zip(out["metrics"], want)):
            for k in ("loss", "psnr", "ssim", "psnr_y", "ssim_y"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           err_msg=f"rank {rank} step {i} {k}")


def test_two_rank_train_step_matches_one_process(case, two_ranks):
    host, flat = case
    one = td.train_steps(0, 1, flat, host, 2, MID, _TCFG)
    p0 = flat
    ref_d = np.sqrt(sum(float(np.sum((one["params"][k].astype(np.float64) - p0[k]) ** 2))
                        for k in p0))
    for rank, out in enumerate(two_ranks):
        assert abs(out["gnorm"] - one["gnorm"]) <= 2e-4 * one["gnorm"], (
            rank, out["gnorm"], one["gnorm"])
        for i in range(2):
            g, w = out["metrics"][i]["loss"], one["metrics"][i]["loss"]
            assert abs(g - w) <= 1e-4 * w, (rank, i, g, w)
        d = np.sqrt(sum(float(np.sum((out["params"][k].astype(np.float64) - p0[k]) ** 2))
                        for k in p0))
        assert abs(d - ref_d) <= 2e-4 * ref_d, (rank, d, ref_d)
    a, b = (o["params"] for o in two_ranks)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_shard_batch_refuses_an_uneven_batch(tmp_path):
    batch = {"lr": np.zeros((3, 2, 4, 4, 3), np.float32)}
    out = td.run_ranks(td.uneven_batch, 2, tmp_path, batch)
    assert all(o and "does not divide evenly over 2 ranks" in o for o in out), out
