"""The port's checkpoints (crfp_torch/train/checkpoint.py,
crfp_torch/utils/params_io.py) on the CPU: a run resumed from a save after
k steps equals the unbroken run bit for bit (parameters, both Adam groups'
state, the step); ``latest_step``, ``max_to_keep`` and a repeated save;
``load_params`` reads ``.npz`` and the port's step directories and
manager roots, reads ``.pt`` files through the reference's name map (a file
of the port's own names is refused; reference-named files are held in
tests/test_torch_convert.py), and raises on orbax directories."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

MID, T, B, LR = 16, 2, 1, 8


def _batches(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        hr = rng.uniform(0, 1, (B, T, 8 * LR, 8 * LR, 3)).astype(np.float32)
        mk = (rng.uniform(0, 1, (B, T, 8 * LR, 8 * LR, 1)) > 0.5).astype(np.float32)
        lr = hr.reshape(B, T, LR, 8, LR, 8, 3).mean((3, 5))
        out.append({"lr": lr, "fv": hr, "hr": hr, "mk": mk})
    return out


def _trainer(seed: int = 0):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.train.loop import TrainConfig, make_optimizer, make_train_step

    model = CRFP(ModelConfig(mid_channels=MID, remat=True), device="cpu", seed=seed)
    # the flow group frozen for step 0 only: both groups hold Adam state at
    # the save, with different step counts
    tcfg = TrainConfig(lr_rate=1e-3, lr_rate_flow=5e-4, flow_freeze_iters=1)
    return model, make_optimizer(model, tcfg), make_train_step(model, tcfg)


def _assert_state_equal(model_a, opt_a, model_b, opt_b):
    for (na, a), (nb, b) in zip(model_a.state_dict().items(), model_b.state_dict().items()):
        assert na == nb and torch.equal(a, b), na
    sa, sb = opt_a.state_dict(), opt_b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


@pytest.mark.parametrize("k", [1, 2])
def test_resume_after_k_steps_equals_unbroken_run(tmp_path, k):
    from crfp_torch.train.checkpoint import CheckpointManager

    n = 3
    batches = _batches(n)
    model, opt, step = _trainer()
    for i in range(n):
        step(opt, batches[i], i)

    m1, o1, s1 = _trainer()
    for i in range(k):
        s1(o1, batches[i], i)
    ckpt = CheckpointManager(str(tmp_path / "model"))
    assert ckpt.save(k, m1, o1)
    assert ckpt.latest_step() == k
    # a fresh model of other weights and a fresh optimizer take the saved state
    m2, o2, s2 = _trainer(seed=7)
    assert ckpt.restore(m2, o2) == k
    _assert_state_equal(m1, o1, m2, o2)
    # after step 1 the flow group has Adam state too
    n_flow = sum(p.numel() > 0 for p in o2.param_groups[1]["params"])
    assert len(o2.state_dict()["state"]) == len(list(m2.parameters())) - (n_flow if k == 1
                                                                           else 0)
    for i in range(k, n):
        s2(o2, batches[i], i)
    _assert_state_equal(model, opt, m2, o2)
    ckpt.close()


def test_latest_step_max_to_keep_and_repeated_save(tmp_path):
    from crfp_torch.train.checkpoint import CheckpointManager

    model, opt, _ = _trainer()
    ckpt = CheckpointManager(str(tmp_path / "m"), max_to_keep=2)
    assert ckpt.latest_step() is None
    assert ckpt.restore(model, opt) is None
    for s in (1, 2, 3, 4):
        assert ckpt.save(s, model, opt)
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "m")) == ["3", "4"]
    assert not ckpt.save(4, model, opt)  # an existing step is kept, not rewritten
    # a second manager on the same root sees the saved steps
    assert CheckpointManager(str(tmp_path / "m")).latest_step() == 4


def test_load_params_formats(tmp_path):
    from crfp_torch.params import save_npz
    from crfp_torch.train.checkpoint import CheckpointManager
    from crfp_torch.utils.params_io import load_params

    model, opt, step = _trainer()
    step(opt, _batches(1)[0], 0)
    want = model.state_dict()

    def same(got):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k

    save_npz(want, str(tmp_path / "m.npz"))
    same(load_params(str(tmp_path / "m.npz")))
    ckpt = CheckpointManager(str(tmp_path / "model"))
    ckpt.save(1, model, opt)
    same(load_params(str(tmp_path / "model" / "1")))
    other = _trainer(seed=3)[0]
    ckpt.save(5, other, opt)
    # a manager root: its latest step
    want = other.state_dict()
    same(load_params(str(tmp_path / "model")))

    # .pt/.pth files go through the reference's name map, strictly: the
    # port's own names are not the reference's
    torch.save(want, tmp_path / "ref.pt")
    torch.save({"state_dict": want}, tmp_path / "ref.pth")
    for name in ("ref.pt", "ref.pth"):
        with pytest.raises(KeyError, match="spynet"):
            load_params(str(tmp_path / name))
    with pytest.raises(ValueError, match="unrecognized"):
        load_params(str(tmp_path / "missing.bin"))


def test_load_params_refuses_an_orbax_directory(tmp_path):
    """An orbax checkpoint (the JAX package's CheckpointManager format, here
    a bare StandardCheckpointer save and a manager step) raises, naming the
    .npz bridge."""
    import orbax.checkpoint as ocp

    from crfp_torch.utils.params_io import load_params

    tree = {"params": {"conv": {"kernel": np.ones((3, 3, 2, 2), np.float32)}}}
    ckptr = ocp.StandardCheckpointer()  # saves asynchronously: wait, as the manager does
    ckptr.save(str(tmp_path / "bare"), tree)
    ckptr.wait_until_finished()
    ckptr.close()
    mgr = ocp.CheckpointManager(str(tmp_path / "root"))
    mgr.save(3, args=ocp.args.StandardSave(tree))
    mgr.wait_until_finished()
    mgr.close()
    for path in (tmp_path / "bare", tmp_path / "root", tmp_path / "root" / "3"):
        assert path.is_dir()
        with pytest.raises(ValueError, match="save_params_npz"):
            load_params(str(path))
