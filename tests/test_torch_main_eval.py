"""The slice's eval and test modes: ``python -m crfp_torch.main --eval
true`` over the model directory of a port train run, and ``--test true``
on one of its checkpoints, equal the JAX package's ``evaluate_clips`` on
the same splits and weights to 1e-3 dB / 1e-5 (CPU, f32; the tiny REDS
tree of tests/test_torch_main.py; the run starts from the port's seeded
init)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests.test_data import _make_fake_reds  # noqa: E402
from tests.test_torch_main import _argv  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(tmp, the JAX model): 4 port train steps saved at steps 2 and 4."""
    import crfp_torch.main as tmain
    from crfp_tpu.config import model_config, parse_args
    from crfp_tpu.models.crfp import CRFP as JCRFP

    tmp = str(tmp_path_factory.mktemp("main_eval"))
    _make_fake_reds(tmp, n_frames=4, gt_hw=(64, 96))
    out = tmain.main(_argv(tmp, extra=["--save_every", "2", "--flow_freeze_iters", "0",
                                       "--lr_rate", "1e-3"]))
    assert out["step"] == 4
    return tmp, JCRFP(model_config(parse_args(_argv(tmp))))


def _jax_eval(jmodel, ckpt, split, tmp):
    from crfp_torch.params import to_jax
    from crfp_torch.utils.params_io import load_params
    from crfp_tpu.data.loader import Loader
    from crfp_tpu.data.reds import EvalSet, TestSet
    from crfp_tpu.config import parse_args
    from crfp_tpu.eval.evaluator import evaluate_clips
    from tests.torch_parity import unflatten

    args = parse_args(_argv(tmp))
    ds = (EvalSet if split == "eval" else TestSet)(args)
    params = unflatten(to_jax(load_params(ckpt)))
    return evaluate_clips(jmodel, params, Loader(ds, batch_size=1, num_workers=1))


def test_evaluate_and_test_equal_jax_evaluate_clips(trained):
    import crfp_torch.main as tmain

    tmp, jmodel = trained
    model_dir = os.path.join(tmp, "exp", "model")
    best = tmain.main(_argv(tmp, "exp_eval", ["--eval", "true", "--model_path", model_dir]))
    log = open(os.path.join(tmp, "exp_eval", "MRCF.log")).read()
    assert "Ref  PSNR (max)" in log
    want = [_jax_eval(jmodel, os.path.join(model_dir, s), "eval", tmp) for s in ("2", "4")]
    for k, tol in (("psnr", 1e-3), ("ssim", 1e-5), ("psnr_y", 1e-3), ("ssim_y", 1e-5)):
        assert abs(best[k] - max(getattr(w, k) for w in want)) <= tol, (k, best[k])

    ckpt = os.path.join(model_dir, "4")
    res = tmain.main(_argv(tmp, "exp_test", ["--test", "true", "--model_path", ckpt,
                                              "--eval_save_results", "true"]))
    want = _jax_eval(jmodel, ckpt, "test", tmp)
    assert res.n_frames == want.n_frames
    for k, tol in (("psnr", 1e-3), ("ssim", 1e-5), ("psnr_y", 1e-3), ("ssim_y", 1e-5)):
        assert abs(getattr(res, k) - getattr(want, k)) <= tol, (k, getattr(res, k))
    assert len(os.listdir(os.path.join(tmp, "exp_test", "results"))) == 2 * 12


@pytest.mark.parametrize("b", [1, 2])
def test_batch_trunk_hands_the_kernels_contiguous_operands(monkeypatch, b):
    """The warp and DCN dispatchers take NCHW-contiguous operands on the
    card (they raise otherwise). The NHWC clips of ``evaluate_clips`` (batch
    1) and of a train step reach every call site contiguous: a layout
    fault the CPU's plain versions would not show."""
    import numpy as np

    import crfp_torch.models.crfp as cr
    import crfp_torch.nn.align as al
    from crfp_torch.models.config import ModelConfig

    seen = []

    def checked(fn):
        def call(*args, **kw):
            seen.append(all(a.is_contiguous() for a in args if torch.is_tensor(a)))
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(cr, "flow_warp_windowed", checked(cr.flow_warp_windowed))
    monkeypatch.setattr(al, "deform_conv2d_windowed", checked(al.deform_conv2d_windowed))
    model = cr.CRFP(ModelConfig(mid_channels=16), device="cpu")
    step = model.step
    steps = []

    def step_inputs(state, *args, **kw):
        # at batch 1 the step's frames are NCHW-contiguous: a channels-last
        # view there keeps cuDNN's outputs channels-last on the card, and the
        # states it feeds the warp then raise on the card
        steps.append(all(a.is_contiguous() for a in args if torch.is_tensor(a)))
        return step(state, *args, **kw)

    monkeypatch.setattr(model, "step", step_inputs)
    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.uniform(0, 1, (b, 3, 8, 8, 3)).astype(np.float32))
    hr = torch.from_numpy(rng.uniform(0, 1, (b, 3, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        model(lr, hr, hr[..., :1])
    assert len(seen) == 2 * 7 and all(seen), seen
    assert len(steps) == 2 and (b > 1 or all(steps)), steps
