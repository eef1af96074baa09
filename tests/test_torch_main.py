"""The slice as a whole: ``python -m crfp_torch.main`` against the JAX
package's ``main.py`` path on the CPU (f32).

- The flag surface: ``parse_args([])`` and the ``train.sh`` / ``eval.sh`` /
  ``test.sh`` lines give the JAX parser's values flag for flag; the flags
  the port refuses (``--num_gpu`` > 1, ``--dcn_anchor true``, no CUDA
  without ``--cpu true``) raise before any directory is made, and the
  TPU layout flags are logged as having no effect.
- On a tiny REDS tree (mid 16, GT 64, N_frames 2, batch 2, one loader
  worker), ``train`` from an ``.npz`` of the JAX init runs 4 steps with
  saves and the dashboard; its logged losses equal the JAX
  ``make_train_step`` over the batches the port's loader yielded, from the
  same weights, to 1e-5 relative.

``evaluate`` and ``test`` are held against the JAX evaluator in
tests/test_torch_main_eval.py (a file of their own, so that each file's
JAX compiles stay under a minute).
"""

import json
import os
import shlex
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests.test_data import _make_fake_reds  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4


def _argv(tmp, save="exp", extra=()):
    return [
        "--save_dir", os.path.join(tmp, save), "--reset", "true",
        "--dataset", "Reds", "--dataset_dir", os.path.join(tmp, "REDS_sharp"),
        "--variant", "v18", "--mid_channels", "16", "--scale", "8",
        "--GT_size", "64", "--FV_size", "16", "--N_frames", "2",
        "--batch_size", "2", "--num_workers", "1", "--num_gpu", "1",
        "--cpu", "true", "--remat", "false", *extra,
    ]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's train run and what it was fed: (tmp, JAX model, JAX init
    params, the port's result, the batches its loader yielded)."""
    import crfp_torch.main as tmain
    from crfp_tpu.config import model_config, parse_args
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from crfp_tpu.utils.params_io import save_params_npz

    tmp = str(tmp_path_factory.mktemp("main"))
    # 3 training clips x 3 windows of 2 frames: 4 steps at batch 2
    _make_fake_reds(tmp, n_frames=4, gt_hw=(64, 96))
    jargs = parse_args(_argv(tmp))
    jmodel = JCRFP(model_config(jargs))
    lr = jnp.zeros((1, 2, 8, 8, 3))
    hr = jnp.zeros((1, 2, 64, 64, 3))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), lr, hr, hr[..., :1])
    npz = os.path.join(tmp, "init.npz")
    save_params_npz(params, npz)

    fed = []
    real = tmain.get_dataloader

    def recording(args):
        loaders = real(args)
        train = loaders["train"]

        class Recorder:
            def __iter__(self):
                for b in train:
                    fed.append({k: v.copy() for k, v in b.items()})
                    yield b

        loaders["train"] = Recorder()
        return loaders

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmain, "get_dataloader", recording)
        out = tmain.main(_argv(tmp, extra=[
            "--model_path", npz, "--print_every", "1", "--save_every", "2",
            "--viz_every", "2", "--flow_freeze_iters", "1", "--lr_rate", "1e-3"]))
    return tmp, jmodel, params, out, fed


def test_train_losses_equal_jax_train_step(run):
    from crfp_tpu.config import parse_args, train_config
    from crfp_tpu.train import TrainState, make_train_step
    from crfp_tpu.train.loop import make_optimizer

    tmp, jmodel, params, out, fed = run
    assert out["step"] == STEPS and len(fed) == STEPS
    jargs = parse_args(_argv(tmp, extra=["--flow_freeze_iters", "1", "--lr_rate", "1e-3"]))
    tcfg = train_config(jargs)
    # create_train_state's state around the fixture's init (its own init
    # would run the model again, eagerly)
    tx = make_optimizer(tcfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), tx=tx)
    step = make_train_step(jmodel, tcfg)
    logged = [json.loads(line) for line in
              open(os.path.join(tmp, "exp", "metrics.jsonl")).read().splitlines()]
    assert [r["step"] for r in logged] == list(range(1, STEPS + 1))
    for i, b in enumerate(fed):
        # the loader's minimal samples: no Ref, so HR stands in for fv
        assert "Ref" not in b
        state, m = step(state, {"lr": jnp.asarray(b["LR"]), "fv": jnp.asarray(b["HR"]),
                                "hr": jnp.asarray(b["HR"]), "mk": jnp.asarray(b["Ref_sp"])})
        want, got = float(m["loss"]), logged[i]["loss"]
        assert got == out["metrics"][i]["loss"]
        assert abs(got - want) <= 1e-5 * abs(want), (i, got, want)
        assert abs(logged[i]["psnr"] - float(m["psnr"])) <= 1e-3, i
        assert abs(logged[i]["ssim"] - float(m["ssim"])) <= 1e-5, i


def test_train_writes_checkpoints_metrics_and_dashboard(run):
    tmp = run[0]
    exp = os.path.join(tmp, "exp")
    assert sorted(os.listdir(os.path.join(exp, "model"))) == ["2", "4"]
    for name in ("args.txt", "metrics.jsonl", "dashboard.html", "MRCF.log"):
        assert os.path.isfile(os.path.join(exp, name)), name
    for name in ("latest_sr.png", "sr_iter0000002.png", "sr_iter0000004.png"):
        assert os.path.isfile(os.path.join(exp, "viz", name)), name
    log = open(os.path.join(exp, "MRCF.log")).read()
    assert "loaded initial params" in log and "host preprocess:" in log


def _script_argv(name):
    """The flags of a shell recipe's ``python3 main.py`` line."""
    text = open(os.path.join(ROOT, name)).read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "main.py" in ln)
    return shlex.split(line.split("main.py", 1)[1])


@pytest.mark.parametrize("script", [None, "train.sh", "eval.sh", "test.sh"])
def test_flags_equal_jax_parser(script):
    from crfp_torch.config import parse_args
    from crfp_tpu.config import parse_args as jparse

    argv = [] if script is None else _script_argv(script)
    got, want = vars(parse_args(argv)), vars(jparse(argv))
    assert got == want
    if script == "train.sh":  # the recipe trains the exact, unclamped DCN
        assert got["dcn_window"] is None and got["dcn_window_hr"] is None


def test_flag_mapping_onto_the_port_configs():
    from crfp_torch.config import model_config, parse_args, train_config

    args = parse_args(_script_argv("train.sh") + ["--dcn_window", "8", "--amp", "true"])
    cfg, tcfg = model_config(args), train_config(args)
    assert (cfg.variant, cfg.mid_channels, cfg.scale, cfg.dcn_window, cfg.dcn_window_hr,
            cfg.remat) == ("v18", 32, 8, 8, None, True)
    assert (tcfg.lr_rate, tcfg.lr_rate_flow, tcfg.periods, tcfg.amp) == (
        2e-4, 2.5e-5, (600000,), True)


def test_refused_flags_raise_before_any_directory(tmp_path):
    import crfp_torch.main as tmain

    cases = [(["--num_gpu", "2"], NotImplementedError, "queue 1 item 5"),
             (["--dcn_anchor", "true"], ValueError, "anchored"),
             (["--cpu", "false"], RuntimeError, "no CUDA device")]
    for extra, exc, match in cases:
        argv = _argv(str(tmp_path)) + extra
        if torch.cuda.is_available() and extra == ["--cpu", "false"]:
            continue
        with pytest.raises(exc, match=match):
            tmain.main(argv)
        assert not (tmp_path / "exp").exists()


def test_layout_flags_are_logged_as_no_effect(run):
    import crfp_torch.main as tmain

    tmp = run[0]
    tmain.main(_argv(tmp, "exp_s2d", ["--test", "true", "--hr_s2d", "true", "--lv3_s2d",
                                      "true", "--model_path", os.path.join(tmp, "init.npz")]))
    log = open(os.path.join(tmp, "exp_s2d", "MRCF.log")).read()
    assert "--hr_s2d: a TPU layout" in log and "--lv3_s2d: a TPU layout" in log


def test_debug_nans_fails_on_the_first_non_finite_loss(run):
    import crfp_torch.main as tmain
    from crfp_torch.params import load_npz

    tmp = run[0]
    flat = load_npz(os.path.join(tmp, "init.npz"))
    key = next(k for k in flat if "conv_last" in k and k.endswith("kernel"))
    flat[key] = np.full_like(flat[key], np.nan)
    np.savez(os.path.join(tmp, "nan.npz"), **flat)
    with pytest.raises(FloatingPointError, match="iter 1"):
        tmain.main(_argv(tmp, "exp_nan", ["--debug_nans", "true", "--model_path",
                                          os.path.join(tmp, "nan.npz")]))


def test_mk_exp_dir_refuses_overwrite(tmp_path):
    from crfp_torch.config import parse_args
    from crfp_torch.utils import mk_exp_dir

    d = str(tmp_path / "exp")
    args = parse_args(["--save_dir", d, "--reset", "false"])
    mk_exp_dir(args)
    with pytest.raises(SystemExit, match="already exists"):
        mk_exp_dir(args)
    assert "\nGT_size: 256\n" in open(os.path.join(d, "args.txt")).read()
