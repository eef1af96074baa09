"""Train / eval / test dispatch (the JAX package's root ``main.py``).

    python -m crfp_torch.main --save_dir ./train/REDS/FVSR_x8_dsv_v18 --reset true \\
        --num_gpu 1 --num_workers 9 --dataset Reds --dataset_dir /DATA/REDS_sharp/ \\
        --variant v18 --mid_channels 32 --lr_rate 2e-4 --lr_rate_flow 2.5e-5 \\
        --scale 8 --batch_size 8 --FV_size 128 --GT_size 256 --N_frames 15 ...

takes the flags of ``train.sh`` / ``eval.sh`` / ``test.sh``
(crfp_torch/config.py) and runs on the card; ``--cpu true`` runs on the CPU
(the tests do). There is no fallback: without a CUDA device and without
``--cpu true`` it raises.

- ``train``: ``fv`` is the loader's ``Ref`` or else ``HR`` (the model reads
  ``fv * mk`` only); ``--model_path`` sets the initial weights; print, save,
  viz and val cadences; a final save. Checkpoints go to
  ``save_dir/model/<step>/`` (crfp_torch/train/checkpoint.py).
- ``evaluate``: every entry of ``--model_path`` (a directory) or the one
  checkpoint, then the ``Ref  PSNR (max)`` line.
- ``test``: one checkpoint over the test split.
"""

from __future__ import annotations

import math
import os
import time

import torch

from crfp_torch.config import model_config, no_effect_flags, parse_args, train_config
from crfp_torch.data.loader import get_dataloader
from crfp_torch.eval.evaluator import evaluate_clips
from crfp_torch.models.crfp import CRFP
from crfp_torch.train.checkpoint import STATE_FILE, CheckpointManager
from crfp_torch.train.loop import make_optimizer, make_train_step
from crfp_torch.utils import MetricsWriter, mk_exp_dir
from crfp_torch.utils.params_io import load_params


def _model(args, device) -> CRFP:
    return CRFP(model_config(args), device=device, seed=0)


def train(args, logger, device="cuda") -> dict:
    """Returns {"model", "optimizer", "step", "metrics": one dict of floats
    a step}."""
    tcfg = train_config(args)
    model = _model(args, device)
    if args.model_path:
        model.load_state_dict(load_params(args.model_path), strict=True)
        logger.info(f"loaded initial params from {args.model_path}")
    loaders = get_dataloader(args)
    metrics = MetricsWriter(os.path.join(args.save_dir, "metrics.jsonl"))
    opt = make_optimizer(model, tcfg)
    step_fn = make_train_step(model, tcfg)
    ckpt = CheckpointManager(os.path.join(args.save_dir, "model"))
    viz = None
    if args.viz_every > 0:
        from crfp_torch.train.viz import TrainViz

        viz = TrainViz(args.save_dir, every=args.viz_every)

    history = []
    cur_iter = 0
    t0 = time.time()
    for epoch in range(args.num_epochs):
        for batch in loaders["train"]:
            hr = batch["HR"]
            tbatch = {
                "lr": batch["LR"],
                # fvs enters the model only as fvs*mk, so the raw HR is an
                # exact substitute for the pre-multiplied fovea image
                "fv": batch["Ref"] if "Ref" in batch else hr,
                "hr": hr,
                "mk": batch["Ref_sp"],
            }
            m = step_fn(opt, tbatch, cur_iter)
            cur_iter += 1
            history.append(m)
            if args.debug_nans and not math.isfinite(float(m["loss"])):
                raise FloatingPointError(
                    f"non-finite loss {float(m['loss'])} at iter {cur_iter} (--debug_nans)")
            if cur_iter % args.print_every == 0:
                scalars = {k: float(v) for k, v in m.items()}
                logger.info(
                    f"epoch {epoch} iter {cur_iter} loss {scalars['loss']:.5f} "
                    f"psnr {scalars['psnr']:.2f} ssim {scalars['ssim']:.4f} "
                    f"({(time.time() - t0) / cur_iter:.2f} s/iter)"
                )
                metrics.write("train", cur_iter, **scalars)
            if cur_iter % args.save_every == 0:
                ckpt.save(cur_iter, model, opt)
                logger.info(f"saved checkpoint @ iter {cur_iter}")
            if viz is not None and viz.update(cur_iter, model, tbatch):
                logger.info(f"viz frames dumped @ iter {cur_iter} -> "
                            f"{os.path.join(args.save_dir, 'viz')}")
        if (epoch + 1) % args.val_every == 0:
            res = evaluate_clips(model, loaders["eval"], args.y_only, logger.info)
            model.train()
            logger.info(f"eval epoch {epoch}: {res}")
            metrics.write("eval", cur_iter, psnr=res.psnr, ssim=res.ssim,
                          psnr_y=res.psnr_y, ssim_y=res.ssim_y)
    if cur_iter > 0:
        ckpt.save(cur_iter, model, opt)
    metrics.close()
    ckpt.close()
    return {"model": model, "optimizer": opt, "step": cur_iter,
            "metrics": [{k: float(v) for k, v in m.items()} for m in history]}


def _checkpoints(model_path: str | None) -> list[str]:
    """Every entry of a directory of checkpoints (a manager root: one step
    directory each), else ``model_path`` itself."""
    if not model_path:
        raise SystemExit("--model_path is required in eval mode")
    if os.path.isdir(model_path) and not os.path.isfile(os.path.join(model_path, STATE_FILE)):
        return [os.path.join(model_path, n) for n in sorted(os.listdir(model_path))
                if not n.startswith(".")]  # a save in flight is a hidden directory
    return [model_path]


def evaluate(args, logger, device="cuda") -> dict[str, float]:
    """The max of each metric over every checkpoint of ``--model_path``."""
    model = _model(args, device)
    loaders = get_dataloader(args)
    best = {"psnr": 0.0, "ssim": 0.0, "psnr_y": 0.0, "ssim_y": 0.0}
    for p in _checkpoints(args.model_path):
        model.load_state_dict(load_params(p), strict=True)
        save_dir = (
            os.path.join(args.save_dir, "results", os.path.basename(p))
            if args.eval_save_results else None
        )
        res = evaluate_clips(model, loaders["eval"], args.y_only, logger.info, save_dir)
        logger.info(f"{os.path.basename(p)}: {res}")
        for k in best:
            best[k] = max(best[k], getattr(res, k))
    logger.info(
        "Ref  PSNR (max): %.3f \t SSIM (max): %.4f \t PSNR_Y (max): %.3f \t SSIM_Y (max): %.4f"
        % (best["psnr"], best["ssim"], best["psnr_y"], best["ssim_y"])
    )
    return best


def test(args, logger, device="cuda"):
    if not args.model_path:
        raise SystemExit("--model_path is required in test mode")
    model = _model(args, device)
    loaders = get_dataloader(args)
    model.load_state_dict(load_params(args.model_path), strict=True)
    save_dir = os.path.join(args.save_dir, "results") if args.eval_save_results else None
    res = evaluate_clips(model, loaders["test"], args.y_only, logger.info, save_dir)
    logger.info(f"test: {res}")
    return res


def main(argv=None):
    args = parse_args(argv)
    if args.num_gpu > 1:
        raise NotImplementedError(
            f"--num_gpu {args.num_gpu}: data parallelism over several cards is not "
            "ported yet (ROADMAP.md queue 1 item 5); pass --num_gpu 1")
    model_config(args)  # refuses the flags the port does not carry, before any I/O
    if args.cpu:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is false); "
                           "pass --cpu true to run on the CPU")
    logger = mk_exp_dir(args)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(0)})" if device == "cuda" else ""))
    for flag in no_effect_flags(args):
        logger.info(f"{flag}: a TPU layout of the JAX package, the same math; "
                    "no effect in the port")
    from crfp_torch.data.reds import preprocess_path

    logger.info(f"host preprocess: {preprocess_path()}")
    if args.test:
        return test(args, logger, device)
    if args.eval:
        return evaluate(args, logger, device)
    return train(args, logger, device)


if __name__ == "__main__":
    main()
