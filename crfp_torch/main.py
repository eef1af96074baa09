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

``--num_gpu N`` trains data-parallel over ``min(N, cards)`` ranks (``N``
gloo ranks under ``--cpu true``), as the JAX ``main.py`` builds
``data_parallel_mesh(N)`` over the devices there are; the log names the
world. Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` set)
the run takes that world, which must be the one ``--num_gpu`` asks for;
otherwise ``main`` starts the ranks itself (spawned processes, one card
each, NCCL, a free localhost port). One loader makes the global batch, as
in the JAX package: rank 0 reads it and broadcasts it, and every rank
steps on its rows (``crfp_torch.parallel.shard_batch``) through the
data-parallel train step. Rank 0 alone writes the log, ``metrics.jsonl``,
checkpoints, viz and the dashboard and runs the validation; the others wait
at a barrier around each save, dump and validation. At the end the ranks'
parameters must be bit-equal (a digest each, compared and logged).
``eval`` and ``test`` run in one process whatever ``--num_gpu`` says.
"""

from __future__ import annotations

import hashlib
import importlib
import logging
import math
import os
import sys
import time

import torch
import torch.distributed as dist

from crfp_torch.config import (anchor_grid_line, check_tpu_flags, model_config, parse_args,
                               train_config)
from crfp_torch.data.loader import get_dataloader
from crfp_torch.eval.evaluator import evaluate_clips
from crfp_torch.models.crfp import CRFP
from crfp_torch.parallel.sharding import free_port, initialize_distributed, replicate, shard_batch
from crfp_torch.train.checkpoint import STATE_FILE, CheckpointManager
from crfp_torch.train.loop import make_optimizer, make_train_step
from crfp_torch.utils import MetricsWriter, mk_exp_dir
from crfp_torch.utils.params_io import load_params


def _model(args, device) -> CRFP:
    return CRFP(model_config(args), device=device, seed=0)


def _train_batch(batch: dict) -> dict:
    """The train step's dict of a loader batch."""
    hr = batch["HR"]
    return {
        "lr": batch["LR"],
        # fvs enters the model only as fvs*mk, so the raw HR is an exact
        # substitute for the pre-multiplied fovea image
        "fv": batch["Ref"] if "Ref" in batch else hr,
        "hr": hr,
        "mk": batch["Ref_sp"],
    }


def _broadcast_batches(loader, group, device):
    """The global train batches on every rank of ``group``: rank 0 (which
    alone holds ``loader``) reads each and broadcasts it; the others
    receive. Yields dicts of tensors (on the card under NCCL, else the
    CPU)."""
    rank0 = dist.get_rank(group) == 0
    dev = torch.device(device) if dist.get_backend(group) == "nccl" else torch.device("cpu")
    it = iter(loader) if rank0 else None
    while True:
        sent = None
        if rank0:
            batch = next(it, None)
            if batch is not None:
                tb = _train_batch(batch)
                # "fv" is "hr" itself unless the loader gave a fovea image
                sent = {k: torch.from_numpy(v).to(dev) for k, v in tb.items()
                        if k != "fv" or v is not tb["hr"]}
        meta = [None if sent is None else {k: (t.shape, t.dtype) for k, t in sent.items()}]
        dist.broadcast_object_list(meta, src=0, group=group)
        if meta[0] is None:
            return
        out = sent or {k: torch.empty(shape, dtype=dtype, device=dev)
                       for k, (shape, dtype) in meta[0].items()}
        for k in meta[0]:
            dist.broadcast(out[k], src=0, group=group)
        out.setdefault("fv", out["hr"])
        yield out


def _replica_digest(model) -> bytes:
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.digest()[:8]


def _check_replicas(model, group, logger, device) -> None:
    """Raise unless every rank holds the same parameter bits."""
    dev = torch.device(device) if dist.get_backend(group) == "nccl" else torch.device("cpu")
    mine = torch.tensor(list(_replica_digest(model)), dtype=torch.uint8, device=dev)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    digests = [bytes(p.cpu().tolist()).hex() for p in parts]
    logger.info(f"data parallel: parameter digests of the {len(digests)} ranks {digests}; "
                f"bit-equal: {len(set(digests)) == 1}")
    if len(set(digests)) != 1:
        raise RuntimeError(f"data parallel: the ranks' parameters differ: {digests}")


def train(args, logger, device="cuda", group=None) -> dict:
    """Returns {"model", "optimizer", "step", "metrics": one dict of floats
    a step}. ``group``: the data-parallel ranks (None: one process); every
    rank calls this, rank 0 alone reads the data and writes."""
    tcfg = train_config(args)
    rank0 = group is None or dist.get_rank(group) == 0
    model = _model(args, device)
    if args.model_path:
        model.load_state_dict(load_params(args.model_path), strict=True)
        logger.info(f"loaded initial params from {args.model_path}")
    if group is not None:
        replicate(model, group)
    loaders = get_dataloader(args) if rank0 else None
    metrics = MetricsWriter(os.path.join(args.save_dir, "metrics.jsonl")) if rank0 else None
    opt = make_optimizer(model, tcfg)
    step_fn = make_train_step(model, tcfg, group)
    ckpt = CheckpointManager(os.path.join(args.save_dir, "model")) if rank0 else None
    viz = None
    if args.viz_every > 0 and rank0:
        from crfp_torch.train.viz import TrainViz

        viz = TrainViz(args.save_dir, every=args.viz_every)

    def on_rank0(fn):
        """``fn()`` on rank 0 while the other ranks wait."""
        out = fn() if rank0 else None
        if group is not None:
            dist.barrier(group=group)
        return out

    history = []
    cur_iter = 0
    t0 = time.time()
    for epoch in range(args.num_epochs):
        batches = (map(_train_batch, loaders["train"]) if group is None
                   else _broadcast_batches(loaders and loaders["train"], group, device))
        for tbatch in batches:
            local = tbatch if group is None else shard_batch(tbatch, group, device)
            m = step_fn(opt, local, cur_iter)
            cur_iter += 1
            history.append(m)
            if args.debug_nans and not math.isfinite(float(m["loss"])):
                raise FloatingPointError(
                    f"non-finite loss {float(m['loss'])} at iter {cur_iter} (--debug_nans)")
            if cur_iter % args.print_every == 0 and rank0:
                scalars = {k: float(v) for k, v in m.items()}
                logger.info(
                    f"epoch {epoch} iter {cur_iter} loss {scalars['loss']:.5f} "
                    f"psnr {scalars['psnr']:.2f} ssim {scalars['ssim']:.4f} "
                    f"({(time.time() - t0) / cur_iter:.2f} s/iter)"
                )
                metrics.write("train", cur_iter, **scalars)
            if cur_iter % args.save_every == 0:
                on_rank0(lambda: ckpt.save(cur_iter, model, opt))
                logger.info(f"saved checkpoint @ iter {cur_iter}")
            if args.viz_every > 0 and cur_iter % args.viz_every == 0 and on_rank0(
                    lambda: viz.update(cur_iter, model, tbatch)):
                logger.info(f"viz frames dumped @ iter {cur_iter} -> "
                            f"{os.path.join(args.save_dir, 'viz')}")
        if (epoch + 1) % args.val_every == 0:
            res = on_rank0(lambda: evaluate_clips(model, loaders["eval"], args.y_only,
                                                  logger.info))
            model.train()
            if rank0:
                logger.info(f"eval epoch {epoch}: {res}")
                metrics.write("eval", cur_iter, psnr=res.psnr, ssim=res.ssim,
                              psnr_y=res.psnr_y, ssim_y=res.ssim_y)
    if cur_iter > 0:
        on_rank0(lambda: ckpt.save(cur_iter, model, opt))
    if rank0:
        metrics.close()
        ckpt.close()
    if group is not None:
        _check_replicas(model, group, logger, device)
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


def _torchrun() -> bool:
    return all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def _run(args, device: str, world: int):
    """One process's run: the train mode over ``world`` ranks of an
    initialised group (1: no group), or eval/test."""
    group = dist.group.WORLD if world > 1 else None
    rank = dist.get_rank() if group is not None else 0
    if rank == 0:
        # with --reset true this deletes save_dir: once, before any rank writes
        logger = mk_exp_dir(args)
    else:
        logger = logging.getLogger(f"{args.logger_name}.rank{rank}")
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
    if group is not None:
        dist.barrier(group=group)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name()})" if device == "cuda" else ""))
    train_mode = not (args.test or args.eval)
    if train_mode:
        cards = "" if device == "cpu" else f", {torch.cuda.device_count()} card(s)"
        logger.info(f"data parallel: world {world} (--num_gpu {args.num_gpu}{cards})"
                    + (f"; below --num_gpu {args.num_gpu}: the cards there are"
                       if world < args.num_gpu else ""))
    elif args.num_gpu > 1:
        logger.info(f"--num_gpu {args.num_gpu}: eval and test run in one process")
    check_tpu_flags(args, logger.info)
    if args.dcn_anchor:  # which cell grid the anchored ops take
        logger.info(anchor_grid_line(model_config(args), (args.GT_size // args.scale,) * 2))
    from crfp_torch.data.reds import preprocess_path

    logger.info(f"host preprocess: {preprocess_path()}")
    if args.test:
        return test(args, logger, device)
    if args.eval:
        return evaluate(args, logger, device)
    return train(args, logger, device, group)


def _rank_main(argv, rank: int, world: int, port: int, device: str) -> None:
    """A spawned rank of ``main``'s data-parallel train run."""
    initialize_distributed(f"tcp://localhost:{port}", world, rank, device=device)
    try:
        _run(parse_args(argv), device, world)
    finally:
        dist.destroy_process_group()


def _spawn(argv, world: int, device: str) -> dict:
    """Start ``world`` ranks of the train run and wait for them; a rank that
    fails stops the others and raises here."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    # by the package's name, also when this module runs as __main__
    target = importlib.import_module("crfp_torch.main")._rank_main
    procs = [ctx.Process(target=target, args=(argv, r, world, port, device))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            for r, p in enumerate(procs):
                p.join(timeout=0.5)
                if p.exitcode not in (None, 0):
                    raise RuntimeError(f"data parallel: rank {r} of {world} exited with "
                                       f"code {p.exitcode}")
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if bad:
            raise RuntimeError(f"data parallel: ranks exited with codes {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return {"world": world}


def main(argv=None):
    args = parse_args(argv)
    model_config(args)  # a config the port refuses raises here, before any I/O
    if args.cpu:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is false); "
                           "pass --cpu true to run on the CPU")
    world = 1
    if not (args.test or args.eval):
        # the ranks there are: N gloo processes on the CPU, one card each else
        world = args.num_gpu if device == "cpu" else min(args.num_gpu,
                                                         torch.cuda.device_count())
        if world > 1 and args.batch_size % world:
            raise ValueError(f"--batch_size {args.batch_size} does not divide evenly over "
                             f"{world} ranks (shard_batch)")
        if _torchrun():
            if int(os.environ["WORLD_SIZE"]) != world:
                raise ValueError(f"torchrun's world of {os.environ['WORLD_SIZE']} is not "
                                 f"the {world} rank(s) --num_gpu {args.num_gpu} asks for")
            if world > 1:
                initialize_distributed(device=device)
                try:
                    return _run(args, device, world)
                finally:
                    dist.destroy_process_group()
        elif world > 1:
            return _spawn(sys.argv[1:] if argv is None else list(argv), world, device)
    return _run(args, device, world)


if __name__ == "__main__":
    main()
