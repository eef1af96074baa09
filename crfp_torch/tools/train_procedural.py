"""Train the port's CRFP on procedural clips, the recipe that trained
checkpoints/v18_mid32_struct.npz (its _curve.json holds the flags).

    python -m crfp_torch.tools.train_procedural --iters 2500 --b 2 --t 7 \\
        --gt 192 --mid 32 --flow_freeze 0 --amp \\
        --resume checkpoints/v18_mid32_struct.npz --save runs/v18_mid32_torch.npz

The flags are those of crfp_tpu/tools/train_procedural.py without its
``--no_cache``; ``--dcn_anchor`` trains per-cell anchored HR windows on
the training grid (``dcn_anchor`` and ``dcn_anchor_vjp``, as the JAX tool
sets them, crfp_tpu/tools/train_procedural.py:116): Charbonnier loss, two-group
Adam with the flow net at its own rate, cosine schedule over ``--iters``,
flow freeze, windows 8/32 and remat. ``--variant`` takes every trunk
variant; no_dcn and basic_fvsr run without the HR-level cascade
(``hr_dcn=False``), as their checkpoints were trained. Runs on the card
unless ``--cpu``.

The corpus (crfp_torch/data/procedural.py) draws its clips with Pillow.
The clip pool is cached in ``runs/pool_<pool>x<t>x<gt>_s<seed>.npz``; where
Pillow is missing, copy that file in from a machine that has it. The
``.npz`` checkpoints are the JAX package's flat format (``--resume`` reads
one, the end of the run writes one), so either package loads them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time

import numpy as np


def variant_hr_dcn(variant: str) -> bool:
    """The HR-level cascade of ``variant``: off for no_dcn and basic_fvsr,
    which run only without it (crfp_tpu/tools/train_procedural.py:110-114)."""
    return variant not in ("no_dcn", "basic_fvsr")


def make_batch(clips, b: int, t: int, gt: int, rng: np.random.Generator,
               scale: int = 8) -> dict[str, np.ndarray]:
    """B random clips of the pool: LR is the box mean of HR, the fovea
    frames are the HR frames, the masks a Nanascan of (gt/2)^2 patches."""
    from crfp_torch.data.fovea import fovea_generator

    hrs, lrs, mks = [], [], []
    for _ in range(b):
        hr = clips[int(rng.integers(0, len(clips)))]
        hrs.append(hr)
        lrs.append(hr.reshape(t, gt // scale, scale, gt // scale, scale, 3).mean((2, 4)))
        _, mk, _ = fovea_generator(hr, method="Nanascan", fv_hw=(gt // 2, gt // 2), rng=rng)
        mks.append(mk)
    hr = np.stack(hrs)
    return {"hr": hr, "lr": np.stack(lrs), "fv": hr, "mk": np.stack(mks)}


def load_pool(pool: int, t: int, gt: int, seed: int) -> list[np.ndarray]:
    """The clip pool from its cache under runs/, generated (and cached) when
    the cache is missing."""
    cache = os.path.join("runs", f"pool_{pool}x{t}x{gt}_s{seed}.npz")
    if os.path.exists(cache):
        print(f"loading clip pool from {cache}...", flush=True)
        with np.load(cache) as z:
            return [z[k] for k in z.files]
    if importlib.util.find_spec("PIL") is None:
        raise RuntimeError(
            f"Pillow is not installed and there is no clip-pool cache {cache}: the "
            "procedural corpus draws its clips with Pillow. Generate the pool where "
            "Pillow is installed (this tool, same --pool/--t/--gt/--seed) and copy "
            f"{cache} here.")
    from crfp_torch.data.procedural import make_clip_pool

    print(f"generating {pool} procedural clips (t={t}, GT={gt})...", flush=True)
    clips = make_clip_pool(pool, t, gt, seed)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    np.savez(cache, *clips)
    return clips


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--b", type=int, default=2)
    p.add_argument("--t", type=int, default=5)
    p.add_argument("--gt", type=int, default=160)
    p.add_argument("--mid", type=int, default=16)
    p.add_argument("--variant", default="v18")
    p.add_argument("--dcn_window", type=int, default=8)
    p.add_argument("--dcn_window_hr", type=int, default=32)
    p.add_argument("--flow_freeze", type=int, default=300)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--pool", type=int, default=48)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", default="runs/v18_mid16_procedural_torch.npz")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute with f32 masters (TrainConfig.amp)")
    # continue from an .npz checkpoint: the parameters are restored, Adam
    # starts fresh (the format holds parameters only); pass the remaining
    # --iters to keep the schedule sensible
    p.add_argument("--resume", default=None)
    p.add_argument("--dcn_anchor", action="store_true",
                   help="train per-cell anchored HR windows (on the training grid)")
    args = p.parse_args(argv)

    import torch

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, load_npz, save_npz
    from crfp_torch.train.loop import TrainConfig, make_optimizer, make_train_step

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --cpu to train on the CPU")
    cfg = ModelConfig(variant=args.variant, mid_channels=args.mid,
                      hr_dcn=variant_hr_dcn(args.variant), dcn_window=args.dcn_window,
                      dcn_window_hr=args.dcn_window_hr, dcn_anchor=args.dcn_anchor,
                      dcn_anchor_vjp=args.dcn_anchor, remat=True)
    model = CRFP(cfg, device=device, seed=args.seed)
    tcfg = TrainConfig(lr_rate=args.lr, flow_freeze_iters=args.flow_freeze,
                       periods=(max(args.iters, 1),), amp=args.amp)
    if args.resume:
        model.load_state_dict(from_jax(load_npz(args.resume)), strict=True)
        print(f"resumed params from {args.resume}", flush=True)

    rng = np.random.default_rng(args.seed)
    clips = load_pool(args.pool, args.t, args.gt, args.seed)
    opt = make_optimizer(model, tcfg)
    train_step = make_train_step(model, tcfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{n_params / 1e6:.2f}M params on {device}", flush=True)
    if args.dcn_anchor:
        from crfp_torch.config import anchor_grid_line

        print(anchor_grid_line(cfg, (args.gt // 8, args.gt // 8)), flush=True)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    train_step(opt, make_batch(clips, args.b, args.t, args.gt, rng), 0)
    sync()
    print(f"step 0 (kernel builds included) in {time.perf_counter() - t0:.1f}s", flush=True)

    os.makedirs(os.path.dirname(args.save) or ".", exist_ok=True)
    curve = []
    t_run = time.perf_counter()
    for it in range(1, args.iters):
        metrics = train_step(opt, make_batch(clips, args.b, args.t, args.gt, rng), it)
        if it % 100 == 0 or it == args.iters - 1:
            loss, psnr = float(metrics["loss"]), float(metrics["psnr"])
            dt = (time.perf_counter() - t_run) / it
            curve.append({"iter": it, "loss": loss, "psnr": psnr})
            print(f"iter {it:5d}  loss {loss:.5f}  psnr {psnr:.2f}  "
                  f"{dt * 1e3:.0f} ms/it", flush=True)
        if it % 500 == 0:  # a killed run still leaves a model
            save_npz(model.state_dict(), args.save)

    save_npz(model.state_dict(), args.save)
    with open(args.save.replace(".npz", "_curve.json"), "w") as f:
        json.dump({"config": vars(args), "curve": curve}, f, indent=1)
    print(f"saved {args.save}", flush=True)


if __name__ == "__main__":
    main()
