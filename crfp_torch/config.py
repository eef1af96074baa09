"""The command line of ``python -m crfp_torch.main``: the flags of
crfp_tpu/config.py, with the same names, types and defaults, so that the
``train.sh`` / ``eval.sh`` / ``test.sh`` lines carry over with ``main.py``
swapped for ``python -m crfp_torch.main``.

The port runs the logical math of the JAX model:
- ``--dcn_anchor true`` is math, not a layout: per-cell anchored HR
  windows sample past ±dcn_window_hr (crfp_torch/ops/anchor.py). Training
  with it also sets ``dcn_anchor_vjp``, the training cell grid, which
  ``--eval`` and ``--test`` leave off (crfp_tpu/config.py:169-175);
- ``--hr_s2d`` and ``--lv3_s2d`` compute what the plain layout computes
  (pinned by tests/test_models.py::test_hr_s2d_bit_equivalence_v18); they
  are accepted, and ``main`` logs that they have no effect
  (:func:`check_tpu_flags`), except ``--hr_s2d`` under ``--dcn_anchor``:
  there it selects the anchored cell grid of the JAX s2d(4) tail.

``--num_gpu N`` trains data-parallel over ``min(N, cards)`` ranks
(``crfp_torch/main.py``).
"""

from __future__ import annotations

import argparse

from crfp_torch.models.config import ModelConfig
from crfp_torch.train.loop import TrainConfig


def str2bool(v: str) -> bool:
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CRFP on PyTorch/CUDA (crfp_torch)")

    ### visdom-era dashboard settings (kept for CLI compat; metrics go to JSONL)
    p.add_argument("--visdom_port", type=int, default=8801)
    p.add_argument("--visdom_view", type=str, default="MRCF")

    ### log settings
    p.add_argument("--save_dir", type=str, default="save_dir")
    p.add_argument("--reset", type=str2bool, default=False)
    p.add_argument("--log_file_name", type=str, default="MRCF.log")
    p.add_argument("--logger_name", type=str, default="MRCF")

    ### device settings
    p.add_argument("--cpu", type=str2bool, default=False)
    p.add_argument("--num_gpu", type=int, default=1,
                   help="ranks of data-parallel training: min(N, cards) on the "
                        "card, N gloo processes with --cpu true")
    p.add_argument("--gpu_id", type=int, default=0)

    ### dataset settings
    p.add_argument("--dataset", type=str, default="REDS")
    p.add_argument("--dataset_dir", type=str, default="/Data/REDS_sharp/")
    p.add_argument("--num_workers", type=int, default=4)
    # --dataset procedural only: clips per split (0 = the split's default)
    p.add_argument("--procedural_clips", type=int, default=0)
    p.add_argument("--frame_cache", type=str, default=None,
                   help="directory for the decode-once raw frame cache "
                        "(crfp_torch/data/cache.py); unset = decode PNGs per read")

    ### model settings
    p.add_argument("--num_res_blocks", type=str, default="4+4+4+4")
    p.add_argument("--n_feats", type=int, default=64)
    p.add_argument("--res_scale", type=float, default=1.0)
    p.add_argument("--cra", type=str2bool, default=True)
    p.add_argument("--mrcf", type=str2bool, default=True)
    p.add_argument("--y_only", type=str2bool, default=False)
    p.add_argument("--hr_dcn", type=str2bool, default=True)
    p.add_argument("--offset_prop", type=str2bool, default=True)
    # promoted hard-coded knobs
    p.add_argument("--variant", type=str, default="v18",
                   choices=["v13", "v15", "v18"],
                   help="trunk variant (reference main.py hard-codes CRFP_DSV = v18)")
    p.add_argument("--mid_channels", type=int, default=32)
    p.add_argument("--split_ratio", type=int, default=3)
    p.add_argument("--dg_num", type=int, default=8)
    p.add_argument("--dcn_kernel", type=int, default=3)
    p.add_argument("--max_mag", type=float, default=10.0)
    p.add_argument("--flow_net", type=str, default="fnet", choices=["fnet", "spynet"])
    p.add_argument("--remat", type=str2bool, default=True)
    p.add_argument("--dcn_window", type=int, default=None,
                   help="windowed DCN: clamp the 1/4-res alignment displacements "
                        "to +-N px (None = exact)")
    p.add_argument("--dcn_window_hr", type=int, default=None,
                   help="same for the HR-level dcn_3 (8x-res flow: budget "
                        "~4x dcn_window, e.g. 32); None = exact")
    p.add_argument("--hr_s2d", type=str2bool, default=False,
                   help="a TPU layout of the JAX package; the same math, no "
                        "effect in the port but the anchored HR cell grid "
                        "under --dcn_anchor")
    p.add_argument("--dcn_anchor", type=str2bool, default=False,
                   help="per-cell anchored windows for the HR windowed ops "
                        "(eval and test; training raises)")
    p.add_argument("--lv3_s2d", type=str2bool, default=False,
                   help="a TPU layout of the JAX package; the same math, no "
                        "effect in the port")

    ### loss settings
    p.add_argument("--rec_w", type=float, default=1.0)

    ### optimizer settings
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--eps", type=float, default=1e-12)
    p.add_argument("--lr_rate", type=float, default=1e-4)
    p.add_argument("--lr_rate_flow", type=float, default=2.5e-5)
    p.add_argument("--decay", type=float, default=999999)
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("--lr_periods", type=str, default="600000")
    p.add_argument("--min_lr", type=float, default=1e-7)
    p.add_argument("--flow_freeze_iters", type=int, default=5000)
    p.add_argument("--amp", type=str2bool, default=False,
                   help="mixed-precision training: bf16 forward/backward "
                        "compute with f32 master params/moments/loss "
                        "(TrainConfig.amp)")

    ### training settings
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--GT_size", type=int, default=256)
    p.add_argument("--FV_size", type=int, default=80)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--N_frames", type=int, default=15)
    p.add_argument("--train_crop_size", type=int, default=40)
    p.add_argument("--num_init_epochs", type=int, default=2)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--print_every", type=int, default=1)
    p.add_argument("--save_every", type=int, default=999999)
    p.add_argument("--val_every", type=int, default=999999)
    # training visual dashboard (crfp_torch/train/viz.py): every N iters
    # dump SR/GT/fovea frames + foveated patch heat-maps to save_dir/viz/
    # and serve them via save_dir/dashboard.html; 0 disables
    p.add_argument("--viz_every", type=int, default=0)

    ### debugging
    p.add_argument("--debug_nans", type=str2bool, default=False,
                   help="fail on the first non-finite training loss")

    ### evaluate / test / finetune settings
    p.add_argument("--eval", type=str2bool, default=False)
    p.add_argument("--eval_save_results", type=str2bool, default=False)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--test", type=str2bool, default=False)
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


# the JAX package's TPU layout flags: the same math in another layout
LAYOUT_FLAGS = ("hr_s2d", "lv3_s2d", "emit_s2d")


def model_config(args) -> ModelConfig:
    return ModelConfig(
        variant=args.variant,
        mid_channels=args.mid_channels,
        scale=args.scale,
        y_only=args.y_only,
        hr_dcn=args.hr_dcn,
        offset_prop=args.offset_prop,
        split_ratio=args.split_ratio,
        deform_groups=args.dg_num,
        dcn_kernel=args.dcn_kernel,
        max_residue_magnitude=args.max_mag,
        flow_net=args.flow_net,
        remat=args.remat,
        dcn_window=args.dcn_window,
        dcn_window_hr=args.dcn_window_hr,
        dcn_anchor=args.dcn_anchor,
        # the anchored backward's training grid is a training concern
        # (crfp_tpu/config.py:172-175)
        dcn_anchor_vjp=args.dcn_anchor and not (args.eval or args.test),
        hr_s2d=args.hr_s2d,
    )


def check_tpu_flags(args, log=print) -> None:
    """The rule for the JAX package's TPU flags (``main`` and the bench
    CLIs): each layout flag given is logged as having no effect, but
    ``--hr_s2d`` under ``--dcn_anchor``, which is logged as the selector of
    the anchored cell grid."""
    for k in LAYOUT_FLAGS:
        if not getattr(args, k, False):
            continue
        if k == "hr_s2d" and getattr(args, "dcn_anchor", False):
            log("--hr_s2d: the anchored HR ops take the cell grid of the JAX package's "
                "s2d(4) kernels (the HR warp's band 32, not 64)")
        else:
            log(f"--{k}: a TPU layout of the JAX package, the same math; no effect in the port")


def anchor_grid_line(cfg: ModelConfig, lr_hw: tuple[int, int] | None = None) -> str:
    """What the anchored HR ops of ``cfg`` resolve: the training grid
    (``dcn_anchor_vjp``, the backward's VMEM factors) or the inference one,
    for dcn_3 and the HR state warp in f32 and bf16; the grid reads the
    widths, not the frame, so any ``lr_hw`` gives the same cells."""
    from crfp_torch.ops.anchor import dcn_geometry, warp_geometry

    h, w = (cfg.scale * v for v in (lr_hw or (24, 24)))
    c, d, fg = cfg.last_channels, cfg.dcn_window_hr, cfg.dcn_anchor_vjp
    if d is None:
        return "--dcn_anchor: no effect without --dcn_window_hr"
    cells = []
    for bf16 in (False, True):
        dg = dcn_geometry(h, w, c, c, 1, cfg.dcn_kernel, d, bf16=bf16, shared_taps=True,
                          shared_mask=True, fullgrad=fg)
        wg = warp_geometry(h, w, c, d, bf16=bf16, s2d=cfg.anchor_s2d, fullgrad=fg)
        cells.append(f"{'bf16' if bf16 else 'f32'}: dcn_3 band {dg.band} x xtile {dg.xtile}, "
                     f"HR warp band {wg.band} x xtile {wg.xtile}")
    grid = "the training grid (dcn_anchor_vjp)" if fg else "the inference grid"
    return f"--dcn_anchor: anchored HR windows on {grid}; " + "; ".join(cells)


def train_config(args) -> TrainConfig:
    periods = tuple(int(x) for x in str(args.lr_periods).split(",") if x)
    return TrainConfig(
        lr_rate=args.lr_rate,
        lr_rate_flow=args.lr_rate_flow,
        beta1=args.beta1,
        beta2=args.beta2,
        eps=args.eps,
        periods=periods,
        restart_weights=tuple(1.0 for _ in periods),
        min_lr=args.min_lr,
        flow_freeze_iters=args.flow_freeze_iters,
        rec_w=args.rec_w,
        amp=args.amp,
    )
