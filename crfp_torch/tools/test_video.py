"""Streaming inference demo and 4-zone evaluation (the JAX package's root
``test_video.py``).

    python -m crfp_torch.tools.test_video --procedural --model_path \\
        checkpoints/v18_mid32_procedural.npz --video_num 0 --n_frames 20

    python -m crfp_torch.tools.test_video --dataset_dir /DATA/REDS_sharp \\
        --video_set train --video_num 0,11,15,20 --model_path <checkpoint>

Per clip: frame-by-frame streaming through the batch trunk's step with a
Gaussian eye-tracker gaze model (x = sigma*randn + centre), 4-zone
PSNR/SSIM (whole / fovea / outskirt / past), optional foveated patch
heat-maps, and PNG/GIF export of SR / bicubic / GT. The clips are REDS
frames on disk (``<dataset_dir>/<set>/<set>/<set>_sharp/<NNN>`` and its
``_sharp_BI_x8`` LR tree, read by :func:`load_clip`), or with
``--procedural`` generated structured-content clips
(crfp_torch/data/procedural.py). ``--model_path`` is any checkpoint
``crfp_torch.utils.params_io.load_params`` reads. Runs on the card unless
``--cpu`` is given. Every ``--variant`` of the trunk runs, with ``--hr_dcn``
as the trunk's rules allow (``ModelConfig`` raises otherwise) and ``--y_only``,
whose Y goes beside the bicubic LR's UV before the metrics.
"""

from __future__ import annotations

import argparse
import os


def _flag(v: str) -> bool:
    return v.lower() in ("1", "true", "y")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_dir", type=str, default="/DATA/REDS_sharp")
    p.add_argument("--video_set", type=str, default="train")
    p.add_argument("--video_num", type=str, default="0,11,15,20")
    p.add_argument("--procedural", action="store_true",
                   help="stream generated structured-content clips instead of REDS "
                        "frames on disk; --video_num indexes held-out seeds")
    p.add_argument("--procedural_hw", type=int, nargs=2, default=(512, 512),
                   help="HR frame size of the generated clips")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--variant", type=str, default="v18",
                   choices=["v13", "v15", "v18", "v18_cra", "no_dcn", "basic_fvsr"])
    p.add_argument("--mid_channels", type=int, default=32)
    p.add_argument("--y_only", action="store_true")
    p.add_argument("--hr_dcn", type=_flag, default=True)
    p.add_argument("--offset_prop", type=_flag, default=True)
    p.add_argument("--split_ratio", type=int, default=3)
    p.add_argument("--sigma", type=float, default=50.0,
                   help="eye-tracker noise sigma (the demos use 10/50/100)")
    p.add_argument("--fv_size", type=int, default=96)
    p.add_argument("--regional_dcn", action="store_true")
    p.add_argument("--dcn_size", type=int, default=720)
    p.add_argument("--n_frames", type=int, default=100)
    p.add_argument("--eval_mode", action="store_true")
    p.add_argument("--save_dir", type=str, default="test_png/eval_video")
    p.add_argument("--save_gif", action="store_true")
    p.add_argument("--heatmaps", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def load_clip(gt_dir: str, lr_dir: str, n_frames: int):
    """The first ``n_frames`` frames of a clip on disk as float32 arrays in
    [0, 1]: GT (cropped to 1072x1920), LR (cropped to 134x240) and the
    bicubic upsample of each whole LR frame to the GT size (root
    ``test_video.py::load_clip``, decoded with Pillow: for 8-bit PNGs the
    same bytes as OpenCV's BGR read flipped to RGB)."""
    import numpy as np
    import PIL.Image

    def read(path):
        with PIL.Image.open(path) as im:
            return np.array(im.convert("RGB"))

    gt_files = sorted(os.listdir(gt_dir))[:n_frames]
    lr_files = sorted(os.listdir(lr_dir))[:n_frames]
    gts, lrs, lrsrs = [], [], []
    for gf, lf in zip(gt_files, lr_files):
        gt = read(os.path.join(gt_dir, gf))[:1072, :1920]
        lr_full = read(os.path.join(lr_dir, lf))
        h, w = gt.shape[:2]
        gts.append(gt)
        lrs.append(lr_full[:134, :240])
        lrsrs.append(np.array(PIL.Image.fromarray(lr_full).resize((w, h), PIL.Image.BICUBIC)))

    def f(x):
        return np.stack(x).astype(np.float32) / 255.0

    return f(gts), f(lrs), f(lrsrs)


def clip_dirs(dataset_dir: str, video_set: str, v: int) -> tuple[str, str]:
    """(GT, LR) directories of REDS clip ``v`` of ``video_set``."""
    sub = os.path.join(video_set, video_set, f"{video_set}_sharp", f"{v:03d}")
    return (os.path.join(dataset_dir, sub),
            os.path.join(dataset_dir.replace("_sharp", "_sharp_BI_x8"), sub))


def main(argv=None, on_frame=None):
    """Returns the 4-zone summary. ``on_frame(clip, i, sr)``, when given, is
    called with every SR frame (1, H, W, 3), a tensor on the model's device."""
    args = parse_args(argv)
    import numpy as np
    import PIL.Image
    import torch

    from crfp_torch.data.procedural import bicubic_lr, lr_box, make_clip
    from crfp_torch.eval.foveated import foveated_metric
    from crfp_torch.eval.zones import ZONES, StreamingZoneEval, zone_masks_step
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.models.streaming import StreamingRunner
    from crfp_torch.ops.color import y_beside_uv
    from crfp_torch.tools.video import frames_to_gif

    device = "cpu" if args.cpu else "cuda"
    cfg = ModelConfig(variant=args.variant, mid_channels=args.mid_channels,
                      y_only=args.y_only, hr_dcn=args.hr_dcn,
                      offset_prop=args.offset_prop, split_ratio=args.split_ratio)
    model = CRFP(cfg, device=device, seed=0)
    if args.model_path:
        from crfp_torch.utils.params_io import load_params

        model.load_state_dict(load_params(args.model_path), strict=True)
    else:
        print("WARNING: no --model_path given; using random weights")
    rng = np.random.default_rng(args.seed)

    os.makedirs(args.save_dir, exist_ok=True)
    zone_eval = StreamingZoneEval(device)
    use_fg = args.regional_dcn
    runner = StreamingRunner(model, use_fg=use_fg)

    def u8(x):
        return (np.clip(x, 0, 1) * 255).astype(np.uint8)

    for v in (int(x) for x in args.video_num.split(",")):
        if args.procedural:
            gh, gw = args.procedural_hw
            assert gh == gw, "make_clip generates square frames"
            clip_rng = np.random.default_rng(5000 + v)  # held out from training
            gts = make_clip(clip_rng, args.n_frames, gh)
            lrs = lr_box(gts).astype(np.float32)
            lrsrs = bicubic_lr(lrs, gh, gw)
            print(f"clip {v:03d}: procedural seed {5000 + v} ({gh}x{gw})")
        else:
            gt_dir, lr_dir = clip_dirs(args.dataset_dir, args.video_set, v)
            print(f"clip {v:03d}: {gt_dir}")
            gts, lrs, lrsrs = load_clip(gt_dir, lr_dir, args.n_frames)
        n, h, w, _ = gts.shape

        runner.clear_states()
        zone_eval.new_clip()
        gaze_x = args.sigma * rng.standard_normal(n) + w / 2
        gaze_y = args.sigma * rng.standard_normal(n) + h / 2

        sr_frames, heat_frames = [], []
        for i in range(n):
            zones = zone_masks_step(h, w, (gaze_y[i], gaze_x[i]), args.fv_size,
                                    regional_dcn=args.regional_dcn,
                                    dcn_size=args.dcn_size)
            sr = runner(lrs[i : i + 1], (gts[i] * zones.mask)[None], zones.mask[None],
                        zones.fg[None] if use_fg else None).float()
            if args.y_only:
                sr = y_beside_uv(sr[..., :1], torch.from_numpy(lrsrs[i : i + 1]).to(sr.device))
            zone_eval.update(sr, gts[i : i + 1], zones)
            if on_frame is not None:
                on_frame(v, i, sr)
            sr_frames.append((sr[0].clamp(0, 1) * 255).round().to(torch.uint8)
                             .cpu().numpy())
            if args.heatmaps:
                pm, _, _, _ = foveated_metric(sr[0], torch.from_numpy(gts[i]).to(sr.device))
                heat_frames.append(u8(pm.cpu().numpy()))
            print(f"  frame {i}\r", end="")

        clip_dir = os.path.join(args.save_dir, f"{v:03d}")
        os.makedirs(clip_dir, exist_ok=True)
        for i, f in enumerate(sr_frames):
            PIL.Image.fromarray(f).save(os.path.join(clip_dir, f"sr_{i:08d}.png"))
        if args.save_gif:
            frames_to_gif(sr_frames, os.path.join(args.save_dir, f"sr_{v:03d}.gif"))
            frames_to_gif([u8(x) for x in lrsrs],
                          os.path.join(args.save_dir, f"bicubic_{v:03d}.gif"))
            frames_to_gif([u8(x) for x in gts],
                          os.path.join(args.save_dir, f"gt_{v:03d}.gif"))
        if args.heatmaps and heat_frames:
            frames_to_gif([np.repeat(f[..., None], 3, axis=-1) for f in heat_frames],
                          os.path.join(args.save_dir, f"psnr_heat_{v:03d}.gif"))

    summary = zone_eval.summary()
    print()
    for zone in ZONES:
        print(f"{zone:>9}: PSNR {summary[f'psnr_{zone}']:.3f}  "
              f"SSIM {summary[f'ssim_{zone}']:.4f}")
    return summary


if __name__ == "__main__":
    main()
