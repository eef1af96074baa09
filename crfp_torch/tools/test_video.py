"""Streaming inference demo and 4-zone evaluation (the JAX package's root
``test_video.py``).

    python -m crfp_torch.tools.test_video --procedural --model_path \\
        checkpoints/v18_mid32_procedural.npz --video_num 0 --n_frames 20

Per clip: frame-by-frame streaming through the batch trunk's step with a
Gaussian eye-tracker gaze model (x = sigma*randn + centre), 4-zone
PSNR/SSIM (whole / fovea / outskirt / past), optional foveated patch
heat-maps, and PNG/GIF export of SR / bicubic / GT. ``--procedural``
streams generated structured-content clips (crfp_torch/data/procedural.py);
the root script's REDS-frames-on-disk branch is not ported yet, so without
``--procedural`` the tool raises ``NotImplementedError`` (``--dataset_dir``
and ``--video_set`` are parsed for it). Runs on the card unless ``--cpu`` is
given. Every ``--variant`` of the trunk runs, with ``--hr_dcn`` as the
trunk's rules allow (``ModelConfig`` raises otherwise) and ``--y_only``,
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


def frames_to_gif(frames, out_path: str, fps: int = 7) -> None:
    """frames: list of (H, W, 3) uint8 RGB arrays
    (crfp_tpu/tools/video.py::frames_to_gif, written with Pillow)."""
    import PIL.Image

    imgs = [PIL.Image.fromarray(f) for f in frames]
    imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                 duration=int(round(1000 / fps)), loop=0)


def main(argv=None):
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

    if not args.procedural:
        raise NotImplementedError(
            "REDS frames on disk (--dataset_dir, --video_set) are not ported yet; "
            "pass --procedural")
    device = "cpu" if args.cpu else "cuda"
    cfg = ModelConfig(variant=args.variant, mid_channels=args.mid_channels,
                      y_only=args.y_only, hr_dcn=args.hr_dcn,
                      offset_prop=args.offset_prop, split_ratio=args.split_ratio)
    model = CRFP(cfg, device=device, seed=0)
    if args.model_path:
        from crfp_torch.params import from_jax, load_npz

        model.load_state_dict(from_jax(load_npz(args.model_path)), strict=True)
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
        gh, gw = args.procedural_hw
        assert gh == gw, "make_clip generates square frames"
        clip_rng = np.random.default_rng(5000 + v)  # held out from training
        gts = make_clip(clip_rng, args.n_frames, gh)
        lrs = lr_box(gts).astype(np.float32)
        lrsrs = bicubic_lr(lrs, gh, gw)
        print(f"clip {v:03d}: procedural seed {5000 + v} ({gh}x{gw})")
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
