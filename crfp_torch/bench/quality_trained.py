"""The windowed clamp's quality cost under TRAINED weights and a LEARNED
flow (crfp_tpu/bench/quality_trained.py).

A trained checkpoint (``crfp_torch.tools.train_procedural``, or any file
``load_params`` reads) streams held-out translating clips through the batch
trunk's step with its OWN flow estimate (``CRFP.compute_flow``, the
reference protocol), once exact (``dcn_window=None``: kernel A unclamped on
the card) and once windowed (kernel A clamped), and reports over the
settled tail (frames 2 on):

- exact-vs-windowed output PSNR (the clamp's cost with learned flows,
  which overshoot and jitter unlike ground truth), and
- each path's PSNR against the ground truth (whether the clamp costs
  quality, not just agreement).

    python -m crfp_torch.bench.quality_trained \\
        --ckpt checkpoints/v18_mid32_procedural.npz --mid 32 [--cpu]

runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from crfp_torch.bench import device_of
from crfp_torch.bench.quality_window import _texture, psnr_db, trunk, windowed
from crfp_torch.models.config import ModelConfig


@dataclasses.dataclass
class TrainedQualityRow:
    v_px: float
    window: int
    agree_db: float   # exact vs windowed
    exact_db: float   # exact vs GT
    win_db: float     # windowed vs GT


@torch.no_grad()
def run_trained_quality(
    ckpt: str,
    velocities=(0.5, 1.0, 2.0, 3.0, 4.0, 6.0),
    windows=(8,),
    lr_hw=(24, 40),
    frames: int = 6,
    mid_channels: int = 32,
    seed: int = 7,
    *,
    device: str | torch.device = "cuda",
) -> list[TrainedQualityRow]:
    from crfp_torch.utils.params_io import load_params

    device = device_of(device)
    state_dict = load_params(ckpt)
    h, w = lr_hw
    s = 8
    rng = np.random.default_rng(seed)
    margin = int(max(velocities) * frames * s) + 8
    tex_hr = _texture(rng, h * s + margin, w * s + margin)
    fv0 = torch.zeros(1, 3, h * s, w * s, device=device)
    mk0 = torch.zeros(1, 1, h * s, w * s, device=device)

    def clip(v):
        """HR frames translating by v LR px/frame (= v*s HR px/frame) and
        their box-downsampled LR frames, (1, T, ., ., 3) each."""
        hrs = []
        for i in range(frames):
            o = int(round(v * s * i))
            hrs.append(tex_hr[o:o + h * s, o:o + w * s])
        hr = np.stack(hrs)[None]
        lr = hr.reshape(1, frames, h, s, w, s, 3).mean((3, 5))
        return lr, hr

    def stream(model, lrs) -> np.ndarray:
        # NCHW-contiguous frames: the kernels take contiguous operands
        lrs = torch.from_numpy(lrs).permute(0, 1, 4, 2, 3).contiguous().to(device)
        outs = []
        lr = lrs[:, 0]
        x_lr, x_hr = model.encode_frame(lr, fv0, mk0)
        state, out = model.step0(lr, x_lr, x_hr, mk0)
        outs.append(out)
        for i in range(1, frames):
            prev, lr = lrs[:, i - 1], lrs[:, i]
            flow = model.compute_flow(lr, prev)
            x_lr, x_hr = model.encode_frame(lr, fv0, mk0)
            state, out = model.step(state, lr, x_lr, x_hr, mk0, flow)
            outs.append(out)
        return torch.stack(outs, 1).permute(0, 1, 3, 4, 2).cpu().numpy()

    cfg = ModelConfig(variant="v18", mid_channels=mid_channels)
    exact_model = trunk(cfg, state_dict, device)
    win_models = {d: trunk(windowed(cfg, d), state_dict, device) for d in windows}
    rows = []
    for v in velocities:
        lrs, hr = clip(v)
        exact = stream(exact_model, lrs)
        for d in windows:
            win = stream(win_models[d], lrs)
            # score the settled tail (state fully propagated)
            rows.append(TrainedQualityRow(
                v_px=v, window=d,
                agree_db=round(psnr_db(exact[:, 2:], win[:, 2:]), 2),
                exact_db=round(psnr_db(exact[:, 2:], hr[:, 2:]), 2),
                win_db=round(psnr_db(win[:, 2:], hr[:, 2:]), 2),
            ))
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", default="checkpoints/v18_mid32_procedural.npz")
    p.add_argument("--mid", type=int, default=32)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    rows = run_trained_quality(args.ckpt, mid_channels=args.mid,
                               device="cpu" if args.cpu else "cuda")
    print("| v (LR px/f) | D | exact-vs-win dB | exact-vs-GT | win-vs-GT |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r.v_px} | {r.window} | {r.agree_db} | {r.exact_db} | {r.win_db} |")


if __name__ == "__main__":
    main()
