"""Capability ablation: do the trained models earn their architecture?
(crfp_tpu/bench/capability.py)

The reference's demo evaluation protocol (Gaussian gaze sigma in {10, 50,
100}, fovea 96^2, 4-zone masked PSNR/SSIM) on HELD-OUT structured
procedural clips (crfp_torch/data/procedural.py; seeds from 9000, disjoint
from training) for four rows:

- **bicubic**: PIL-parity bicubic 8x upsample of the LR stream (no model,
  no fovea; ``data/reds.py::_bicubic_upsample``): the interpolation control;
- **no_dcn**: trained CRFP_simple_noDCN (plain conv alignment), the DCN
  ablation;
- **basic_fvsr**: trained BasicFVSR (fovea blended once at input), the
  foveation ablation;
- **v18**: the trained flagship at windows 8/32.

Each trained row streams frame by frame through ``StreamingRunner`` with
its own FNet flow and its training window configuration (no_dcn and
basic_fvsr with ``hr_dcn=False``, the only branch they were trained in),
bfloat16 parameters and inputs by default, float32 metrics (the zone
evaluator's SSIM is kernel F on the card). The JAX harness also sets
``hr_s2d`` and ``dcn_anchor`` on the v18 row; those are TPU layouts, and
the JAX package itself runs that row with the plain clamp on the CPU
(crfp_tpu/nn/align.py:41-43), so the port runs the plain clamp. The claims
to check: v18 > bicubic (whole frame), v18 > no_dcn (alignment earns
quality), and a fovea/past advantage over basic_fvsr.

    python -m crfp_torch.bench.capability [--ckpt_v18 ...] [--ckpt_no_dcn ...]
        [--ckpt_basic_fvsr ...] [--cpu]

runs the three trained mid-32 checkpoints of ``checkpoints/`` on the card
unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from crfp_torch.bench import device_of
from crfp_torch.bench.deploy_gate import FV_SIZE, load_runner, settled, stream_clip
from crfp_torch.eval.zones import ZONES, OnChipZoneEval
from crfp_torch.models.config import ModelConfig

ROWS = ("no_dcn", "basic_fvsr", "v18")
CKPTS = {r: f"checkpoints/{r}_mid32_struct.npz" for r in ROWS}


def row_config(name: str, mid: int) -> ModelConfig:
    """Each trained row's configuration (crfp_tpu/bench/capability.py:72-87,
    without the TPU layouts)."""
    if name == "v18":
        return ModelConfig(variant="v18", mid_channels=mid, dcn_window=8, dcn_window_hr=32)
    if name == "no_dcn":
        return ModelConfig(variant="no_dcn", mid_channels=mid, hr_dcn=False)
    if name == "basic_fvsr":
        return ModelConfig(variant="basic_fvsr", mid_channels=mid, hr_dcn=False, dcn_window=8)
    raise ValueError(name)


def held_out_clip(seed: int, frames: int, hh: int, hw: int):
    """Structured (LR, GT) clip from the held-out seed range (>= 9000),
    float32 (T, h, w, 3) and (T, hh, hw, 3)."""
    from crfp_torch.data.procedural import lr_box, make_clip

    if hh != hw:
        raise ValueError("make_clip generates square frames")
    hr = make_clip(np.random.default_rng(seed), frames, hh)
    return lr_box(hr).astype(np.float32), hr


def bicubic8(lr: np.ndarray, hh: int, hw: int) -> np.ndarray:
    """The bicubic control: the 8-bit LR frames upsampled to (hh, hw)."""
    from crfp_torch.data.reds import _bicubic_upsample

    u8 = (np.clip(lr, 0, 1) * 255).round().astype(np.uint8)
    return _bicubic_upsample(u8, hh, hw).astype(np.float32) / 255.0


def sigma_clip(si: int, sigma: float, frames: int, hr_size: int, seed0: int = 9000):
    """Sigma number ``si``'s inputs: (lr, hr, bicubic, gaze (T, 2) as (y, x))."""
    rng = np.random.default_rng(seed0 + si)
    lr, hr = held_out_clip(seed0 + 100 + si, frames, hr_size, hr_size)
    gaze = np.stack([sigma * rng.standard_normal(frames) + hr_size / 2,
                     sigma * rng.standard_normal(frames) + hr_size / 2], axis=1)
    return lr, hr, bicubic8(lr, hr_size, hr_size), gaze


def run_capability(
    ckpts: dict[str, str],
    sigmas=(10.0, 50.0, 100.0),
    hr_size: int = 768,
    frames: int = 20,
    mid: int = 32,
    seed0: int = 9000,
    skip: int = 2,
    *,
    bf16: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """Returns {'rows': {row: {sigma: {metric_zone: value}}}, 'deltas': ...}.

    ``ckpts``: {row: checkpoint} for any of no_dcn, basic_fvsr, v18.
    ``skip``: settle frames excluded (recurrent state not yet propagated),
    as in the deployment gate; 'past' entry j scores frame j+1, so it drops
    one fewer. ``bf16``: the deployment precision of the trained rows (the
    JAX harness fixes it); False runs them in float32."""
    device = device_of(device)
    if not set(ckpts) & set(ROWS):
        raise ValueError(f"ckpts {sorted(ckpts)} names none of the trained rows {ROWS}")
    rows = ["bicubic"] + [k for k in ROWS if k in ckpts]
    runners = {k: load_runner(ckpts[k], row_config(k, mid), bf16=bf16, device=device)
               for k in rows if k != "bicubic"}

    results: dict[str, dict] = {r: {} for r in rows}
    for si, sigma in enumerate(sigmas):
        lr, hr, bic, gaze = sigma_clip(si, sigma, frames, hr_size, seed0)
        bic_d = torch.from_numpy(bic).to(device)
        evs = {r: OnChipZoneEval(FV_SIZE, device) for r in rows}
        streams = [stream_clip(runners[k], lr, hr, gaze) for k in runners]
        for i, per_row in enumerate(zip(*streams)):
            z, _, gt = per_row[0]
            evs["bicubic"].update(bic_d[i][None], gt, z)
            for name, (_, out, _) in zip(runners, per_row):
                evs[name].update(out, gt, z)
        for r in rows:
            results[r][f"{sigma:g}"] = settled(evs[r], skip)

    # headline deltas (averaged over sigmas, whole frame)
    def avg(row, metric):
        return float(np.mean([results[row][s][metric] for s in results[row]]))

    deltas = {}
    if "v18" in results:
        deltas["v18_vs_bicubic_whole_db"] = avg("v18", "psnr_whole") - avg(
            "bicubic", "psnr_whole")
        deltas["v18_vs_bicubic_fovea_db"] = avg("v18", "psnr_fovea") - avg(
            "bicubic", "psnr_fovea")
        if "no_dcn" in results:
            deltas["v18_vs_no_dcn_whole_db"] = avg("v18", "psnr_whole") - avg(
                "no_dcn", "psnr_whole")
        if "basic_fvsr" in results:
            for z in ("fovea", "past", "whole"):
                deltas[f"v18_vs_basic_fvsr_{z}_db"] = avg(
                    "v18", f"psnr_{z}") - avg("basic_fvsr", f"psnr_{z}")
    return {"rows": results, "deltas": deltas}


def print_tables(res: dict) -> None:
    rows = res["rows"]
    sigmas = list(next(iter(rows.values())).keys())
    for sigma in sigmas:
        print(f"\n### sigma^T = {sigma}\n")
        print("| model | " + " | ".join(f"{z} PSNR | {z} SSIM" for z in ZONES) + " |")
        print("|---" * (1 + 2 * len(ZONES)) + "|")
        for r, per in rows.items():
            m = per[sigma]
            cells = []
            for z in ZONES:
                cells.append(f"{m[f'psnr_{z}']:.2f}")
                cells.append(f"{m[f'ssim_{z}']:.4f}")
            print(f"| {r} | " + " | ".join(cells) + " |")
    print("\nheadline deltas (PSNR dB, averaged over sigmas):")
    for k, v in res["deltas"].items():
        print(f"  {k}: {v:+.2f}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt_v18", default=CKPTS["v18"])
    p.add_argument("--ckpt_no_dcn", default=CKPTS["no_dcn"],
                   help="'' leaves the row out")
    p.add_argument("--ckpt_basic_fvsr", default=CKPTS["basic_fvsr"],
                   help="'' leaves the row out")
    p.add_argument("--mid", type=int, default=32)
    p.add_argument("--hr_size", type=int, default=768)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--sigmas", type=float, nargs="+", default=(10.0, 50.0, 100.0))
    p.add_argument("--json_out", default=None)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    ckpts = {r: getattr(args, f"ckpt_{r}") for r in ROWS if getattr(args, f"ckpt_{r}")}
    res = run_capability(ckpts, sigmas=tuple(args.sigmas), hr_size=args.hr_size,
                         frames=args.frames, mid=args.mid,
                         device="cpu" if args.cpu else "cuda")
    if not args.cpu:
        from crfp_torch.bench import card_line

        print(f"device: {card_line()}")
    print_tables(res)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
