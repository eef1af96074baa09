"""End-to-end deployment-configuration quality gate
(crfp_tpu/bench/deploy_gate.py, docs/DEPLOY.md).

The reference's demo evaluation protocol: per-frame Gaussian gaze ``x =
sigma*randn + W/2, y = sigma*randn + H/2`` with sigma in {10, 50, 100},
fovea 96x96, 4-zone masked PSNR/SSIM, with the trained mid-32 checkpoint,
streaming frame by frame through the batch trunk over procedurally
generated 720p clips, in two configurations on identical inputs:

- EXACT: float32, unbounded DCN and warps (``dcn_window=None``): the
  quality reference.
- DEPLOY: bfloat16 parameters and inputs, windowed DCN and warps (D=8 on
  the 1/4-res stages, D=32 on dcn_3 and the HR state warp) with per-cell
  anchored HR windows on the s2d(4) tail's cell grid (``dcn_anchor``,
  ``hr_s2d``; crfp_tpu/bench/deploy_gate.py:105-108) and, with
  ``dcn_fused``, kernel E on dcn_0/1/2 (the port's one dispatch knob).

Per zone (whole / fovea / outskirt / past) it reports each path's PSNR and
SSIM against the ground truth and the DEPLOY-EXACT delta, plus the direct
full-frame agreement PSNR between the two paths. Zone metrics come from
one pass per frame on the device
(crfp_torch/eval/zones.py::OnChipZoneEval).

    python -m crfp_torch.bench.deploy_gate --dcn_fused

runs on the card; ``--cpu`` selects the CPU (small sizes only).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from crfp_torch.bench import device_of
from crfp_torch.bench.quality_window import _texture
from crfp_torch.eval.zones import ZONES, OnChipZoneEval, zone_masks_step
from crfp_torch.models.config import ModelConfig
from crfp_torch.models.crfp import CRFP
from crfp_torch.models.streaming import StreamingRunner

FV_SIZE = 96  # the reference demo fovea
SCALE = 8


@dataclasses.dataclass
class GateRow:
    sigma: float
    zone: str
    exact_psnr: float
    exact_ssim: float
    deploy_psnr: float
    deploy_ssim: float

    @property
    def d_psnr(self) -> float:
        return self.deploy_psnr - self.exact_psnr

    @property
    def d_ssim(self) -> float:
        return self.deploy_ssim - self.exact_ssim


def _clip(rng, h, w, s, frames, vy, vx):
    """Procedural GT/LR clip: textured plane translating (vy, vx) LR px/f."""
    mh = int(abs(vy) * s * frames) + 8
    mw = int(abs(vx) * s * frames) + 8
    tex = _texture(rng, h * s + mh, w * s + mw)
    hrs = []
    for i in range(frames):
        oy, ox = int(round(vy * s * i)), int(round(vx * s * i))
        hrs.append(tex[oy : oy + h * s, ox : ox + w * s])
    hr = np.stack(hrs)  # (T, 8h, 8w, 3)
    lr = hr.reshape(frames, h, s, w, s, 3).mean((2, 4))
    return lr.astype(np.float32), hr.astype(np.float32)


def load_runner(ckpt: str, cfg: ModelConfig, *, bf16: bool = False,
                device: str | torch.device = "cuda") -> StreamingRunner:
    """The streaming runner of the trunk ``cfg`` (any variant) with ``ckpt``
    (any file ``load_params`` reads) loaded strictly, its parameters in
    bfloat16 (``bf16``: the runner casts its inputs to them) or float32."""
    from crfp_torch.utils.params_io import load_params

    model = CRFP(cfg, device=device_of(device))
    model.load_state_dict(load_params(ckpt), strict=True)
    if bf16:
        model = model.to(torch.bfloat16)
    return StreamingRunner(model)


def build_runner(ckpt: str, mid_channels: int = 32, *, deploy: bool,
                 dcn_fused: bool = False,
                 device: str | torch.device = "cuda") -> StreamingRunner:
    """The gate's EXACT (f32, no windows) or DEPLOY (bf16, windows 8/32,
    anchored HR windows, optionally kernel E) streaming runner of v18 with
    ``ckpt`` loaded strictly."""
    cfg = ModelConfig(variant="v18", mid_channels=mid_channels)
    if deploy:
        cfg = dataclasses.replace(cfg, dcn_window=8, dcn_window_hr=32, hr_s2d=True,
                                  dcn_anchor=True, dcn_fused=dcn_fused)
    return load_runner(ckpt, cfg, bf16=deploy, device=device)


def gate_clip(rng: np.random.Generator, sigma: float, lr_hw, frames: int,
              velocity=(1.0, 2.0)):
    """One sigma's inputs from ``rng``: (lr (T, h, w, 3), hr (T, 8h, 8w, 3),
    gaze (T, 2) as (y, x))."""
    h, w = lr_hw
    lr, hr = _clip(rng, h, w, SCALE, frames, *velocity)
    gaze = np.stack([sigma * rng.standard_normal(frames) + h * SCALE / 2,
                     sigma * rng.standard_normal(frames) + w * SCALE / 2], axis=1)
    return lr, hr, gaze


def stream_clip(runner: StreamingRunner, lr: np.ndarray, hr: np.ndarray,
                gaze: np.ndarray, seconds: list[float] | None = None):
    """Stream one clip through ``runner`` from a cleared state. Yields, per
    frame, (zone masks, output clipped to [0, 1] as a float32 (1, H, W, 3)
    tensor on the runner's device, ground truth likewise). ``seconds``
    collects each frame's host-clock time, ending in a device
    synchronisation on the card."""
    dev = next(runner.model.parameters()).device
    lr_d, hr_d = torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev)
    hh, hw = hr.shape[1:3]
    runner.clear_states()
    for i in range(len(lr)):
        z = zone_masks_step(hh, hw, tuple(gaze[i]), FV_SIZE)
        t0 = time.perf_counter()
        out = runner(lr_d[i][None], hr_d[i][None], torch.from_numpy(z.mask[None]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if seconds is not None:
            seconds.append(time.perf_counter() - t0)
        yield z, out.float().clamp(0, 1), hr_d[i][None]


def settled(ev: OnChipZoneEval, skip: int) -> dict[str, float]:
    """Each zone metric's mean over the frames after ``skip`` settle frames
    (recurrent state not yet propagated); 'past' entry j scores frame j+1,
    so it drops one fewer."""
    return {k: float(np.mean(v[max(skip - 1, 0) if k.endswith("past") else skip:]))
            for k, v in ev.results.items()}


def run_gate(
    ckpt: str,
    sigmas=(10.0, 50.0, 100.0),
    lr_hw=(90, 160),
    frames: int = 20,
    mid_channels: int = 32,
    velocity=(1.0, 2.0),
    seed: int = 42,
    skip: int = 2,
    *,
    dcn_fused: bool = False,
    device: str | torch.device = "cuda",
) -> tuple[list[GateRow], dict]:
    """Returns (rows, extras). ``skip``: settle frames excluded from the
    zone averages (state not yet propagated; the reference's eval also
    skips frame 0 via its border rule). ``extras``: the exact-vs-deploy
    agreement per sigma and its minimum, and each configuration's mean
    host-clock ms per steady frame."""
    run_exact = build_runner(ckpt, mid_channels, deploy=False, device=device)
    run_deploy = build_runner(ckpt, mid_channels, deploy=True, dcn_fused=dcn_fused,
                              device=device)
    rows: list[GateRow] = []
    agree_db: list[float] = []
    t_exact: list[float] = []
    t_deploy: list[float] = []
    rng = np.random.default_rng(seed)
    for sigma in sigmas:
        lr, hr, gaze = gate_clip(rng, sigma, lr_hw, frames, velocity)
        ev_exact = OnChipZoneEval(FV_SIZE, device)
        ev_deploy = OnChipZoneEval(FV_SIZE, device)
        te: list[float] = []
        td: list[float] = []
        mse_sum = 0.0
        for i, ((z, out_e, gt), (_, out_d, _)) in enumerate(zip(
                stream_clip(run_exact, lr, hr, gaze, te),
                stream_clip(run_deploy, lr, hr, gaze, td))):
            ev_exact.update(out_e, gt, z)
            ev_deploy.update(out_d, gt, z)
            if i >= skip:
                mse_sum += float(((out_e - out_d) ** 2).mean())
        t_exact += te[1:]  # steady frames: the first is the cold start
        t_deploy += td[1:]

        se, sd = settled(ev_exact, skip), settled(ev_deploy, skip)
        for zone in ZONES:
            rows.append(GateRow(
                sigma=sigma, zone=zone,
                exact_psnr=se[f"psnr_{zone}"], exact_ssim=se[f"ssim_{zone}"],
                deploy_psnr=sd[f"psnr_{zone}"], deploy_ssim=sd[f"ssim_{zone}"]))
        agree_db.append(float(-10.0 * np.log10(mse_sum / (frames - skip) + 1e-12)))
    extras = {
        "agree_db_min": float(min(agree_db)), "agree_db": agree_db,
        "exact_ms_per_frame": 1e3 * float(np.mean(t_exact)) if t_exact else float("nan"),
        "deploy_ms_per_frame": 1e3 * float(np.mean(t_deploy)) if t_deploy else float("nan"),
    }
    return rows, extras


def format_table(rows: list[GateRow]) -> str:
    lines = ["| sigma | zone | exact PSNR | deploy PSNR | dPSNR | exact SSIM | "
             "deploy SSIM | dSSIM |", "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r.sigma:g} | {r.zone} | {r.exact_psnr:.2f} | {r.deploy_psnr:.2f} "
            f"| {r.d_psnr:+.3f} | {r.exact_ssim:.4f} | {r.deploy_ssim:.4f} "
            f"| {r.d_ssim:+.4f} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default="checkpoints/v18_mid32_procedural.npz")
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--lr_hw", type=int, nargs=2, default=(90, 160))
    p.add_argument("--mid", type=int, default=32)
    p.add_argument("--sigmas", type=float, nargs="+", default=(10.0, 50.0, 100.0))
    p.add_argument("--dcn_fused", action="store_true",
                   help="DEPLOY runs dcn_0/1/2 through kernel E")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    rows, extras = run_gate(
        args.ckpt, sigmas=tuple(args.sigmas), lr_hw=tuple(args.lr_hw),
        frames=args.frames, mid_channels=args.mid, dcn_fused=args.dcn_fused,
        device=device)
    if device == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}")
    print(format_table(rows))
    print(f"\nfull-frame exact-vs-deploy agreement: min {extras['agree_db_min']:.1f} dB "
          f"(per-sigma: {', '.join(f'{a:.1f}' for a in extras['agree_db'])})")
    worst = max(abs(r.d_psnr) for r in rows)
    print(f"worst per-zone |dPSNR|: {worst:.3f} dB (budget 0.05 dB)")
    print(f"host-clock ms per steady frame on {device}: exact "
          f"{extras['exact_ms_per_frame']:.3f}, deploy {extras['deploy_ms_per_frame']:.3f}")


if __name__ == "__main__":
    main()
