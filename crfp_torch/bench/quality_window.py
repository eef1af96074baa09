"""Quality cost of the windowed (clamped) DCN against the exact one under
ground-truth motion (crfp_tpu/bench/quality_window.py).

The recurrent step of the batch trunk is driven with the TRUE flow on
content translating by a whole number of LR pixels a frame:

- frames are integer-shifted crops of one fixed texture, so the true
  inter-frame flow is (v, v) everywhere;
- the step's ``flow`` input is fed that flow directly; with zero-init
  offset heads the DCN's sample displacement then equals the flow, so the
  clamp bites exactly when the displacement crosses the window;
- after ``frames`` recurrent steps the exact (``dcn_window=None``: kernel A
  unclamped on the card) and the windowed (kernel A clamped at D on the
  1/4-res stages, 4D on dcn_3) outputs are compared (PSNR).

Within the window the two agree to float noise (>= 80 dB); beyond it the
divergence is what clamping costs on content moving faster than D px a
frame at the 1/4-res trunk (4D at the HR level). ``anchor=True``
(``--anchor``): the windowed side takes per-cell anchored HR windows
(``ModelConfig.dcn_anchor``, the full-resolution cell grid, as the JAX
harness runs it), which follow coherent motion past 4D.

    python -m crfp_torch.bench.quality_window [--windows 4 8 16] [--anchor] [--cpu]

runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from crfp_torch.bench import device_of
from crfp_torch.models.config import ModelConfig
from crfp_torch.models.crfp import CRFP


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth-ish multi-scale texture so bilinear warps are meaningful."""
    img = np.zeros((h, w, 3), np.float32)
    for period in (4, 8, 16, 32):
        phase = rng.uniform(0, 2 * np.pi, (2, 3))
        yy = np.arange(h)[:, None, None]
        xx = np.arange(w)[None, :, None]
        img += np.sin(2 * np.pi * yy / period + phase[0]) * np.cos(
            2 * np.pi * xx / period + phase[1]
        )
    img += 0.3 * rng.standard_normal((h, w, 3)).astype(np.float32)
    img -= img.min()
    img /= img.max()
    return img.astype(np.float32)


def panning_clip(frames: int, lr_hw, v, seed: int = 0,
                 scale: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """A procedural texture panning ``v`` = (vy, vx) LR px a frame: the crop
    origin moves by +v a frame. Returns (lr (T, h, w, 3), hr (T, s*h, s*w,
    3)) float32, lr the s x s box mean of hr."""
    h, w = lr_hw
    s = scale
    m = int(max(abs(v[0]), abs(v[1])) * frames * s) + 1
    tex = _texture(np.random.default_rng(seed), h * s + 2 * m, w * s + 2 * m)
    hrs = []
    for i in range(frames):
        oy, ox = m + int(round(v[0] * s * i)), m + int(round(v[1] * s * i))
        hrs.append(tex[oy:oy + h * s, ox:ox + w * s])
    hr = np.stack(hrs)
    lr = hr.reshape(frames, h, s, w, s, 3).mean((2, 4))
    return lr.astype(np.float32), hr.astype(np.float32)


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of two [0, 1] arrays; 99 where they agree to 1e-12 in MSE."""
    mse = float(np.mean((a - b) ** 2))
    return 99.0 if mse < 1e-12 else float(-10.0 * np.log10(mse))


def trunk(cfg: ModelConfig, state_dict, device) -> CRFP:
    """The batch trunk of ``cfg`` with ``state_dict`` loaded strictly, eval."""
    model = CRFP(cfg, device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def windowed(cfg: ModelConfig, window: int, anchor: bool = False) -> ModelConfig:
    """``cfg`` clamped at ``window`` on the 1/4-res stages and 4x that on
    dcn_3 and the HR state warp (the JAX harnesses' pairing), anchored
    there with ``anchor``."""
    return dataclasses.replace(cfg, dcn_window=window, dcn_window_hr=4 * window,
                               dcn_anchor=anchor)


@dataclasses.dataclass
class WindowQualityResult:
    v_px: float            # true motion at LR scale, px/frame
    window: int            # dcn_window (1/4-res trunk displacement = 2*v)
    psnr_db: float         # exact vs windowed output agreement


@torch.no_grad()
def run_window_quality(
    velocities=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0),
    windows=(4, 8, 16),
    lr_hw=(24, 40),
    frames: int = 6,
    mid_channels: int = 32,
    seed: int = 0,
    anchor: bool = False,
    *,
    state_dict: dict[str, torch.Tensor] | None = None,
    device: str | torch.device = "cuda",
) -> list[WindowQualityResult]:
    """Exact against windowed on the last of ``frames`` frames, for each
    velocity and window. ``anchor``: anchored HR windows on the windowed
    side. ``state_dict``: the trunk's weights (default: the port's seeded
    init, zero offset heads as in the JAX init)."""
    device = device_of(device)
    h, w = lr_hw
    s = 8
    rng = np.random.default_rng(seed)
    margin = int(max(velocities) * frames) + 2
    tex = _texture(rng, h + margin, w + margin)
    if state_dict is None:
        state_dict = CRFP(ModelConfig(variant="v18", mid_channels=mid_channels),
                          device="cpu").state_dict()
    fv0 = torch.zeros(1, 3, h * s, w * s, device=device)
    mk0 = torch.zeros(1, 1, h * s, w * s, device=device)

    def stream(model: CRFP, v: float) -> np.ndarray:
        """``frames`` recurrent steps on content translating by v px/frame
        (LR scale), fed the TRUE flow; the last output frame, NHWC."""

        def frame(i):
            # the camera pans: the crop origin moves by +v a frame, so
            # content moves by -v; flow(cur -> prev) = +v
            oy = int(round(v * i))
            crop = torch.from_numpy(tex[oy:oy + h, oy:oy + w]).permute(2, 0, 1)
            return crop[None].contiguous().to(device)  # the kernels take contiguous operands

        flow = torch.full((1, 2, h, w), float(v), device=device)
        lr = frame(0)
        x_lr, x_hr = model.encode_frame(lr, fv0, mk0)
        state, out = model.step0(lr, x_lr, x_hr, mk0)
        for i in range(1, frames):
            lr = frame(i)
            x_lr, x_hr = model.encode_frame(lr, fv0, mk0)
            state, out = model.step(state, lr, x_lr, x_hr, mk0, flow)
        return out.permute(0, 2, 3, 1).cpu().numpy()

    cfg = ModelConfig(variant="v18", mid_channels=mid_channels)
    exact_model = trunk(cfg, state_dict, device)
    win_models = {d: trunk(windowed(cfg, d, anchor), state_dict, device) for d in windows}
    results = []
    for v in velocities:
        exact = stream(exact_model, v)
        for d in windows:
            agree = psnr_db(exact, stream(win_models[d], v))
            results.append(WindowQualityResult(v, d, round(agree, 2)))
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--anchor", action="store_true",
                   help="per-cell anchored HR windows on the windowed side")
    p.add_argument("--windows", type=int, nargs="+", default=[4, 8, 16])
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    mode = "anchored" if args.anchor else "windowed"
    for r in run_window_quality(windows=tuple(args.windows), anchor=args.anchor,
                                device="cpu" if args.cpu else "cuda"):
        # trunk displacement is 2*v (flow is upsampled x2 and doubled)
        print(f"v={r.v_px:4.1f} px/frame (trunk {2 * r.v_px:4.1f} px)  "
              f"D={r.window:2d}  exact-vs-{mode} {r.psnr_db:6.2f} dB", flush=True)


if __name__ == "__main__":
    main()
