"""Training visual dashboard: periodic image dumps + a static HTML viewer
(crfp_tpu/train/viz.py).

The local replacement for the reference's visdom windows (its metric
curves; the fovea input and the foveated patch-PSNR/SSIM heat-maps with
their 0.1-step discretization):

- every ``every`` iterations, run one forward on the first sample of the
  train batch and write PNGs under ``save_dir/viz/`` (visdom-window style:
  the ``latest_*`` set is overwritten in place; an iteration-stamped copy
  of the SR frame is kept for the training time-lapse);
- ``dashboard.html`` (written once) renders the metric curves straight
  from the run's ``metrics.jsonl`` on a <canvas> and auto-refreshes the
  images: open it in any browser over a file server, no daemon, no open
  port, no external service.

Heat-maps use the reference's normalization (psnr/100, (ssim-0.7)/0.3) and
its ssim discretization, rendered as grayscale like the visdom image calls.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch
from torch import nn

_HTML = os.path.join(os.path.dirname(__file__), "dashboard.html")


def _to_png(arr: np.ndarray, path: str) -> None:
    """arr: (H, W, 3) or (H, W) float in [0, 1]."""
    from PIL import Image

    a = np.clip(np.asarray(arr, np.float32), 0.0, 1.0)
    Image.fromarray((a * 255.0 + 0.5).astype(np.uint8)).save(path)


def _discretize(x: np.ndarray) -> np.ndarray:
    """The reference's 0.1-step SSIM banding."""
    out = np.ones_like(x)
    for t in (0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1):
        out = np.where(x <= t, t, out)
    return out


class TrainViz:
    """Periodic eval-frame dump during training.

    ``update(it, model, batch)`` is a no-op except every ``every``-th call,
    so the train loop can call it unconditionally. ``batch``: the train
    step's dict ('lr', 'fv', 'hr', 'mk'; NHWC tensors or arrays). The
    forward runs without gradients on sample 0, on the model's device."""

    def __init__(self, save_dir: str, every: int = 500):
        self.every = int(every)
        self.dir = os.path.join(save_dir, "viz")
        os.makedirs(self.dir, exist_ok=True)
        shutil.copyfile(_HTML, os.path.join(save_dir, "dashboard.html"))

    @torch.no_grad()
    def update(self, it: int, model: nn.Module, batch: dict) -> bool:
        if self.every <= 0 or it % self.every != 0:
            return False
        from crfp_torch.eval.foveated import foveated_metric

        p = next(model.parameters())
        lr, fv, mk, hr = (torch.as_tensor(batch[k][:1]).to(p.device, p.dtype)
                          for k in ("lr", "fv", "mk", "hr"))
        sr_t = model(lr, fv, mk)[0, -1].float().clamp(0, 1)
        gt_t = hr[0, -1].float()
        fv_t = (fv[0, -1] * mk[0, -1]).float()

        pm, sm, _, _ = foveated_metric(sr_t, gt_t)
        sr_n, gt_n = sr_t.cpu().numpy(), gt_t.cpu().numpy()
        pm, sm = pm.cpu().numpy(), sm.cpu().numpy()
        d = self.dir
        _to_png(sr_n, os.path.join(d, "latest_sr.png"))
        _to_png(gt_n, os.path.join(d, "latest_gt.png"))
        _to_png(fv_t.cpu().numpy(), os.path.join(d, "latest_fv.png"))
        _to_png(np.abs(sr_n - gt_n).mean(-1) * 4.0, os.path.join(d, "latest_absdiff.png"))
        _to_png(pm, os.path.join(d, "latest_psnr_map.png"))
        _to_png(np.clip(sm, 0, 1), os.path.join(d, "latest_ssim_map.png"))
        # the discretization applies to the RAW ssim (foveated_metric
        # returns it normalized as (ssim-0.7)/0.3)
        _to_png(_discretize(np.clip(sm * 0.3 + 0.7, 0.0, 1.0)),
                os.path.join(d, "latest_ssim_map_discrete.png"))
        _to_png(sr_n, os.path.join(d, f"sr_iter{it:07d}.png"))
        return True
