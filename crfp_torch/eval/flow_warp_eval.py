"""BASELINE config 1: flow and backward-warp propagation
(crfp_tpu/eval/flow_warp_eval.py:22-53).

The flow of each consecutive LR pair (SPyNet or FNet), upsampled x8 and
scaled by 8, warps the previous ground-truth frame onto the next one; each
warped frame is scored against the ground truth with the masked PSNR and
SSIM under a full mask. On the card the warp is kernel B with no clamp (the
JAX package's XLA gather) and the SSIM map kernel F: one B launch and T-1
F launches a call.
"""

from __future__ import annotations

import numpy as np
import torch

from crfp_torch.nn.flow import FNet, SPyNet
from crfp_torch.nn.layers import init_parameters
from crfp_torch.ops.cuda.warp import flow_warp_windowed
from crfp_torch.ops.metrics import masked_psnr, masked_ssim
from crfp_torch.ops.resize import upsample


@torch.no_grad()
def flow_warp_propagation_eval(
    lrs: np.ndarray,
    gts: np.ndarray,
    flow_net: str = "spynet",
    params: dict[str, torch.Tensor] | None = None,
    scale: int = 8,
    *,
    device: str | torch.device = "cuda",
    generator: torch.Generator | None = None,
):
    """lrs (T, h, w, 3), gts (T, 8h, 8w, 3) in [0, 1]. Returns the per-frame
    metrics of the warp-propagated frames 1..T-1 and the flow net's
    state_dict (``params``, or the net initialised from ``generator``,
    default seed 0)."""
    net = SPyNet() if flow_net == "spynet" else FNet(3)
    if params is None:
        init_parameters(net, generator or torch.Generator().manual_seed(0))
    else:
        net.load_state_dict(params, strict=True)
    net.to(device).eval()
    lr = torch.as_tensor(np.asarray(lrs, np.float32), device=device).permute(0, 3, 1, 2)
    gt = torch.as_tensor(np.asarray(gts, np.float32), device=device)
    flows = net(lr[1:].contiguous(), lr[:-1].contiguous())  # (T-1, 2, h, w)
    hr_flows = (upsample(flows, scale) * float(scale)).float().contiguous()
    prev = gt[:-1].permute(0, 3, 1, 2).contiguous()
    warped = flow_warp_windowed(prev, hr_flows, None).permute(0, 2, 3, 1)
    ones = torch.ones_like(gt[:1, ..., :1])
    psnrs, ssims = [], []
    for i in range(len(lrs) - 1):
        a, b = warped[i:i + 1], gt[i + 1:i + 2]
        psnrs.append(float(masked_psnr(a, b, ones)))
        ssims.append(float(masked_ssim(a, b, ones)))
    return {"psnr": psnrs, "ssim": ssims, "params": net.state_dict()}
