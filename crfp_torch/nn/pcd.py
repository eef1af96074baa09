"""PCD alignment, NCHW (crfp_tpu/nn/pcd.py:22-72): the EDVR-style pyramid,
cascading deformable alignment.

Stride-2 convs build a 3-level pyramid of the stacked (cur, pre,
pre_aligned) batch; DCN alignment runs coarse to fine with each level's
offset feature upsampled x2 and scaled x2 into the next (the JAX package's
repair of the reference, :53-58); the flow is resized to each level
without rescaling its magnitudes (:45-48); a last cascading DCN refines at
full resolution. Its four ``DCNAlign`` stages take no window: the exact
DCN, kernel A with no clamp on the card (8 groups of 8 channels at nf 64).
Inference only, as in the JAX package: ``forward`` runs under
``torch.no_grad()`` (kernel D, the DCN backward, does not take nf 64).
"""

from __future__ import annotations

import torch
from torch import nn

from crfp_torch.nn.align import DCNAlign
from crfp_torch.nn.layers import Conv, init_parameters, lrelu
from crfp_torch.ops.resize import upsample


class PCDAlign(nn.Module):
    """``device``: where the module lives (default ``cuda``; tests pass
    ``cpu``). ``seed``: seeds the ``torch.Generator`` that initialises the
    parameters (identity DCN weights, zero heads)."""

    def __init__(self, nf: int = 64, groups: int = 8, kernel: int = 3,
                 max_mag: float = 10.0, *, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        self.fea_L2_conv1 = Conv(nf, nf, stride=2)
        self.fea_L3_conv1 = Conv(nf, nf, stride=2)
        self.L3_dcnpack = DCNAlign(nf, groups, kernel, max_mag)
        self.L2_dcnpack = DCNAlign(nf, groups, kernel, max_mag, pre_offset=True)
        self.L2_fea_conv = Conv(2 * nf, nf)
        self.L1_dcnpack = DCNAlign(nf, groups, kernel, max_mag, pre_offset=True)
        self.L1_fea_conv = Conv(2 * nf, nf)
        self.cas_dcnpack = DCNAlign(nf, groups, kernel, max_mag)
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    @torch.no_grad()
    def forward(self, cur_x: torch.Tensor, pre_x: torch.Tensor,
                pre_x_aligned: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        """cur_x, pre_x, pre_x_aligned (N, nf, H, W); flow (N, 2, H, W),
        channels (dx, dy). Returns the aligned feature (N, nf, H, W)."""
        l2 = lrelu(self.fea_L2_conv1(torch.cat([cur_x, pre_x, pre_x_aligned], dim=0)))
        l3 = lrelu(self.fea_L3_conv1(l2))
        cur2, pre2, ali2 = torch.chunk(l2, 3, dim=0)
        cur3, pre3, ali3 = torch.chunk(l3, 3, dim=0)
        flow2 = upsample(flow, 0.5)
        flow3 = upsample(flow2, 0.5)

        l3_fea, l3_off = self.L3_dcnpack(cur3, pre3, ali3, flow3)
        l3_fea = upsample(lrelu(l3_fea), 2)
        l2_fea, l2_off = self.L2_dcnpack(cur2, pre2, ali2, flow2, upsample(l3_off, 2) * 2.0)
        l2_fea = lrelu(self.L2_fea_conv(torch.cat([l2_fea, l3_fea], dim=1)))
        l2_fea = upsample(l2_fea, 2)
        l1_fea, _ = self.L1_dcnpack(cur_x, pre_x, pre_x_aligned, flow,
                                    upsample(l2_off, 2) * 2.0)
        l1_fea = self.L1_fea_conv(torch.cat([l1_fea, l2_fea], dim=1))
        cas_fea, _ = self.cas_dcnpack(cur_x, l1_fea, l1_fea, flow)
        return lrelu(cas_fea)
