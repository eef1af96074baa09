"""The plain v18 batch trunk, its Charbonnier loss and the two-group Adam
step of the reference recipe (``train.sh``).

``Trunk.forward(lrs, fvs, mks)`` takes whole clips NCHW per frame, (B, T,
C, H, W): the flow of every (t, t-1) pair, the encoders over every frame
(the fovea blended into the x8 LR frame through its mask), ``step0`` on the
first frame and ``step`` on each later one. Each later step runs under
``torch.utils.checkpoint`` so that the reference fits beside a long clip;
that changes no arithmetic.

:func:`adam_update` is Adam as the recipe states it (beta1 0.9, beta2
0.999, eps 1e-12; bias-corrected, ``lr / (1 - b1^t) * m / (sqrt(v) /
sqrt(1 - b2^t) + eps)``), on two groups: the flow net and the rest, each
with its own cosine schedule; :func:`lr_at` is that schedule.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint
from torch import nn

from benchmark.reference import ops
from benchmark.reference.nets import (
    LTE,
    Conv,
    FNet,
    PixelShufflePack,
    PixelUnShufflePackV2,
    ResidualBlocksWithInputConv,
)
from benchmark.reference.ops import lrelu
from benchmark.reference.runtime import Spec, build_alignment, hr_warp


class Trunk(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        self.spec = spec
        m, last, keep = spec.mid, spec.last, spec.keep
        self.spynet = FNet(3)
        build_alignment(self, spec)
        self.encoder_lr = LTE(m, 3)
        self.encoder_hr = LTE(last, 6)
        self.conv_tttf = Conv(2 * last, last)
        self.conv_last = Conv(last, 3)
        for i in range(3):
            self.add_module(f"forward_resblocks_{i}", ResidualBlocksWithInputConv(2 * m, m))
        self.forward_resblocks_3 = ResidualBlocksWithInputConv(2 * last, last)
        self.downsample = PixelUnShufflePackV2(last, m, 4)
        self.upsample = PixelShufflePack(m, keep, 2)
        self.upsample_post = PixelShufflePack(keep, last, 4)

    def _split(self, x):
        chunks = torch.chunk(x, 4, dim=1)
        s = self.spec.split
        return torch.cat(chunks[:s], dim=1), torch.cat(chunks[s:], dim=1)

    def _reconstruct(self, y, x_hr, mk, lr):
        mk = mk.to(y.dtype)
        blended = self.conv_tttf(torch.cat([y, x_hr], dim=1))
        y = lrelu(mk * blended + (1.0 - mk) * y)
        return y, self.conv_last(y) + ops.upsample(lr, self.spec.scale)

    def step0(self, lr, x_lr, x_hr, mk):
        spec = self.spec
        n, _, h, w = lr.shape
        z_lv3 = lr.new_zeros(n, spec.mid, 2 * h, 2 * w)
        z_lv = lr.new_zeros(n, spec.mid - spec.keep, 2 * h, 2 * w)
        z_hr = lr.new_zeros(n, spec.last, spec.scale * h, spec.scale * w)
        x, lvs = self.upsample(x_lr), []
        for i in range(3):
            x = getattr(self, f"forward_resblocks_{i}")(torch.cat([x, z_lv3, z_lv], dim=1))
            x, carry = self._split(x)
            lvs.append(carry)
        x = lrelu(self.upsample_post(x))
        y = self.forward_resblocks_3(torch.cat([x, z_hr], dim=1))
        y, out = self._reconstruct(y, x_hr, mk, lr)
        return (y, *lvs), out

    def step(self, hr_state, lv0, lv1, lv2, lr, x_lr, x_hr, mk, flow):
        spec = self.spec
        x = self.upsample(x_lr)
        flow_lv3 = (ops.upsample(flow, 2) * 2.0).float()
        flow_lv0 = (ops.upsample(flow, spec.scale) * float(spec.scale)).float()
        lv3_state = self.downsample(hr_state)
        hr_warped = hr_warp(spec, hr_state, flow_lv0)
        lv3_warped = ops.flow_warp(lv3_state, flow_lv3, spec.window)
        feats = torch.chunk(ops.flow_warp(torch.cat([lv0, lv1, lv2], dim=1), flow_lv3,
                                          spec.window), 3, dim=1)
        offset, lvs = None, []
        for i in range(3):
            x = torch.cat([x, feats[i]], dim=1)
            aligned, offset = getattr(self, f"dcn_{i}")(x, lv3_state, lv3_warped, flow_lv3,
                                                        offset)
            x = getattr(self, f"forward_resblocks_{i}")(torch.cat([x, aligned], dim=1))
            x, carry = self._split(x)
            lvs.append(carry)
        x = lrelu(self.upsample_post(x))
        aligned, _ = self.dcn_3(x, hr_state, hr_warped, flow_lv0, offset)
        y = self.forward_resblocks_3(torch.cat([x, aligned], dim=1))
        y, out = self._reconstruct(y, x_hr, mk, lr)
        return (y, *lvs), out

    def forward(self, lrs, fvs, mks, checkpoint: bool = True):
        """(B, T, 3, h, w), (B, T, 3, 8h, 8w), (B, T, 1, 8h, 8w) ->
        (B, T, 3, 8h, 8w)."""
        b, t, c, h, w = lrs.shape
        s = self.spec.scale
        flows = self.spynet(lrs[:, 1:].reshape(-1, c, h, w),
                            lrs[:, :-1].reshape(-1, c, h, w)).reshape(b, t - 1, 2, h, w)
        lr_all = lrs.reshape(b * t, c, h, w)
        mk_all = mks.reshape(b * t, 1, h * s, w * s).to(lrs.dtype)
        lr_up = ops.upsample(lr_all, s)
        blend = fvs.reshape(b * t, c, h * s, w * s) * mk_all + lr_up * (1.0 - mk_all)
        x_lr = self.encoder_lr(lr_all).reshape(b, t, -1, h, w)
        x_hr = self.encoder_hr(torch.cat([blend, lr_up], dim=1)).reshape(b, t, -1, h * s, w * s)
        state, out = self.step0(lrs[:, 0], x_lr[:, 0], x_hr[:, 0], mks[:, 0])
        outs = [out]
        use_ckpt = checkpoint and torch.is_grad_enabled()
        for i in range(1, t):
            args = (*state, lrs[:, i], x_lr[:, i], x_hr[:, i], mks[:, i], flows[:, i - 1])
            if use_ckpt:
                state, out = torch.utils.checkpoint.checkpoint(self.step, *args,
                                                               use_reentrant=False)
            else:
                state, out = self.step(*args)
            outs.append(out)
        return torch.stack(outs, dim=1)


def charbonnier(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean ``sqrt((pred - target)^2 + 1e-12)``."""
    return torch.sqrt((pred - target) ** 2 + 1e-12).mean()


def lr_at(base: float, count: int, period: int, min_lr: float) -> float:
    """The cosine schedule of one restart period at update ``count``."""
    alpha = min(count / period, 1.0)
    return min_lr + 0.5 * (base - min_lr) * (math.cos(math.pi * alpha) + 1.0)


def is_flow(name: str) -> bool:
    """The flow group: every parameter of the flow net."""
    return name.startswith("spynet.")


@torch.no_grad()
def adam_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                moments: dict[str, tuple[torch.Tensor, torch.Tensor]], t: int,
                lrs: tuple[float, float], betas=(0.9, 0.999), eps: float = 1e-12) -> None:
    """One Adam update in place, update number ``t`` (1 for the first);
    ``lrs``: (trunk, flow) learning rates; ``moments`` is filled on the
    first call."""
    b1, b2 = betas
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for name, p in params.items():
        g = grads[name]
        if name not in moments:
            moments[name] = (torch.zeros_like(p), torch.zeros_like(p))
        m, v = moments[name]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        lr = lrs[1] if is_flow(name) else lrs[0]
        denom = v.sqrt() / math.sqrt(bc2) + eps
        p.addcdiv_(m, denom, value=-lr / bc1)
