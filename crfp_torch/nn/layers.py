"""Core conv blocks, NCHW (crfp_tpu/nn/layers.py:29-216), plain layout only.

Module and parameter names follow the JAX package's flax tree, so a flat
``.npz`` checkpoint maps name for name (``crfp_torch/params.py``): flax
``a/b/conv/kernel`` is ``a.b.conv.weight`` here. The space-to-depth conv
forms of the JAX package (``ConvS2D``, ``ConvOutS2D``) are TPU layouts of
the same convs and are not carried.

Initialisation (:func:`init_parameters`, from an explicit
``torch.Generator``) follows the JAX package's: torch's Conv2d default for
plain convs, kaiming-normal (fan_in) for the shuffle packs and 0.1-scaled
for residual blocks, zeros for the DCN offset/mask heads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from crfp_torch.ops.shuffle import pixel_shuffle, pixel_unshuffle


def lrelu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


class Conv(nn.Module):
    """k x k conv padded by k // 2 on each side (stride 1: 'same'; PCD's
    pyramid takes stride 2), holding an ``nn.Conv2d`` named ``conv``.

    ``init``: 'torch' (U(±1/sqrt(fan_in)) for weight and bias), 'kaiming'
    (normal, std sqrt(2/fan_in)*init_scale; torch's bias init) or 'zeros'."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 init: str = "torch", init_scale: float = 1.0, stride: int = 1):
        super().__init__()
        assert init in ("torch", "kaiming", "zeros"), init
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=kernel_size // 2)
        self.init = init
        self.init_scale = init_scale

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        w, b = self.conv.weight, self.conv.bias
        if self.init == "zeros":
            w.zero_()
            b.zero_()
            return
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        bound = 1.0 / math.sqrt(fan_in)
        if self.init == "kaiming":
            std = math.sqrt(2.0 / fan_in) * self.init_scale
            w.copy_(torch.randn(w.shape, generator=generator) * std)
        else:
            w.copy_(torch.rand(w.shape, generator=generator) * (2 * bound) - bound)
        b.copy_(torch.rand(b.shape, generator=generator) * (2 * bound) - bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise ``module`` and every submodule that defines
    ``init_parameters`` (in registration order) from ``generator``. The
    module must be on the CPU."""
    for m in module.modules():
        if hasattr(m, "init_parameters"):
            m.init_parameters(generator)


class ResidualBlockNoBN(nn.Module):
    """conv-relu-conv + x."""

    def __init__(self, mid_channels: int):
        super().__init__()
        self.conv1 = Conv(mid_channels, mid_channels, init="kaiming", init_scale=0.1)
        self.conv2 = Conv(mid_channels, mid_channels, init="kaiming", init_scale=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(x)))


class ResidualBlocksWithInputConv(nn.Module):
    """input conv + lrelu + ``num_blocks`` residual blocks."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int = 1):
        super().__init__()
        self.input_conv = Conv(in_channels, out_channels)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", ResidualBlockNoBN(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = lrelu(self.input_conv(x))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class PixelShufflePack(nn.Module):
    """conv(c -> out*s^2) then depth-to-space by s."""

    def __init__(self, in_channels: int, out_channels: int, scale_factor: int,
                 upsample_kernel: int = 3):
        super().__init__()
        self.scale_factor = scale_factor
        self.upsample_conv = Conv(in_channels, out_channels * scale_factor ** 2,
                                  upsample_kernel, init="kaiming")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(self.upsample_conv(x), self.scale_factor)


class PixelUnShufflePackV2(nn.Module):
    """space-to-depth by s then conv(c*s^2 -> out)."""

    def __init__(self, in_channels: int, out_channels: int, scale_factor: int,
                 downsample_kernel: int = 3):
        super().__init__()
        self.scale_factor = scale_factor
        self.downsample_conv = Conv(in_channels * scale_factor ** 2, out_channels,
                                    downsample_kernel, init="kaiming")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.downsample_conv(pixel_unshuffle(x, self.scale_factor))
