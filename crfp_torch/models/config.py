"""Model configuration: the fields of ``crfp_tpu.models.crfp.ModelConfig``
that the logical math reads (crfp_tpu/models/crfp.py:67-154), and the
rules that the JAX trunk asserts on them (:160-187).

The TPU layout switches of the JAX config (``lv3_s2d``, ``emit_s2d``) are
not carried: the port always computes the plain layout. ``dcn_fused`` is
carried: it is a dispatch knob with the same math and the same
parameters. ``dcn_anchor`` is carried: per-cell anchored windows are math,
not a layout (they sample past ±dcn_window_hr), and so is ``hr_s2d`` as
the selector of the HR state warp's cell grid (band 64 at full
resolution, 32 in the JAX package's s2d(4) form), and ``dcn_anchor_vjp``
as the selector of the training grid.
"""

from __future__ import annotations

import dataclasses

VARIANTS = ("v13", "v15", "v18", "v18_cra", "no_dcn", "basic_fvsr")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    variant: str = "v18"
    mid_channels: int = 32
    scale: int = 8
    y_only: bool = False
    # the HR-level cascade: dcn_3 in repeat mode on the 8x state. Without it
    # (v13/v15, and the only path of no_dcn and basic_fvsr) dcn_3 is a
    # per-tap stage at 1/4 size and the trunk upsamples after it
    hr_dcn: bool = True
    offset_prop: bool = True
    split_ratio: int = 3
    deform_groups: int = 8
    dcn_kernel: int = 3
    max_residue_magnitude: float = 10.0
    # sample displacements of the 1/4-res alignment stages and the lv-state
    # warp clamp to +-dcn_window pixels (the windowed CUDA kernels); None =
    # exact, unclamped plain version
    dcn_window: int | None = None
    # the same for the HR-level dcn_3 and the HR state warp
    dcn_window_hr: int | None = None
    # the batch trunk's flow net, 'fnet' or 'spynet' (crfp_tpu/models/crfp.py:78)
    flow_net: str = "fnet"
    # recompute each recurrent step of the batch trunk in the backward pass
    # (torch.utils.checkpoint, non-reentrant) instead of keeping its
    # activations: the JAX package's nn.remat of the scan body
    remat: bool = False
    # the 1/4-res alignment stages (dcn_0/1/2) take the offset and mask
    # heads' raw outputs in one launch (kernel E, crfp_torch/csrc/dcn_fused.cu)
    # instead of a PyTorch prologue and kernel A. Inference only: a step
    # that autograd records takes the structured path. Needs dcn_window
    # (crfp_tpu/models/crfp.py:175-177). The parameter tree is the same.
    dcn_fused: bool = False
    # per-cell anchored windows for the HR-level windowed ops (dcn_3 and the
    # HR state warp; crfp_tpu/models/crfp.py:104-111): each cell of the TPU
    # kernel's grid samples around the cell's quantized mean displacement,
    # exact to anchor +- residual, past +-dcn_window_hr
    # (crfp_torch/ops/anchor.py). No effect without dcn_window_hr, as in
    # the JAX package
    dcn_anchor: bool = False
    # train the anchored ops on the cell grid that JAX's anchored backward
    # resolves (the backward's VMEM factors, crfp_tpu/models/crfp.py:112-120):
    # the training entry points set it, inference (the runtime models, the
    # deploy gate, the benches, eval and test) keeps the inference grid.
    # Needs dcn_anchor (:173-174)
    dcn_anchor_vjp: bool = False
    # the JAX package's s2d(4) HR tail. The port computes the plain layout
    # (the same math); under dcn_anchor it selects the cell grid of the
    # anchored HR state warp as JAX's s2d kernel resolves it (dcn_3's grid
    # is the same in both forms). Same rules as JAX's
    hr_s2d: bool = False

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"variant={self.variant!r} (one of {VARIANTS})")
        if self.is_dsv and not self.hr_dcn:
            raise ValueError("the DSV trunk (v18, v18_cra) always runs the HR-level "
                             "DCN (hr_dcn=True)")
        if self.variant in ("no_dcn", "basic_fvsr") and self.hr_dcn:
            # the reference's hr_dcn=True branches of these two read undefined
            # locals; only hr_dcn=False ever ran (crfp_tpu/models/crfp.py:183-187)
            raise ValueError(f"{self.variant} only supports hr_dcn=False")
        if self.dcn_anchor_vjp and not self.dcn_anchor:
            raise ValueError("dcn_anchor_vjp trains the anchored path: set dcn_anchor")
        if self.dcn_fused and self.dcn_window is None:
            raise ValueError("dcn_fused is a windowed-kernel dispatch mode: "
                             "set dcn_window")
        if self.hr_s2d and (self.variant not in ("v13", "v15", "v18") or not self.hr_dcn):
            # crfp_tpu/models/crfp.py:163-166
            raise ValueError("hr_s2d is defined for the v13/v15/v18 trunks with hr_dcn")
        if self.flow_net not in ("fnet", "spynet"):
            raise ValueError(f"flow_net={self.flow_net!r} (expected 'fnet' or 'spynet')")

    @property
    def anchor_s2d(self) -> int:
        """The s2d factor whose anchored cell grid the HR state warp takes."""
        return 4 if self.hr_s2d else 1

    @property
    def is_dsv(self) -> bool:
        """The channel-split (DSV) trunk with per-level persistent states."""
        return self.variant in ("v18", "v18_cra")

    @property
    def last_channels(self) -> int:
        return self.mid_channels // 8

    @property
    def keep_channels(self) -> int:
        """Channels continuing down the cascade in the DSV split (v18)."""
        return (self.mid_channels * self.split_ratio) // 4

    @property
    def state_channels(self) -> int:
        """Per-level persistent state channels in the DSV split (v18)."""
        return (self.mid_channels * (4 - self.split_ratio)) // 4
