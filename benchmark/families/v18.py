"""The v18 family: CRFP's ``MRCF_simple_v18`` (https://github.com/eugenelet/CRFP)
as the benchmark builds it, the port beside its plain reference.

What is measured, from a configuration file's ``model`` fields, in its
``dtype``:

- the streaming model ``crfp_torch.models.runtime.CRFPRuntimeV18``
  (``encode``, ``step0``, ``step``; NHWC), eval mode, against
  ``benchmark/reference/runtime.py::RuntimeV18``;
- the training step ``crfp_torch.train.loop.make_train_step`` over
  ``crfp_torch.models.crfp.CRFP``, with the model and the trainer's settings
  that ``python -m crfp_torch.main`` derives from the configuration's
  ``train_flags`` (the reference's ``train.sh`` line), against
  ``benchmark/reference/trunk.py::Trunk``.

The port's weights are the benchmark's seeded ones, loaded strictly under the
reference's parameter names (``benchmark/reference/names.py``). A family
module is found by the ``family`` key of a configuration file
(``benchmark/manifest.py``); the traffic kinds' modules name what they call
of it (``FAMILY`` in ``benchmark/stream.py`` and ``benchmark/train.py``).
"""

from __future__ import annotations

import torch

from benchmark import manifest
from benchmark.reference.runtime import RuntimeV18, Spec
from benchmark.reference.trunk import Trunk


def spec(cfg: dict, fullgrad: bool = False) -> Spec:
    """The reference's view of a configuration file."""
    m = cfg["model"]
    return Spec(mid=m.get("mid_channels", 32), dg=m.get("deform_groups", 8),
                k=m.get("dcn_kernel", 3), mag=m.get("max_residue_magnitude", 10.0),
                scale=m.get("scale", 8), split=m.get("split_ratio", 3),
                window=m.get("dcn_window"), window_hr=m.get("dcn_window_hr"),
                anchor=m.get("dcn_anchor", False), grid_bf16=cfg["dtype"] == "bfloat16",
                s2d=4 if m.get("hr_s2d", False) else 1, fused=m.get("dcn_fused", False),
                fullgrad=fullgrad)


def model_config(cfg: dict):
    from crfp_torch.models.config import ModelConfig

    return ModelConfig(**cfg["model"])


def train_settings(cfg: dict):
    """(ModelConfig, TrainConfig) as ``python -m crfp_torch.main`` derives
    them from ``cfg['train_flags']``."""
    from crfp_torch.config import model_config as main_model_config
    from crfp_torch.config import parse_args, train_config

    args = parse_args(list(cfg["train_flags"]))
    return main_model_config(args), train_config(args)


# stream side


def stream_reference(cfg: dict, mix: dict) -> RuntimeV18:
    """The plain streaming model over the mix's ``warp_hw`` ROI, on the meta
    device (``encode``, ``step0``, ``step``; NCHW)."""
    return RuntimeV18(spec(cfg), mix["warp_hw"])


def stream_program(cfg: dict, mix: dict, weights: dict[str, torch.Tensor], device):
    """The port's streaming model over the mix's ``warp_hw`` ROI on ``device``,
    in the configuration's dtype, with ``weights`` loaded strictly."""
    from crfp_torch.models.runtime import CRFPRuntimeV18

    model = CRFPRuntimeV18(model_config(cfg), warp_size=tuple(mix["warp_hw"]), device=device)
    model.load_state_dict(weights, strict=True)
    return model.to(manifest.DTYPES[cfg["dtype"]]).eval()


def stream_inputs(pool: dict, mix: dict) -> dict:
    """The model's inputs for each pool frame: v18 takes the LR frame and the
    fovea patch as the pool holds them."""
    return pool


def state_nchw(state: dict) -> dict:
    """The port's carried state (HR and the three level states, NHWC) in the
    reference's form: NCHW float32."""
    def nchw(t):
        return t.permute(0, 3, 1, 2).float()

    return {"hr": nchw(state["hr"]), "lv": tuple(nchw(t) for t in state["lv"])}


# train side


def train_reference(cfg: dict) -> Trunk:
    """The plain batch trunk on the meta device, with the training grid of an
    anchored backward where the configuration asks for one."""
    return Trunk(spec(cfg, fullgrad=cfg["model"].get("dcn_anchor_vjp", False)))


def train_program(cfg: dict, weights: dict[str, torch.Tensor], device):
    """(model, optimizer, train_step, TrainConfig) of the training entry on
    ``device`` with ``weights`` loaded strictly (float32 masters)."""
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.train.loop import make_optimizer, make_train_step

    mcfg, tcfg = train_settings(cfg)
    model = CRFP(mcfg, device=device)
    model.load_state_dict(weights, strict=True)
    return model, make_optimizer(model, tcfg), make_train_step(model, tcfg), tcfg


def train_loss():
    """(owner, attribute) of the loss that the train step calls, where the
    half-batch fault patches it."""
    import crfp_torch.train.loop as loop

    return loop, "charbonnier_loss"
