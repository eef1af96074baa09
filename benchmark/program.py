"""The system under test: the PyTorch and CUDA port (``crfp_torch``), built
from a configuration file of the benchmark.

This is the only module of the benchmark that imports the program. It
builds the two entries that the cells drive and loads the benchmark's
seeded weights into them:

- the streaming model ``crfp_torch.models.runtime.CRFPRuntimeV18``
  (``encode``, ``step0``, ``step``; NHWC), from the configuration's
  ``model`` fields, in its ``dtype``, eval mode;
- the training step ``crfp_torch.train.loop.make_train_step`` over
  ``crfp_torch.models.crfp.CRFP``, with the model and the trainer's settings
  that ``python -m crfp_torch.main`` derives from the configuration's
  ``train_flags`` (the reference's ``train.sh`` line).
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_config(cfg: dict):
    from crfp_torch.models.config import ModelConfig

    return ModelConfig(**cfg["model"])


def runtime_model(cfg: dict, warp_hw, weights: dict[str, torch.Tensor], device):
    """The streaming model of ``cfg`` over a ``warp_hw`` ROI on ``device``,
    in the configuration's dtype, with ``weights`` loaded strictly."""
    from crfp_torch.models.runtime import CRFPRuntimeV18

    model = CRFPRuntimeV18(model_config(cfg), warp_size=tuple(warp_hw), device=device)
    model.load_state_dict(weights, strict=True)
    return model.to(DTYPES[cfg["dtype"]]).eval()


def train_settings(cfg: dict):
    """(ModelConfig, TrainConfig) as ``python -m crfp_torch.main`` derives
    them from ``cfg['train_flags']``."""
    from crfp_torch.config import model_config as main_model_config
    from crfp_torch.config import parse_args, train_config

    args = parse_args(list(cfg["train_flags"]))
    return main_model_config(args), train_config(args)


def trainer(cfg: dict, weights: dict[str, torch.Tensor], device):
    """(model, optimizer, train_step) of the training entry on ``device``
    with ``weights`` loaded strictly (float32 masters)."""
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.train.loop import make_optimizer, make_train_step

    mcfg, tcfg = train_settings(cfg)
    model = CRFP(mcfg, device=device)
    model.load_state_dict(weights, strict=True)
    return model, make_optimizer(model, tcfg), make_train_step(model, tcfg), tcfg

