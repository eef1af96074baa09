"""One loader for the checkpoint formats the port reads
(crfp_tpu/utils/params_io.py::load_params).

``load_params(path)`` returns the port's ``state_dict`` (CPU tensors) of:
- a flat flax ``.npz`` (the JAX package's ``save_params_npz``, and what
  ``crfp_torch.tools.train_procedural`` writes), through ``params.from_jax``;
- a reference ``.pt``/``.pth`` file, through
  ``params.load_torch_checkpoint`` (strict);
- a step directory of ``crfp_torch.train.checkpoint.CheckpointManager``,
  or a manager root (its latest step).

Orbax directories raise: reading them needs orbax, which needs JAX. The
JAX package's ``save_params_npz`` writes the same parameters as ``.npz``.
"""

from __future__ import annotations

import os

import torch

from crfp_torch.params import from_jax, load_npz, load_torch_checkpoint
from crfp_torch.train.checkpoint import read_state


def load_params(path: str) -> dict[str, torch.Tensor]:
    """The model's state_dict from ``path`` (see the module note)."""
    if path.endswith(".npz"):
        return from_jax(load_npz(path))
    if path.endswith((".pt", ".pth")):
        return load_torch_checkpoint(path)
    if os.path.isdir(path):
        state = read_state(path)
        if state is not None:
            return state["model"]
        raise ValueError(
            f"{path!r} is not a crfp_torch checkpoint directory (no <step>/state.pt); "
            "an orbax checkpoint needs orbax, which needs JAX: write its parameters "
            "as .npz with crfp_tpu.utils.params_io.save_params_npz")
    raise ValueError(
        f"unrecognized checkpoint: {path!r} (expected .npz, .pt/.pth or a "
        "crfp_torch checkpoint directory)")
