"""Step-indexed checkpoints of the train state: the model's parameters,
both Adam groups' state and the step (crfp_tpu/train/checkpoint.py).

The JAX package writes orbax. The port writes torch state, one step
directory per save: ``<directory>/<step>/state.pt`` holds ``{"model":
state_dict, "optimizer": Adam state_dict, "step": int}``. A save is written
under a temporary name and renamed into place, so a directory named by a
step is always complete. ``main.py``'s eval mode loads every entry of
``--model_path``, so a manager root evaluates each saved step.
"""

from __future__ import annotations

import os
import shutil

import torch
from torch import nn

STATE_FILE = "state.pt"


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(e) for e in os.listdir(directory)
                  if e.isdigit() and os.path.isfile(os.path.join(directory, e, STATE_FILE)))


def read_state(path: str) -> dict | None:
    """The saved ``{"model", "optimizer", "step"}`` of a step directory, or of
    the latest step under a manager root, on the host; None where ``path``
    holds neither."""
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=True)
    steps = _steps(path)
    if not steps:
        return None
    return read_state(os.path.join(path, str(steps[-1])))


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return _steps(self.directory)

    def save(self, step: int, model: nn.Module, optimizer: torch.optim.Optimizer) -> bool:
        """Write step ``step``; False (and nothing written) when that step is
        already saved, as orbax's manager skips it."""
        if step in self.all_steps():
            return False
        tmp = os.path.join(self.directory, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                    "step": int(step)}, os.path.join(tmp, STATE_FILE))
        os.replace(tmp, os.path.join(self.directory, str(step)))
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                step: int | None = None) -> int | None:
        """Load step ``step`` (default the latest) into ``model`` and
        ``optimizer``; returns the restored step, None where nothing is saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        # read to the host: load_state_dict copies each tensor to its
        # parameter's device, and Adam keeps its step counts on the host
        state = read_state(os.path.join(self.directory, str(step)))
        model.load_state_dict(state["model"], strict=True)
        optimizer.load_state_dict(state["optimizer"])
        return state["step"]

    def close(self) -> None:
        """Nothing to flush: every save is complete when ``save`` returns."""
