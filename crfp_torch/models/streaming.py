"""Stateful frame-by-frame inference over the batch trunk's step
(crfp_tpu/models/streaming.py).

The runner holds the model and the per-clip recurrent state; the compute
is the same ``encode_frame`` / ``step0`` / ``step`` the batch forward
loops over, so batch and streaming cannot drift apart. It takes every
variant of ``CRFP``: the state is the variant's dict of tensors and
tuples of tensors (``{"p": 4 states}`` for basic_fvsr, ``{"hr", "lv"}``
for the DSV trunk), and v18_cra's encoder output is a tuple; the runner
only hands them on. The first call
after ``clear_states()`` takes the cold-start path. The JAX runner jits
its two programs and donates the state; here PyTorch runs eagerly under
``torch.no_grad()`` and the previous state is simply dropped.
"""

from __future__ import annotations

import torch

from crfp_torch.models.crfp import CRFP
from crfp_torch.models.layout import nchw


class StreamingRunner:
    """``runner(lr, fv, mk, fg=None)``: one frame in, one 8x frame out, all
    NHWC with the batch dimension: lr (N, h, w, 3), fv (N, 8h, 8w, 3), mk
    and fg (N, 8h, 8w, 1) -> (N, 8h, 8w, 3), or 1 channel with ``y_only``.

    ``model`` carries its own parameters, device and dtype; inputs are
    moved to them (``device="cuda"`` is the model's default). ``use_fg``:
    pass the regional gate to ``step`` (ones when the caller gives none);
    without it ``fg`` is ignored, as in the JAX runner."""

    def __init__(self, model: CRFP, use_fg: bool = False):
        self.model = model.eval()
        self.use_fg = use_fg
        self._state = None
        self._pre_lr: torch.Tensor | None = None

    def clear_states(self) -> None:
        self._state = None
        self._pre_lr = None

    @torch.no_grad()
    def __call__(self, lr, fv, mk, fg=None) -> torch.Tensor:
        p = next(self.model.parameters())
        lr, fv, mk = (nchw(torch.as_tensor(a).to(p.device, p.dtype))
                      for a in (lr, fv, mk))
        model = self.model
        x_lr, x_hr = model.encode_frame(lr, fv, mk)
        if self._state is None:
            self._state, out = model.step0(lr, x_lr, x_hr, mk)
        else:
            if self.use_fg:
                fg = (torch.ones_like(mk) if fg is None
                      else nchw(torch.as_tensor(fg).to(p.device, p.dtype)))
            flow = model.compute_flow(lr, self._pre_lr)
            self._state, out = model.step(self._state, lr, x_lr, x_hr, mk, flow,
                                          fg if self.use_fg else None)
        self._pre_lr = lr
        return out.permute(0, 2, 3, 1)
