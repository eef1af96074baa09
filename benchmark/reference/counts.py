"""The benchmark's own operation and byte counts at a cell's shapes, for
``mfu.*`` and ``dcn_roofline.*``.

Both come from the reference run on the ``meta`` device at the cell's
sizes, so that they follow the model's stage shapes and not whatever
implements them:

- model FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the
  reference (convolutions and the DCN contractions; for training the
  forward and the backward, nothing recomputed counted);
- the DCN-stage and warp calls (kernels A, B, E; D for their gradients):
  each call's least time on the card, ``max(bytes / 3.35 TB/s, ops /
  peak)``, with each input read once and each output written once. A DCN
  call reads x, its offsets and mask (float32; the raw heads in x's type
  and the float32 flow where the program computes them inside its kernel),
  the float32 weight and bias, and writes its output in x's type; its ops
  are the contraction's ``2 * N * O * C * k^2 * H * W``. A warp reads x and
  the float32 flow and writes x's type; its ops are the bilinear blend's
  8 a value. A gradient call reads the forward's inputs and the output's
  gradient and writes a gradient of each input that needs one, with twice
  the forward's ops. The ops peak is the tensor cores' bf16 rate for
  bf16 activations and the CUDA cores' float32 rate otherwise.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import ops

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_BF16 = 989e12  # dense tensor-core bf16
PEAK_F32 = 67e12  # CUDA cores


def _item(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def call_bound_s(kind: str, info: dict) -> float:
    """The least time of one recorded call on the card, forward plus, where
    ``info['grad']``, its gradient."""
    xb = _item(info["x_dtype"])
    peak = PEAK_BF16 if info["x_dtype"] == torch.bfloat16 else PEAK_F32
    n, c, h, w = info["n"], info["c"], info["h"], info["w"]
    px = n * h * w
    if kind == "dcn":
        o, g, k2, taps = info["o"], info["g"], info["k2"], info["taps"]
        if info["fused"]:
            heads = px * g * taps * 3 * xb + px * 2 * 4
        else:
            heads = px * g * taps * 3 * 4
        x_in = px * c * xb
        params = (o * c * k2 + o) * 4
        out = px * o * xb
        ops_n = 2 * px * o * c * k2
        fwd = max((x_in + heads + params + out) / HBM_BYTES_PER_S, ops_n / peak)
        if not info["grad"]:
            return fwd
        # reads x, offsets, mask, weight and the output's gradient; writes
        # the gradients of x, offsets, mask, weight and bias
        bwd_bytes = x_in + 2 * heads + 2 * params + out + x_in
        return fwd + max(bwd_bytes / HBM_BYTES_PER_S, 2 * ops_n / peak)
    x_in = px * c * xb
    flow = px * 2 * 4
    ops_n = 8 * px * c
    fwd = max((x_in + flow + x_in) / HBM_BYTES_PER_S, ops_n / peak)
    if not info["grad"]:
        return fwd
    return fwd + max((x_in + flow + x_in + x_in + flow) / HBM_BYTES_PER_S, 2 * ops_n / peak)


def stream_counts(model, lr, fv) -> dict:
    """FLOPs and the DCN-stage bound of one steady step (``encode`` and
    ``step``) and of the streams' first step (``encode`` and ``step0``) of
    the reference streaming ``model`` (built on the meta device) on one
    step's inputs ``lr`` and ``fv`` (NCHW on the meta device, in the served
    dtype)."""
    model = model.to(lr.dtype)
    out = {}
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc, ops.recording() as calls:
            x_lr, x_hr = model.encode(lr, fv)
            state, _ = model.step0(lr, x_lr, x_hr)
        out["flops_first"] = fc.get_total_flops()
        out["bound_s_first"] = sum(call_bound_s(k, i) for k, i in calls)
        with FlopCounterMode(display=False) as fc, ops.recording() as calls:
            x_lr, x_hr = model.encode(lr, fv)
            model.step(state, lr, lr, x_lr, x_hr)
        out["flops_steady"] = fc.get_total_flops()
        out["bound_s_steady"] = sum(call_bound_s(k, i) for k, i in calls)
    return out


def train_counts(model, lrs, fvs, mks, hrs) -> dict:
    """FLOPs (forward and backward) and the DCN-stage bound (forward and
    gradient calls) of one train step of the reference trunk ``model``
    (built on the meta device) on a batch of clips (B, T, C, H, W) NCHW on
    the meta device: LR frames, fovea frames, fovea masks and targets."""
    for p in model.parameters():
        p.requires_grad_(True)
    with FlopCounterMode(display=False) as fc, ops.recording() as calls:
        pred = model(lrs, fvs, mks, checkpoint=False)
        torch.sqrt((pred - hrs) ** 2 + 1e-12).mean().backward()
    return {"flops_step": fc.get_total_flops(),
            "bound_s_step": sum(call_bound_s(k, i) for k, i in calls)}
