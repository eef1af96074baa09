"""The v18 training step on the GPU: a clip pool made from a numpy seed and
the step's time at the recipe of record.

The recipe (checkpoints/v18_mid32_struct_curve.json): mid 32, B 2, T 7,
GT 192 (LR 24x24), windows 8/32, remat, amp (bf16 compute, f32 masters).
The clips are filtered noise translated by a whole number of HR pixels per
frame, so they need neither Pillow nor the procedural corpus; LR frames are
box means, masks a Nanascan of (GT/2)^2 patches
(``crfp_torch.tools.train_procedural.make_batch``).

:func:`run_train_bench` times the step with CUDA events after a warm-up,
on batches already on the card, and reports ms/step, training frames/s
(B*T frames per step) and peak device memory. ``anchor=True`` times the
same step with per-cell anchored HR windows on the training grid
(``dcn_anchor`` + ``dcn_anchor_vjp``, the full-resolution grid as
``train_procedural --dcn_anchor`` trains it; ``hr_s2d`` selects the s2d
one), so that its ms can be read beside the clamped step's.
"""

from __future__ import annotations

import numpy as np
import torch

from crfp_torch.models.config import ModelConfig
from crfp_torch.models.crfp import CRFP
from crfp_torch.params import from_jax, load_npz
from crfp_torch.tools.train_procedural import make_batch, variant_hr_dcn
from crfp_torch.train.loop import TrainConfig, make_optimizer, make_train_step

RECIPE = dict(b=2, t=7, gt=192, mid=32, dcn_window=8, dcn_window_hr=32)


def _blur(a: np.ndarray, r: int, axis: int) -> np.ndarray:
    """Box filter of radius ``r`` along ``axis`` (edge-padded), by cumsum."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (r + 1, r)
    c = np.cumsum(np.pad(a, pad, mode="edge"), axis=axis)
    hi = np.take(c, np.arange(2 * r + 1, c.shape[axis]), axis=axis)
    lo = np.take(c, np.arange(0, c.shape[axis] - 2 * r - 1), axis=axis)
    return (hi - lo) / (2 * r + 1)


def noise_clip_pool(n: int, t: int, gt: int, seed: int, scale: int = 8,
                    v_max: float = 2.0) -> list[np.ndarray]:
    """``n`` clips (t, gt, gt, 3) float32 in [0, 1]: noise filtered at two
    scales, translated by a per-clip velocity of at most ``v_max`` LR
    pixels per frame (whole HR pixels)."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil((t - 1) * v_max * scale)) + 2
    size = gt + 2 * pad
    clips = []
    for _ in range(n):
        canvas = np.zeros((size, size, 3))
        for r, amp in ((int(rng.integers(6, 16)), 1.0), (int(rng.integers(1, 3)), 0.35)):
            a = rng.standard_normal((size, size, 3))
            for _ in range(2):
                a = _blur(_blur(a, r, 0), r, 1)
            canvas += amp * a / a.std()
        canvas = (canvas - canvas.min()) / (canvas.max() - canvas.min())
        v = rng.uniform(-v_max, v_max, 2) * scale
        frames = []
        for k in range(t):
            y0, x0 = (pad + np.round(k * v)).astype(int)
            frames.append(canvas[y0:y0 + gt, x0:x0 + gt])
        clips.append(np.stack(frames).astype(np.float32))
    return clips


def device_batches(n: int, seed: int, v_max: float = 2.0) -> list[dict[str, torch.Tensor]]:
    """``n`` training batches of the recipe's shapes from the noise pool
    (clips moving up to ``v_max`` LR pixels a frame), as tensors on the
    card."""
    b, t, gt = RECIPE["b"], RECIPE["t"], RECIPE["gt"]
    clips = noise_clip_pool(max(4, b), t, gt, seed, v_max=v_max)
    rng = np.random.default_rng(seed + 1)
    return [{k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in make_batch(clips, b, t, gt, rng).items()} for _ in range(n)]


def build_trainer(amp: bool, ckpt: str | None = None, seed: int = 0,
                  variant: str = "v18", flow_net: str = "fnet", group=None,
                  anchor: bool = False, hr_s2d: bool = False, **tcfg):
    """(model, optimizer, train_step) of the recipe's CRFP of ``variant`` and
    ``flow_net`` on the card (``hr_dcn`` as train_procedural sets it);
    weights from ``ckpt`` (strict) or from ``seed``; ``tcfg`` overrides
    fields of TrainConfig (the flow net is not frozen by default).
    ``group``: the data-parallel step over a group or mesh of ranks
    (``make_train_step``); the caller makes the weights equal on every rank.
    ``anchor``: anchored HR windows on the training grid (``hr_s2d``: the
    s2d(4) tail's grid for the HR warp)."""
    cfg = ModelConfig(variant=variant, hr_dcn=variant_hr_dcn(variant),
                      mid_channels=RECIPE["mid"], dcn_window=RECIPE["dcn_window"],
                      dcn_window_hr=RECIPE["dcn_window_hr"], remat=True, flow_net=flow_net,
                      dcn_anchor=anchor, dcn_anchor_vjp=anchor, hr_s2d=hr_s2d)
    model = CRFP(cfg, device="cuda", seed=seed)
    if ckpt is not None:
        model.load_state_dict(from_jax(load_npz(ckpt)), strict=True)
    tc = TrainConfig(amp=amp, **{"flow_freeze_iters": 0, **tcfg})
    return model, make_optimizer(model, tc), make_train_step(model, tc, group)


def warmed_trainer(warmup: int, steps: int, seed: int = 0, **build_kw):
    """(optimizer, train_step, batches) of the amp recipe, random weights
    from ``seed``, after ``warmup`` steps on the first batches; the batches
    from index ``warmup`` on are ``steps`` more; ``build_kw``: more of
    :func:`build_trainer`'s arguments (``anchor``). CUDA only."""
    if not torch.cuda.is_available():
        raise RuntimeError("the train bench needs a CUDA device")
    _, opt, step = build_trainer(amp=True, seed=seed, **build_kw)
    batches = device_batches(warmup + steps, seed)
    for i in range(warmup):
        step(opt, batches[i], i)
    torch.cuda.synchronize()
    return opt, step, batches


def run_train_bench(steps: int = 10, warmup: int = 3, seed: int = 0,
                    anchor: bool = False, hr_s2d: bool = False) -> dict:
    """ms/step, frames/s and peak memory of the amp train step at the
    recipe, random weights from ``seed``; ``anchor``: with anchored HR
    windows on the training grid (``hr_s2d``: the s2d(4) tail's grid for the
    HR warp). CUDA only."""
    r = RECIPE
    opt, step, batches = warmed_trainer(warmup, steps, seed, anchor=anchor, hr_s2d=hr_s2d)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(warmup, warmup + steps):
        metrics = step(opt, batches[i], i)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    return {
        "device": torch.cuda.get_device_name(0), **r, "amp": True, "anchor": anchor, "hr_s2d": hr_s2d,
        "steps": steps,
        "ms_per_step": ms, "frames_per_s": r["b"] * r["t"] / (ms / 1e3),
        "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
        "last_loss": float(metrics["loss"]),
    }
