"""Training step: Charbonnier loss, two-group Adam, flow freeze, amp
(crfp_tpu/train/loop.py).

The recipe of the reference trainer, as the JAX package runs it:
- Adam (beta1 0.9, beta2 0.999, eps 1e-12) over two parameter groups, the
  flow net (every parameter with ``spynet`` in its name) and the trunk
  (the rest), each with its own cosine-restart schedule;
- the flow group frozen for the first ``flow_freeze_iters`` steps. optax's
  freeze wrapper (:78-101) advances neither the flow group's Adam moments
  and step count nor its schedule count while frozen, so the first
  unfrozen step uses bias correction t=1 and ``schedule(0)``. Here the
  flow gradients are dropped while frozen (torch's Adam then leaves those
  parameters and their state alone) and the schedule count is offset by
  hand;
- loss: mean Charbonnier ``sqrt(diff^2 + 1e-12)``;
- ``amp``: the forward and backward in bfloat16 on bf16 casts of the f32
  master parameters (``torch.func.functional_call``), the output cast
  back to f32 for the loss, so gradients, moments and the loss stay f32
  (:142-152). The backward runs inside that call, so a step that
  ``remat`` recomputes sees the same bf16 parameters. No ``autocast``: it
  keeps some ops in f32, which would be another computation;
- per-step PSNR/SSIM in RGB and in the metric luma, on the detached output
  with an all-ones mask (:161-173).

Data parallelism (``group``, the JAX step's ``mesh``, :176-186): each rank
steps on its equal share of the global batch (``crfp_torch.parallel.
shard_batch``) from the same parameters. After the backward, the gradients
are summed over the ranks in flat buckets and divided by the world size,
which is the gradient of the global mean loss, as XLA's all-reduce gives
it; then the flow-freeze drop and Adam run on every rank alike. There is
no ``DistributedDataParallel``: the amp path calls the model through
``functional_call`` on bf16 casts, which DDP's forward hooks never see.
The loss is the all-reduced mean, and PSNR/SSIM are reduced as ratios of
global sums (``crfp_torch/ops/metrics.py``), so every rank reports the
global batch's numbers.

Spans (``crfp_torch.trace``, on only under a profiler session that records
CPU activity): ``crfp.train.step`` is the unit span; inside it
``crfp.train.optimizer`` (the schedules and ``zero_grad``; later the
flow-freeze drop and ``opt.step()``), ``crfp.train.forward`` (the model and
the loss), ``crfp.train.backward`` (``loss.backward()``, remat's recompute
included), ``crfp.train.allreduce`` (more than one rank) and
``crfp.train.metrics`` (the four PSNR/SSIM passes).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from crfp_torch.ops.color import bgr2ycbcr_y
from crfp_torch.ops.metrics import masked_psnr, masked_ssim
from crfp_torch.parallel.sharding import group_of
from crfp_torch.trace import span
from crfp_torch.train.schedule import cosine_restart_schedule


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     weight: torch.Tensor | None = None, eps: float = 1e-12) -> torch.Tensor:
    """Mean Charbonnier, or its ``weight``-masked mean."""
    loss = torch.sqrt((pred - target) ** 2 + eps)
    if weight is None:
        return loss.mean()
    weight = torch.broadcast_to(weight.to(loss.dtype), loss.shape)
    return (loss * weight).sum() / (weight.sum() + 1e-12)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr_rate: float = 2e-4
    lr_rate_flow: float = 2.5e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-12
    periods: Sequence[int] = (600_000,)
    restart_weights: Sequence[float] = (1.0,)
    min_lr: float = 1e-7
    flow_freeze_iters: int = 5000
    rec_w: float = 1.0
    # bf16 forward/backward on casts of the f32 masters (see the module note)
    amp: bool = False


def _is_flow(name: str) -> bool:
    return "spynet" in name


def make_optimizer(model: nn.Module, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with two groups: 0 the trunk, 1 the flow net. The train step
    sets each group's ``lr`` from its schedule before every update."""
    named = list(model.named_parameters())
    trunk = [p for n, p in named if not _is_flow(n)]
    flow = [p for n, p in named if _is_flow(n)]
    return torch.optim.Adam(
        [{"params": trunk, "lr": cfg.lr_rate}, {"params": flow, "lr": cfg.lr_rate_flow}],
        betas=(cfg.beta1, cfg.beta2), eps=cfg.eps)


class _LossBackward(nn.Module):
    """Forward, loss and backward of ``model`` as one module call; returns
    the detached (output, loss)."""

    def __init__(self, model: nn.Module, rec_w: float):
        super().__init__()
        self.model = model
        self.rec_w = rec_w

    def forward(self, lr, fv, mk, hr):
        with span("crfp.train.forward"):
            sr = self.model(lr, fv, mk).float()
            loss = self.rec_w * charbonnier_loss(sr, hr)
        with span("crfp.train.backward"):
            loss.backward()
        return sr.detach(), loss.detach()


def _device_batch(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
            for k, v in batch.items()}


# bytes of one all-reduce bucket of flattened gradients
_BUCKET_BYTES = 25 * 2 ** 20


def _buckets(tensors: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    """Consecutive runs of one dtype and at most ``_BUCKET_BYTES`` each."""
    out: list[list[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if not out or out[-1][0].dtype != t.dtype or size + nbytes > _BUCKET_BYTES:
            out.append([])
            size = 0
        out[-1].append(t)
        size += nbytes
    return out


def all_reduce_gradients(params: list[nn.Parameter], group) -> None:
    """Replace each gradient by its mean over the ranks of ``group``: sums
    over flat buckets, then one division by the world size."""
    world = dist.get_world_size(group)
    grads = [p.grad for p in params if p.grad is not None]
    for bucket in _buckets(grads):
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        for g, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(r)


def make_train_step(model: nn.Module, cfg: TrainConfig, group=None
                    ) -> Callable[[torch.optim.Adam, dict, int], dict[str, torch.Tensor]]:
    """Returns ``train_step(opt, batch, step) -> metrics``.

    ``opt`` comes from :func:`make_optimizer`; ``step`` counts the updates
    made so far (0 for the first). ``batch``: 'lr' (B, T, h, w, 3), 'fv' and
    'hr' (B, T, 8h, 8w, 3), 'mk' (B, T, 8h, 8w, 1), NHWC, tensors or numpy
    arrays; they move to the model's device. The metrics are 0-d float32
    tensors on that device: loss, psnr, ssim, psnr_y, ssim_y.

    ``group``: a process group or a ``data`` mesh
    (``crfp_torch.parallel.data_parallel_mesh``) of more than one rank makes
    the step data-parallel (see the module note): ``batch`` is then this
    rank's shard, and the model must start equal on every rank
    (``crfp_torch.parallel.replicate``). None, or a group of one rank, is the
    single-process step."""
    group = group_of(group)
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    sched_trunk = cosine_restart_schedule(cfg.lr_rate, cfg.periods,
                                          cfg.restart_weights, cfg.min_lr)
    sched_flow = cosine_restart_schedule(cfg.lr_rate_flow, cfg.periods,
                                         cfg.restart_weights, cfg.min_lr)
    flow_params = [p for n, p in model.named_parameters() if _is_flow(n)]
    all_params = list(model.parameters())
    device = next(model.parameters()).device

    loss_backward = _LossBackward(model, cfg.rec_w)

    def forward_backward(b):
        if not cfg.amp:
            return loss_backward(b["lr"], b["fv"], b["mk"], b["hr"])
        params = {f"model.{n}": p.to(torch.bfloat16) for n, p in model.named_parameters()}
        args = tuple(b[k].to(torch.bfloat16) for k in ("lr", "fv", "mk")) + (b["hr"],)
        return torch.func.functional_call(loss_backward, params, args)

    def train_step(opt: torch.optim.Adam, batch: dict, step: int) -> dict[str, torch.Tensor]:
        with span("crfp.train.step", unit=True):
            b = _device_batch(batch, device)
            frozen = step < cfg.flow_freeze_iters
            with span("crfp.train.optimizer"):
                opt.param_groups[0]["lr"] = sched_trunk(step)
                opt.param_groups[1]["lr"] = sched_flow(max(step - cfg.flow_freeze_iters, 0))
                opt.zero_grad(set_to_none=True)
            sr, loss = forward_backward(b)
            if group is not None:
                with span("crfp.train.allreduce"):
                    all_reduce_gradients(all_params, group)
                    dist.all_reduce(loss, group=group)
                    loss = loss / dist.get_world_size(group)
            with span("crfp.train.optimizer"):
                if frozen:
                    for p in flow_params:
                        p.grad = None
                opt.step()

            with span("crfp.train.metrics"), torch.no_grad():
                sr_f = sr.reshape(-1, *sr.shape[2:])
                hr_f = b["hr"].reshape(-1, *sr.shape[2:])
                ones = torch.ones_like(sr_f[..., :1])
                sy, hy = bgr2ycbcr_y(sr_f) / 255.0, bgr2ycbcr_y(hr_f) / 255.0
                return {"loss": loss,
                        "psnr": masked_psnr(sr_f, hr_f, ones, group),
                        "ssim": masked_ssim(sr_f, hr_f, ones, group),
                        "psnr_y": masked_psnr(sy, hy, ones, group),
                        "ssim_y": masked_ssim(sy, hy, ones, group)}

    return train_step
