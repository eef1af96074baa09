"""The benchmark's seeded weights and the name table that loads them into
both the benchmarked model and the reference.

The reference's modules carry the benchmarked model's parameter names, so
the table is the reference's own ``named_parameters`` order: one name, one
shape, one recipe each. :func:`seeded_weights` draws every parameter from a
generator on the target device in one call, then scales each leaf by its
recipe, so that set-up makes them on the card in the type they are served
in without a loop over the host. The recipes keep the activations of a
deep random network in range and its motion realistic: convs uniform in
``±1/sqrt(fan_in)`` (residual-block convs at a tenth of a He-uniform
bound, shuffle packs at He-uniform), the flow net's last conv scaled so
that its ``256 * tanh`` flow is a few LR pixels, the DCN weight uniform in
``±1/sqrt(C * k * k)``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from benchmark.reference.nets import Conv

# the flow head's scale on top of the plain bound: 256 * tanh of its output
# is then a few LR pixels on the benchmark's frames
FLOW_HEAD_SCALE = 0.01


def _bound(kind: str, fan_in: int) -> float:
    b = 1.0 / math.sqrt(fan_in)
    return {"plain": b, "offset_head": b, "mask_head": b,
            "residual": 0.1 * math.sqrt(6.0 / fan_in), "shuffle": math.sqrt(6.0 / fan_in),
            "flow_head": FLOW_HEAD_SCALE * b}[kind]


def table(model: nn.Module) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, bound) of every parameter of ``model`` (a reference
    module, on any device), in registration order."""
    kinds = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, Conv):
            kinds[f"{mname}.conv.weight"] = kinds[f"{mname}.conv.bias"] = (
                mod.kind, mod.conv.weight.shape[1] * mod.conv.weight.shape[2]
                * mod.conv.weight.shape[3])
    rows = []
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name in kinds:
            kind, fan_in = kinds[name]
            bound = _bound(kind, fan_in) if name.endswith("weight") else 1.0 / math.sqrt(fan_in)
        elif name.endswith("dcn_weight"):
            bound = 1.0 / math.sqrt(shape[1] * shape[2] * shape[3])
        elif name.endswith("dcn_bias"):
            bound = 0.0
        else:
            raise ValueError(f"no weight recipe for {name}")
        rows.append((name, shape, bound))
    return rows


def seeded_weights(rows, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The weights of ``rows`` (:func:`table`) from ``seed``, on ``device``
    in ``dtype``: one uniform draw in [-1, 1) from a generator on the
    device, scaled leaf by leaf through one multiply."""
    device = torch.device(device)
    counts = [math.prod(shape) for _, shape, _ in rows]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.rand(sum(counts), generator=gen, device=device) * 2.0 - 1.0
    bounds = torch.tensor([b for _, _, b in rows], device=device)
    flat = flat * torch.repeat_interleave(bounds, torch.tensor(counts, device=device))
    flat = flat.to(dtype)
    out, start = {}, 0
    for (name, shape, _), n in zip(rows, counts):
        out[name] = flat[start:start + n].view(shape)
        start += n
    return out


def materialize(model: nn.Module, weights: dict[str, torch.Tensor], device,
                dtype=torch.float32) -> nn.Module:
    """The reference ``model`` (built on the meta device) on ``device`` in
    ``dtype`` with ``weights`` loaded strictly."""
    model = model.to_empty(device=device)
    model.load_state_dict({k: v.to(dtype) for k, v in weights.items()}, strict=True)
    return model.to(dtype)
