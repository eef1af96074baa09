"""Data parallelism over ``torch.distributed`` (crfp_tpu/parallel/sharding.py).

The JAX package builds a 1-D ``data`` mesh over devices, shards each
global batch over it and lets XLA emit the gradient all-reduce. Here a
device is a rank (one process per card): the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks with its one
axis named ``data``, :func:`shard_batch` gives a rank its rows of the
global batch, :func:`replicate` broadcasts a module's parameters and
buffers from rank 0, and the train step all-reduces the gradients itself
(``crfp_torch/train/loop.py``).

:func:`initialize_distributed` is the multi-process bring-up: NCCL when the
ranks own CUDA devices, gloo on the CPU (or where the caller asks for it).
There is no fallback: a failed initialisation raises.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def free_port() -> int:
    """A free TCP port on localhost (for ``tcp://localhost:<port>``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _need_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; pass device='cpu' to run on the CPU")


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    device: str | None = None,
    timeout_s: float = 1800.0,
) -> bool:
    """Multi-process bring-up over ``torch.distributed.init_process_group``.

    Keys on the explicit arguments (``init_method`` such as
    ``tcp://localhost:29500``, ``world_size``, ``rank``) or, without them, on
    the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``;
    ``LOCAL_RANK`` picks the card). Without either it is a no-op returning
    False, so callers may call it unconditionally. ``device``: 'cuda'
    (the default; without a card it raises) selects the card ``local rank %
    cards`` with ``torch.cuda.set_device`` and the NCCL backend; 'cpu' takes
    gloo.
    ``backend`` overrides the choice (gloo also takes CUDA tensors, which
    lets several ranks share one card). A genuine failure raises; only a
    second initialisation of an already initialised group is tolerated.
    Returns True when the group spans more than one process."""
    explicit = init_method is not None
    if not explicit and not all(os.environ.get(k) for k in _ENV):
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if explicit and (world_size is None or rank is None):
        raise ValueError("initialize_distributed: init_method needs world_size and rank")
    device = device or "cuda"
    if device == "cuda":
        _need_card("initialize_distributed")
        local = int(os.environ.get("LOCAL_RANK", rank if explicit else os.environ["RANK"]))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    kw: dict[str, Any] = {"backend": backend,
                          "timeout": datetime.timedelta(seconds=timeout_s)}
    if explicit:
        kw.update(init_method=init_method, world_size=world_size, rank=rank)
    dist.init_process_group(**kw)
    return dist.get_world_size() > 1


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_parallel_mesh(n_ranks: int | None = None) -> DeviceMesh:
    """A 1-D ``data`` mesh over the first ``n_ranks`` ranks (all of them when
    None or when fewer exist), as ``data_parallel_mesh`` takes
    ``jax.devices()[:n]``. Needs an initialised process group; every rank of
    the world calls it (a mesh smaller than the world makes a new group)."""
    if not dist.is_initialized():
        raise RuntimeError("data_parallel_mesh: no process group; call "
                           "initialize_distributed first")
    world = dist.get_world_size()
    n = world if n_ranks is None else min(n_ranks, world)
    return DeviceMesh(_mesh_device_type(), list(range(n)), mesh_dim_names=("data",))


def global_mesh(axis: str = "data") -> DeviceMesh:
    """The 1-D mesh over every rank of every host (after
    :func:`initialize_distributed`); :func:`data_parallel_mesh` of all."""
    return DeviceMesh(_mesh_device_type(), list(range(dist.get_world_size())),
                      mesh_dim_names=(axis,))


def group_of(mesh: DeviceMesh | dist.ProcessGroup | None) -> dist.ProcessGroup | None:
    """The process group behind a mesh's one axis (a group passes through)."""
    if isinstance(mesh, DeviceMesh):
        return mesh.get_group(mesh.mesh_dim_names[0])
    return mesh


def shard_batch(batch: dict, mesh, device: torch.device | str | None = None) -> dict:
    """This rank's rows of a global batch (leading axis B), on ``device``
    (the current card by default; without a card it raises). Every
    rank holds B / world rows, in rank order; B must divide evenly, as JAX's
    ``device_put`` onto ``P('data')`` requires. Values: tensors or numpy
    arrays; they become float32 tensors."""
    if device is None:
        _need_card("shard_batch")
        device = torch.device("cuda", torch.cuda.current_device())
    group = group_of(mesh)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % world:
            raise ValueError(f"shard_batch: the global batch of {b} does not divide "
                             f"evenly over {world} ranks ('{k}')")
        rows = torch.as_tensor(v)[rank * (b // world):(rank + 1) * (b // world)]
        out[k] = rows.to(device=device, dtype=torch.float32)
    return out


@torch.no_grad()
def replicate(module: nn.Module, mesh) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from the mesh's first
    rank to every rank, in place; returns the module."""
    group = group_of(mesh)
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module
