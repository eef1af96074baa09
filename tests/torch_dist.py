"""Rank processes for the port's distributed tests on the CPU.

:func:`run_ranks` spawns ``world`` processes, each a gloo rank of one
``torch.distributed`` group on localhost with one CPU thread, runs a
module-level ``target(rank, world, *args)`` in each and returns their
results in rank order. Every rank gets a join timeout; a rank that times
out or fails fails the test, and no rank outlives the call. The workers
import torch and the port only, never JAX.
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch

JOIN_TIMEOUT_S = 120.0


def _entry(target, rank: int, world: int, port: int, out_dir: str, args: tuple) -> None:
    import torch.distributed as dist

    from crfp_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank, device="cpu",
                           timeout_s=JOIN_TIMEOUT_S)
    try:
        out = target(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(target, world: int, out_dir, *args, timeout: float = JOIN_TIMEOUT_S) -> list:
    """``[target(rank, world, *args) for each rank]``, run in ``world`` gloo
    ranks. ``out_dir``: a directory for the results (``tmp_path``)."""
    import torch.multiprocessing as mp

    from crfp_torch.parallel.sharding import free_port

    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(target, r, world, port, str(out_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
               and all(p.exitcode in (None, 0) for p in procs)):
            time.sleep(0.05)
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0 and r not in late}
    assert not bad, f"ranks exited with codes {bad}"
    if late:
        pytest.fail(f"ranks {late} of {world} did not finish within {timeout} s")
    out = []
    for r in range(world):
        with open(Path(out_dir) / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---- targets ----------------------------------------------------------------

def bringup(rank, world):
    """World, rank, an all-reduce and the data mesh, as each rank sees them."""
    import torch.distributed as dist

    from crfp_torch.parallel import data_parallel_mesh, global_mesh, initialize_distributed

    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    mesh, glob = data_parallel_mesh(world + 3), global_mesh()
    # a second call on an initialised group is tolerated
    again = initialize_distributed("tcp://127.0.0.1:1", world, rank, device="cpu")
    return {"world": dist.get_world_size(), "rank": dist.get_rank(), "sum": float(t),
            "again": again, "mesh": (mesh.size(), mesh.mesh_dim_names),
            "global": (glob.size(), glob.mesh_dim_names),
            "mesh_rank": mesh.get_local_rank("data")}


def torch_crfp(flat, mid: int, **cfg):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax

    model = CRFP(ModelConfig(mid_channels=mid, **cfg), device="cpu")
    model.load_state_dict(from_jax(flat), strict=True)
    return model


def train_steps(rank, world, flat, batch, steps, mid, tcfg):
    """``steps`` port train steps from ``flat``: data-parallel over the
    world's ranks on this rank's shard of ``batch`` (world 1: the whole
    batch in one process). Returns the metrics of each step, the gradient
    norm of the first step's (reduced) gradients and the parameters after
    the last step."""
    import torch.distributed as dist

    from crfp_torch.parallel import data_parallel_mesh, replicate, shard_batch
    from crfp_torch.params import to_jax
    from crfp_torch.train.loop import TrainConfig, make_optimizer, make_train_step

    model = torch_crfp(flat, mid)
    cfg = TrainConfig(**tcfg)
    opt = make_optimizer(model, cfg)
    mesh = data_parallel_mesh(world) if dist.is_initialized() else None
    if mesh is not None:
        replicate(model, mesh)
    step = make_train_step(model, cfg, mesh)
    local = batch if mesh is None else shard_batch(batch, mesh, "cpu")
    metrics, gnorm = [], None
    for i in range(steps):
        m = step(opt, local, i)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            gnorm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                         for p in model.parameters())))
    params = {k: np.asarray(v) for k, v in to_jax(model.state_dict()).items()}
    return {"metrics": metrics, "gnorm": gnorm, "params": params}


def uneven_batch(rank, world, batch):
    """The error ``shard_batch`` raises on a batch the world does not divide."""
    from crfp_torch.parallel import shard_batch

    try:
        shard_batch(batch, None, "cpu")
    except ValueError as e:
        return str(e)
    return None


def halos(rank, world, x, conv_x, weight, bias):
    """Each rank's ``halo_exchange`` of its band of ``x`` (zeros and
    replicate edges), its band of ``sharded_conv3x3`` over ``conv_x``, and
    ``shard_frame_height`` on 90 and 92 rows."""
    import torch.distributed as dist

    from crfp_torch.parallel import halo_exchange, shard_frame_height, sharded_conv3x3

    band = shard_frame_height(torch.from_numpy(x), None)
    out = {"halo": halo_exchange(band, 1, None).numpy(),
           "halo_replicate": halo_exchange(band, 1, None, edge="replicate").numpy(),
           "conv": sharded_conv3x3(shard_frame_height(torch.from_numpy(conv_x)),
                                   torch.from_numpy(weight), torch.from_numpy(bias),
                                   dist.group.WORLD).numpy()}
    for h in (90, 92):
        try:
            out[f"rows{h}"] = tuple(shard_frame_height(torch.zeros(1, h, 160, 3)).shape)
        except ValueError as e:
            out[f"rows{h}"] = str(e)
    return out


def _no_halo(x, halo, group=None, axis=1, edge="zeros"):
    """``halo_exchange`` with every halo row zero: no rows of the neighbours."""
    if halo == 0:
        return x
    shape = list(x.shape)
    shape[axis] = halo
    z = x.new_zeros(shape)
    return torch.cat([z, x, z], dim=axis)


def _band_side(self, t, total, at, whole):
    """``_RowBands._side_rows`` that zero-pads every side operand outside
    the band, anchored calls too: the runner before anchored calls took the
    whole frame's offsets, mask and flow."""
    return self._zero_pad(t, total, at)


def spatial_frames(rank, world, flat, mid, cfg, lrs, fvs, mks, no_halo=False,
                   band_side=False):
    """The frames of ``SpatialStreamingRunner`` over the world's ranks and of
    the port's ``StreamingRunner`` in this process, on the same weights.
    ``no_halo``: every halo row zero, which must change the frames;
    ``band_side``: an anchored call's side operands zero outside the band
    (:func:`_band_side`), which must change anchored frames whose cells span
    the bands."""
    from crfp_torch.models.streaming import StreamingRunner
    from crfp_torch.parallel import SpatialStreamingRunner, spatial

    model = torch_crfp(flat, mid, **cfg)
    if no_halo:
        spatial.halo_exchange = _no_halo
    if band_side:
        spatial._RowBands._side_rows = _band_side
    sharded, single = SpatialStreamingRunner(model), StreamingRunner(model)
    got, want = [], []
    for i in range(len(lrs)):
        got.append(sharded(lrs[i], fvs[i], mks[i]).numpy())
        want.append(single(lrs[i], fvs[i], mks[i]).numpy())
    # clear_states restarts the clip: the first frame again
    sharded.clear_states()
    again = sharded(lrs[0], fvs[0], mks[0]).numpy()
    return {"got": got, "want": want, "again": again}


def anchored_side_rows(rank, world, flat, mid, cfg, lrs, fvs, mks):
    """One launch of the ranks for what the anchored calls' side operands
    carry: :func:`anchored_ops` with the whole side operands, then with
    them zero outside the band, then :func:`spatial_frames` of the anchored
    model with them zero outside the band (``band_side`` stays set from
    there on)."""
    exact = anchored_ops(rank, world)
    zeroed = anchored_ops(rank, world, True)
    frames = spatial_frames(rank, world, flat, mid, cfg, lrs, fvs, mks, band_side=True)
    return {"exact": exact, "zeroed": zeroed, "frames": frames}


def anchored_ops(rank, world, band_side=False):
    """An anchored warp and an anchored DCN (shared taps) through the
    runner's row-band mode on this rank's band of a 288-row frame (144 rows
    a rank), on grids of 32-row cells, one of which spans the two bands,
    against the same calls on the whole frame in this process: the largest
    |difference| of each over the band. ``band_side``: the side operands
    zero outside the band (:func:`_band_side`)."""
    from crfp_torch.ops import anchor as an
    from crfp_torch.ops.cuda.dcn import deform_conv2d_windowed
    from crfp_torch.ops.cuda.warp import flow_warp_windowed
    from crfp_torch.parallel import spatial

    if band_side:
        spatial._RowBands._side_rows = _band_side
    gen = torch.Generator().manual_seed(0)
    h, w, c, d = 288, 64, 2, 32
    rows = h // world
    band = slice(rank * rows, (rank + 1) * rows)
    x = torch.randn(1, c, h, w, generator=gen)
    # coherent motion past the window: (dx, dy) about (-40, 37)
    flow = (torch.tensor([-40.0, 37.0]).view(1, 2, 1, 1)
            + torch.rand(1, 2, h, w, generator=gen) * 2 - 1)
    off = flow.flip(1).contiguous()
    mask = torch.rand(1, 1, h, w, generator=gen)
    wt = torch.randn(c, c, 3, 3, generator=gen) * 0.3
    wgeom = an.warp_geometry(h, w, c, d, bf16=False, s2d=4)
    dgeom = an.AnchorGeometry(**{**an.dcn_geometry(h, w, c, c, 1, 3, d, bf16=False,
                                                   shared_taps=True,
                                                   shared_mask=True).__dict__, "band": 32})
    assert wgeom.band == dgeom.band == 32 and rows % 32

    xb, flow_b, off_b, mask_b = (t[:, :, band].contiguous() for t in (x, flow, off, mask))
    kw = dict(max_displacement=d, shared_taps=True, shared_mask=True, anchor=dgeom)
    with spatial._RowBands(None):
        warp_b = flow_warp_windowed(xb, flow_b, d, anchor=wgeom)
        dcn_b = deform_conv2d_windowed(xb, off_b, mask_b, wt, **kw)
    warp_f = flow_warp_windowed(x, flow, d, anchor=wgeom)[:, :, band]
    dcn_f = deform_conv2d_windowed(x, off, mask, wt, **kw)[:, :, band]
    return {"warp": float((warp_b - warp_f).abs().max()),
            "dcn": float((dcn_b - dcn_f).abs().max())}


def refusals(rank, world):
    """What the sharded mode raises on: operations on the row axis, or ones
    it does not know, on a band of rows."""
    import torch.nn.functional as F

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.parallel import SpatialStreamingRunner

    runner = SpatialStreamingRunner(CRFP(ModelConfig(mid_channels=8), device="cpu"))
    x = torch.rand(1, 4, 6, 5)
    cases = {
        "flip rows": lambda: torch.flip(x, [2]),
        "sum over rows": lambda: x.sum(2),
        "pad": lambda: F.pad(x, (1, 1, 1, 1)),
        "cat along rows": lambda: torch.cat([x, x], dim=2),
        "index a row": lambda: x[:, :, 1],
        "nearest resize": lambda: F.interpolate(x, size=(12, 10), mode="nearest"),
        "strided conv": lambda: F.conv2d(x, torch.rand(4, 4, 3, 3), stride=2, padding=1),
        "grid_sample": lambda: F.grid_sample(x, torch.rand(1, 6, 5, 2)),
    }
    out = {}
    for name, fn in cases.items():
        try:
            with runner._mode:
                fn()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    # and what passes: channel ops and a row-preserving reshape
    with runner._mode:
        y = torch.cat(torch.chunk(x, 2, dim=1), dim=1).reshape(1, 2, 2, 6, 5) * 2.0
    out["passes"] = tuple(y.shape)
    # uneven LR heights are refused before any rank computes
    try:
        runner(np.zeros((1, 2 * world + 1, 4, 3), np.float32),
               np.zeros((1, 8 * (2 * world + 1), 32, 3), np.float32),
               np.zeros((1, 8 * (2 * world + 1), 32, 1), np.float32))
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    return out
