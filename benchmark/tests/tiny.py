"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
same configuration, limits and code path, smaller frames and batches."""

from __future__ import annotations

from benchmark import manifest

STREAM = dict(viewers=2, lr_hw=[16, 32], warp_hw=[128, 256], fovea_hw=[16, 16], pool_frames=4,
              stream_frames=5, warmup_frames=3, check_stream_start=2, check_frames=2,
              trace_frames=3)
TRAIN = dict(batch=2, frames=3, gt=128, fovea=64, pool_batches=4, reference_steps=3,
             trace_steps=1)


def tiny_cell(name: str) -> dict:
    cell = manifest.cell(name)
    cell["traffic"].update(TRAIN if cell["traffic"]["kind"] == "train" else STREAM)
    return cell
