"""Latency and quality harnesses of the port on the GPU."""

from __future__ import annotations

import subprocess

import torch


def device_of(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' (--cpu) to run on the CPU")
    return device


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card), or why they could not be read."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not run ({e})"
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if lines else f"nvidia-smi: {r.stderr.strip()}"
