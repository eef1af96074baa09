"""Every cell's readings at ``tiny.py``'s sizes on the CPU, pinned bit for bit
to what the harness read before its model-specific code moved into
``benchmark/families/`` (``pinned.json``, two seeds a cell): the seeded
weights and the pool (by checksum), the counted FLOPs and DCN-stage bounds
behind ``mfu.*`` and ``dcn_roofline.*``, the ``checks`` numbers of a run
whose window is 0 s, so that the frames it keeps do not hang on the clock,
and at one seed the control's numbers and the checks under each fault."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch

from benchmark import generate, manifest
from benchmark.run import execute
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
PINNED = json.loads(Path(__file__).with_name("pinned.json").read_text())


def digest(named) -> str:
    """sha256 over each (name, tensor): its name, shape, dtype and bytes."""
    h = hashlib.sha256()
    for name, t in named:
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("key", sorted(k for k in PINNED if not k.startswith("_")))
def test_readings_are_the_pinned_ones(key):
    name, seed = key.split("/")
    seed = int(seed)
    want = PINNED[key]
    cell = tiny_cell(name)
    kind_mod = manifest.kind_module(cell["traffic"]["kind"])
    weights = kind_mod.seeded_weights(cell, seed, CPU)
    if cell["traffic"]["kind"] == "stream":
        pool = kind_mod.inputs(cell, seed, CPU)
        pool_digest = digest((k, pool[k]) for k in ("lr", "fv"))
        counted = kind_mod.counted(cell, pool)
    else:
        pool = generate.train_pool(cell["traffic"], seed, CPU)
        pool_digest = digest((f"{i}.{k}", b[k]) for i, b in enumerate(pool)
                             for k in ("lr", "hr", "fv", "mk"))
        counted = kind_mod.counted(cell, pool[0])
    assert digest(weights.items()) == want["weights"]
    assert pool_digest == want["pool"]
    assert counted == want["counts"]
    line = execute(cell, seed, 0.0, False, CPU)
    assert {k: c["value"] for k, c in line["checks"].items()} == want["checks"]
    assert line["attempted"] == want["attempted"]


@pytest.mark.parametrize("name", sorted({k.split("/")[0] for k in PINNED if not k.startswith("_")}))
def test_control_and_faults_are_the_pinned_ones(name):
    """At seed 7: the control's numbers, and the checks of a run under each
    fault the cell's kind plants."""
    want = PINNED[f"{name}/7"]
    cell = tiny_cell(name)
    kind_mod = manifest.kind_module(cell["traffic"]["kind"])
    control = kind_mod.control(cell, 7, CPU)
    assert {k: v for k, v in control.items() if k != "detail"} == want["control"]
    for fault, make in kind_mod.FAULTS.items():
        cell = tiny_cell(name)
        with make(cell["family"]):
            line = execute(cell, 7, 0.0, False, CPU)
        assert {k: c["value"] for k, c in line["checks"].items()} == want[f"fault_{fault}"], fault
