"""Runs of the benchmark on a card (marked ``cuda``; they skip without one):
each cell's command for a short window, its last line parsed and correct.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import manifest

M = manifest.load()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in M["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, name, trace):
    out = subprocess.run([sys.executable, *M["command"][1:], "--workload", name, "--seed",
                          "2147483999", "--seconds", "2", "--trace", str(trace)],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    cell = manifest.cell(name)
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    assert {m["name"] for m in wanted} == set(line["metrics"])
