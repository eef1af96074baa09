"""How ``correct`` is decided, driven on the CPU at a tiny size: a sound run
of the float32 configurations is correct, and a run with the timed path
broken underneath reads ``correct`` false, once for each fault a cell can
have; the control (the reference one precision below the configuration's)
fails the cell's limits. The harness's look for a card is skipped: the
cells run through ``benchmark.run.execute`` on the CPU, where the port runs
its plain versions."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from benchmark import calibrate, manifest, stream, train
from benchmark.run import execute
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")


def _run(name: str, seed: int) -> dict:
    return execute(tiny_cell(name), seed, 0.2, False, CPU)


def _family(name: str):
    return tiny_cell(name)["family"]


@pytest.mark.parametrize("name", ["ref.streams4_1080p", "ref.train_sh"])
def test_sound_run_is_correct(name):
    line = _run(name, 31)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name,fault", [
    ("deploy.streams4_1080p", "state"), ("deploy.streams4_1080p", "answer"),
    ("ref.streams4_1080p", "state"), ("ref.streams4_1080p", "answer")])
def test_stream_fault_is_not_correct(name, fault):
    with stream.FAULTS[fault](_family(name)):
        line = _run(name, 32)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["half", "answer", "state"])
def test_train_fault_is_not_correct(fault):
    if fault == "state":
        ctx = calibrate.patched(torch.optim.Adam, "step", lambda self, closure=None: None)
    else:
        ctx = train.FAULTS[fault](_family("ref.train_sh"))
    with ctx:
        line = _run("ref.train_sh", 33)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", ["deploy.streams4_1080p", "ref.streams4_1080p", "ref.train_sh"])
def test_control_fails_the_limits(name):
    cell = tiny_cell(name)
    numbers = manifest.kind_module(cell["traffic"]["kind"]).control(cell, 34, CPU)
    assert any(numbers[k] > v["limit"] for k, v in cell["limits"].items()), numbers


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "deploy.streams4_1080p", "--seed", "1", "--seconds", "1"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
