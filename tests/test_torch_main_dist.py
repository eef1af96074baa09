"""``python -m crfp_torch.main --num_gpu N`` on the CPU: data-parallel
training over N gloo ranks that the entry point spawns itself.

- ``--cpu true --num_gpu 2`` on procedural clips takes 2 steps: rank 0
  alone writes the one log, the one ``metrics.jsonl`` (a line a step) and
  the checkpoint; the log names a world of 2 and the ranks' parameters end
  bit-equal (the run compares a digest of each rank's and logs it). The
  run is a subprocess in its own session, killed whole on its timeout.
- The same with ``--dcn_anchor true``: the ranks train on the anchored
  training grid.
- ``--num_gpu 3`` with a batch of 2 raises the uneven-batch error before
  any directory is made; under ``torchrun``'s environment a world other
  than the one ``--num_gpu`` asks for raises too.
"""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def _argv(save_dir, num_gpu):
    return ["--save_dir", save_dir, "--reset", "true", "--dataset", "procedural",
            "--procedural_clips", "4", "--variant", "v18", "--mid_channels", "8",
            "--scale", "8", "--GT_size", "64", "--FV_size", "16", "--N_frames", "2",
            "--batch_size", "2", "--num_workers", "1", "--remat", "false",
            "--save_every", "2", "--cpu", "true", "--num_gpu", str(num_gpu)]


def test_two_ranks_train_through_the_entry_point(tmp_path):
    save = str(tmp_path / "exp")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-m", "crfp_torch.main", *_argv(save, 2)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the 2-rank run did not finish within {TIMEOUT_S} s")
    assert proc.returncode == 0, out[-4000:]
    files = sorted(os.listdir(save))
    assert files == ["MRCF.log", "args.txt", "metrics.jsonl", "model"], files
    assert os.listdir(os.path.join(save, "model")) == ["2"]
    assert os.path.isfile(os.path.join(save, "model", "2", "state.pt"))
    with open(os.path.join(save, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [(ln["phase"], ln["step"]) for ln in lines] == [("train", 1), ("train", 2)]
    with open(os.path.join(save, "MRCF.log")) as f:
        log = f.read()
    assert "data parallel: world 2 (--num_gpu 2)" in log, log
    assert log.count("epoch 0 iter 1 ") == 1 and log.count("epoch 0 iter 2 ") == 1, log
    assert "bit-equal: True" in log, log


def test_two_ranks_train_anchored_through_the_entry_point(tmp_path):
    """``--dcn_anchor true`` (windows 8/32) over 2 gloo ranks: the
    data-parallel steps take the anchored training grid (``dcn_anchor_vjp``),
    which the log names, and the ranks' parameters end bit-equal."""
    save = str(tmp_path / "exp")
    argv = [*_argv(save, 2), "--mid_channels", "16", "--dcn_anchor", "true",
            "--dcn_window", "8", "--dcn_window_hr", "32"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-m", "crfp_torch.main", *argv],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the 2-rank anchored run did not finish within {TIMEOUT_S} s")
    assert proc.returncode == 0, out[-4000:]
    with open(os.path.join(save, "MRCF.log")) as f:
        log = f.read()
    assert "data parallel: world 2 (--num_gpu 2)" in log, log
    assert "anchored HR windows on the training grid (dcn_anchor_vjp)" in log, log
    assert log.count("epoch 0 iter 2 ") == 1 and "bit-equal: True" in log, log


def test_uneven_batch_over_the_ranks_raises(tmp_path):
    import crfp_torch.main as tmain

    save = str(tmp_path / "exp")
    with pytest.raises(ValueError, match="does not divide evenly over 3 ranks"):
        tmain.main(_argv(save, 3))
    assert not os.path.exists(save)


def test_torchrun_world_must_match_num_gpu(tmp_path, monkeypatch):
    """Under torchrun's environment the run takes that world; a --num_gpu that
    asks for another raises before any group or directory is made."""
    import crfp_torch.main as tmain

    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "localhost")):
        monkeypatch.setenv(k, v)
    save = str(tmp_path / "exp")
    with pytest.raises(ValueError, match="torchrun's world of 2 is not the 3 rank"):
        tmain.main(_argv(save, 3)[:-4] + ["--batch_size", "6", "--cpu", "true",
                                          "--num_gpu", "3"])
    assert not os.path.exists(save) and not torch.distributed.is_initialized()
