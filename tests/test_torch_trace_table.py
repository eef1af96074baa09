"""The per-kernel trace table of the port (crfp_torch/bench/trace_table.py)
on the CPU: ``parse_trace`` on a Chrome trace written here in
``torch.profiler``'s format on the card (processes labelled ``CPU`` and
``GPU <n>``):
device-lane kernel, memcpy and memset events only (not host events, not
the annotations that span kernels), summed by name and divided by the
frames, largest first, cut at ``top``; the newest trace under the
directory is read, gzipped or not; a trace ``torch.profiler`` exports
here (no card) holds no device lane. ``run`` raises without a card, and
``--dcn_anchor`` raises."""

import gzip
import json
import os
import time

import pytest
import torch


def _trace(path, kernels, host_pid=4242, opener=open):
    """A Chrome trace as torch.profiler writes it on the card: every process
    named after the program, the host labelled CPU and each card GPU <n>;
    host ops and launches on the host lane, the given (name, dur us, cat)
    events on GPU 0's lane and a user annotation spanning them."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": host_pid, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": host_pid, "tid": 0,
         "args": {"labels": "CPU"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        # a lane of another card with no events
        {"ph": "M", "name": "process_labels", "pid": 1, "tid": 0, "args": {"labels": "GPU 1"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": host_pid, "tid": 1,
         "ts": 0, "dur": 900.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": host_pid,
         "tid": 1, "ts": 1, "dur": 5.0},
        # a host event that borrows a kernel's name must not count
        {"ph": "X", "cat": "kernel", "name": "dcn_fwd_kernel", "pid": host_pid, "tid": 1,
         "ts": 2, "dur": 1000.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "frame", "pid": 0, "tid": 7,
         "ts": 0, "dur": 5000.0},
    ]
    for i, (name, dur, cat) in enumerate(kernels):
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 10 * i,
                   "dur": dur})
    with opener(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)


def test_parse_trace_sums_device_lanes_by_name(tmp_path):
    from crfp_torch.bench.trace_table import parse_trace

    _trace(tmp_path / "a.json", [("dcn_fwd_kernel", 100.0, "kernel"),
                                 ("flow_warp_kernel", 30.0, "kernel"),
                                 ("dcn_fwd_kernel", 60.0, "kernel"),
                                 ("Memcpy HtoD", 8.0, "gpu_memcpy"),
                                 ("Memset", 2.0, "gpu_memset")])
    rows = parse_trace(str(tmp_path), frames=4)
    assert rows == [("dcn_fwd_kernel", 0.04), ("flow_warp_kernel", 0.0075),
                    ("Memcpy HtoD", 0.002), ("Memset", 0.0005)]
    assert parse_trace(str(tmp_path), frames=4, top=2) == rows[:2]


def test_parse_trace_reads_the_newest_trace(tmp_path):
    from crfp_torch.bench.trace_table import parse_trace

    _trace(tmp_path / "old.json", [("old_kernel", 10.0, "kernel")])
    past = time.time() - 60
    os.utime(tmp_path / "old.json", (past, past))
    _trace(tmp_path / "new.json.gz", [("emit_kernel", 20.0, "kernel")], opener=gzip.open)
    assert parse_trace(str(tmp_path), frames=2) == [("emit_kernel", 0.01)]
    with pytest.raises(FileNotFoundError, match="no trace"):
        parse_trace(str(tmp_path / "empty"), frames=1)


def test_a_cpu_trace_has_no_device_lane(tmp_path):
    from crfp_torch.bench.trace_table import parse_trace

    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (x @ x).sum()
    prof.export_chrome_trace(str(tmp_path / "cpu.json"))
    assert parse_trace(str(tmp_path), frames=1) == []


def test_run_needs_a_card_and_anchor_raises(tmp_path):
    from crfp_torch.bench.trace_table import main, run

    with pytest.raises(ValueError, match="anchored windows"):
        main(["--dcn_anchor", "--logdir", str(tmp_path)])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(frames=1, logdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--frames", "1", "--logdir", str(tmp_path)])
