"""Cells whose traffic is ``kind: stream``: ``viewers`` streams served as one
batch through the streaming model's ``encode`` / ``step0`` / ``step``,
closed loop.

Each step serves one frame of every viewer and is dispatched once the
previous step's output is ready: each of its frames' latency runs from the
start of its dispatch to its output's CUDA event being complete, on the
host clock. The streams start (``step0``) at the window's first step and
every ``stream_frames`` steps after. Set-up builds the model and the frame
pools from the seed and warms up every shape the window uses by playing
``warmup_frames`` steps of the streams.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from benchmark import compare, generate, program
from benchmark.reference import counts, names
from benchmark.reference.runtime import RuntimeV18
from benchmark.trace import Tracer


class _Stream:
    """The streaming model's state between steps and one step's dispatch."""

    def __init__(self, model, pool, mix):
        self.model, self.pool, self.mix = model, pool, mix
        self.state, self.prev, self.j = None, None, 0

    def frame(self):
        """Dispatch the next step (one frame of every viewer); (stream
        position, pool index, previous pool index, state in, output, state
        out)."""
        mix, pool = self.mix, self.pool
        if self.j == mix["stream_frames"]:
            self.j = 0
        p = generate.stream_index(self.j, mix["pool_frames"])
        lr, fv = pool["lr"][p], pool["fv"][p]
        x_lr, x_hr = self.model.encode(lr, fv)
        state_in, prev = self.state, self.prev
        if self.j == 0:
            self.state, out = self.model.step0(lr, x_lr, x_hr)
        else:
            self.state, out = self.model.step(state_in, lr, pool["lr"][prev], x_lr, x_hr)
        self.prev = p
        self.j += 1
        return self.j - 1, p, prev, state_in, out, self.state


def run(cell: dict, seed: int, seconds: float, trace: bool, device, setup_clock) -> dict:
    cfg, mix = cell["config"], cell["traffic"]
    dtype = program.DTYPES[cfg["dtype"]]
    on_card = device.type == "cuda"
    rows = names.table(RuntimeV18(compare.spec_of(cfg), mix["warp_hw"]))
    weights = names.seeded_weights(rows, seed, device, dtype)
    model = program.runtime_model(cfg, mix["warp_hw"], weights, device)
    pool = generate.stream_pool(mix, seed, device, dtype)
    counted = None
    if trace:
        counted = counts.stream_counts(RuntimeV18(compare.spec_of(cfg), mix["warp_hw"]),
                                       mix["viewers"], mix["lr_hw"], mix["fovea_hw"], dtype)
    rng = random.Random(seed)
    lat, start, samples = [], {"pos": [], "outs": []}, []
    n_start, n_keep = mix["check_stream_start"], mix["check_frames"]
    n_seen = 0
    with torch.inference_mode():
        warm = _Stream(model, pool, mix)
        for _ in range(mix["warmup_frames"]):
            warm.frame()
        del warm
        if on_card:
            torch.cuda.synchronize(device)
        stream = _Stream(model, pool, mix)
        done = torch.cuda.Event() if on_card else None
        tracer = Tracer(mix["trace_frames"], 1, lambda: torch.cuda.synchronize(device)) \
            if trace else None
        setup_s = setup_clock()
        t_start = time.perf_counter()
        i = 0
        while True:
            if tracer:
                tracer.before(i)
            t0 = time.perf_counter()
            j, p, prev, s_in, out, s_out = stream.frame()
            if on_card:
                done.record()
                done.synchronize()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if i < n_start:
                start["pos"].append(p)
                start["outs"].append(out)
                start["state"] = s_out
            elif j > 0:
                # a uniform sample of the later steady frames, by reservoir
                n_seen += 1
                if len(samples) < n_keep:
                    samples.append((p, prev, s_in, out, s_out))
                else:
                    r = rng.randrange(n_seen)
                    if r < n_keep:
                        samples[r] = (p, prev, s_in, out, s_out)
            if tracer:
                tracer.after(i)
            i += 1
            # a traced run also runs as many frames untraced after its spans (mfu.*)
            if t1 - t_start >= seconds and i > max(
                    n_start, tracer.last + tracer.units if tracer else 0):
                break
        window_s = t1 - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del model, stream
    reading = None
    if trace:
        reading = tracer.reading("stream")

        def flops_and_bound(frames):
            starts = sum(1 for m in frames if m % mix["stream_frames"] == 0)
            steady = len(frames) - starts
            return (steady * counted["flops_steady"] + starts * counted["flops_first"],
                    steady * counted["bound_s_steady"] + starts * counted["bound_s_first"])

        flops, bound = flops_and_bound(range(tracer.first, tracer.first + tracer.units))
        reading.counts = {"flops": flops, "bound_s": bound,
                          "flops_untraced": flops_and_bound(range(tracer.last + 1, i))[0],
                          "untraced_s": t1 - tracer.t_done}
        reading.peak_flops = cfg["peak_flops"]
        del tracer
    ref, run_ref = compare.stream_reference(cfg, mix, weights, device)
    numbers = compare.stream_numbers(ref, run_ref, pool, start, samples)
    # every frame of a step has the step's latency
    q = statistics.quantiles([x * 1e3 for x in lat], n=20)
    frames = len(lat) * mix["viewers"]
    return {"attempted": frames, "failed": 0, "setup_s": setup_s, "peak": peak,
            "reading": reading, "numbers": numbers,
            "e2e": {"serve_fps": frames / window_s, "serve_p95_ms": q[18]}}
