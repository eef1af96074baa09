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

The model is the configuration's family's (``benchmark/families/``): the
port's streaming model and its plain reference, both with ``encode(lr,
fv)``, ``step0(lr, x_lr, x_hr)`` and ``step(state, lr, prev_lr, x_lr,
x_hr)``, the port's NHWC and the reference's NCHW. :data:`FAMILY` names what
a cell of this kind calls of the family. Besides :func:`run`, the module
gives the control and the faults that ``benchmark/calibrate.py`` reads.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from benchmark import compare, generate, manifest
from benchmark.calibrate import altered, patched
from benchmark.reference import counts, names
from benchmark.trace import Tracer

# what a cell of this kind calls of its family
FAMILY = ("stream_reference", "stream_program", "stream_inputs", "state_nchw")


def seeded_weights(cell: dict, seed: int, device) -> dict:
    """The run's weights from ``seed``, in the configuration's dtype, under the
    family reference's names."""
    cfg, mix = cell["config"], cell["traffic"]
    rows = names.table(cell["family"].stream_reference(cfg, mix))
    return names.seeded_weights(rows, seed, device, manifest.DTYPES[cfg["dtype"]])


def inputs(cell: dict, seed: int, device) -> dict:
    """The model's inputs for each pool frame, made from ``seed``: 'lr' and
    'fv' (P, V, ..., C), NHWC in the configuration's dtype."""
    cfg, mix = cell["config"], cell["traffic"]
    pool = generate.stream_pool(mix, seed, device, manifest.DTYPES[cfg["dtype"]])
    return cell["family"].stream_inputs(pool, mix)


def counted(cell: dict, pool: dict) -> dict:
    """The benchmark's FLOP and DCN-stage bound counts of a first and a steady
    step at the cell's sizes (``benchmark/reference/counts.py``)."""
    def meta(t):
        return torch.empty(t.permute(0, 3, 1, 2).shape, dtype=t.dtype, device="meta")

    model = cell["family"].stream_reference(cell["config"], cell["traffic"])
    return counts.stream_counts(model, meta(pool["lr"][0]), meta(pool["fv"][0]))


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
    cfg, mix, family = cell["config"], cell["traffic"], cell["family"]
    on_card = device.type == "cuda"
    weights = seeded_weights(cell, seed, device)
    model = family.stream_program(cfg, mix, weights, device)
    pool = inputs(cell, seed, device)
    count = counted(cell, pool) if trace else None
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
            return (steady * count["flops_steady"] + starts * count["flops_first"],
                    steady * count["bound_s_steady"] + starts * count["bound_s_first"])

        flops, bound = flops_and_bound(range(tracer.first, tracer.first + tracer.units))
        reading.counts = {"flops": flops, "bound_s": bound,
                          "flops_untraced": flops_and_bound(range(tracer.last + 1, i))[0],
                          "untraced_s": t1 - tracer.t_done}
        reading.peak_flops = cfg["peak_flops"]
        del tracer
    ref, run_ref = compare.stream_reference(family.stream_reference(cfg, mix), weights, device)
    numbers = compare.stream_numbers(ref, run_ref, pool, start, samples, family.state_nchw)
    # every frame of a step has the step's latency
    q = statistics.quantiles([x * 1e3 for x in lat], n=20)
    frames = len(lat) * mix["viewers"]
    return {"attempted": frames, "failed": 0, "setup_s": setup_s, "peak": peak,
            "reading": reading, "numbers": numbers,
            "e2e": {"serve_fps": frames / window_s, "serve_p95_ms": q[18]}}


def control(cell: dict, seed: int, device) -> dict:
    """The numbers of the reference one precision below the configuration's,
    streamed in the program's place: a stream's first frames from its start,
    then as many later frames each judged from the control's own state
    (bfloat16 storage, and for a bfloat16 configuration every conv's input and
    weight rounded through scaled float8 e4m3)."""
    cfg, mix, family = cell["config"], cell["traffic"], cell["family"]
    quant = compare.fp8_round if cfg["dtype"] == "bfloat16" else None
    ctrl_dtype = torch.bfloat16
    weights = seeded_weights(cell, seed, device)
    pool = inputs(cell, seed, device)
    ctrl, run_ctrl = compare.stream_reference(family.stream_reference(cfg, mix), weights, device,
                                              ctrl_dtype, quant)
    n_start, n_keep = mix["check_stream_start"], mix["check_frames"]
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    start, samples = {"pos": [], "outs": []}, []
    state, prev = None, None
    for j in range(n_start + n_keep):
        p = generate.stream_index(j, mix["pool_frames"])
        lr = pool["lr"][p].permute(0, 3, 1, 2).to(ctrl_dtype)
        fv = pool["fv"][p].permute(0, 3, 1, 2).to(ctrl_dtype)

        def one():
            x_lr, x_hr = ctrl.encode(lr, fv)
            if j == 0:
                return ctrl.step0(lr, x_lr, x_hr)
            prev_lr = pool["lr"][prev].permute(0, 3, 1, 2).to(ctrl_dtype)
            return ctrl.step(state, lr, prev_lr, x_lr, x_hr)

        new, out = run_ctrl(one)
        if j < n_start:
            start["pos"].append(p)
            start["outs"].append(nhwc(out))
            start["state"] = new
        else:
            samples.append((p, prev, state, nhwc(out), new))
        state, prev = new, p
    ref, run_ref = compare.stream_reference(family.stream_reference(cfg, mix), weights, device)
    return compare.stream_numbers(ref, run_ref, pool, start, samples,
                                  lambda s: compare.tree_map(torch.Tensor.float, s))


def _faulty_program(family, kind: str):
    """A patch of the family's ``stream_program`` whose model's ``step``
    returns the state it was given ('state') or alters the frame it produces
    ('answer')."""
    build = family.stream_program

    def stream_program(*args, **kwargs):
        model = build(*args, **kwargs)
        step = model.step

        def faulty(state, *rest):
            new, out = step(state, *rest)
            return (state, out) if kind == "state" else (new, altered(out))

        model.step = faulty
        return model

    return patched(family, "stream_program", stream_program)


# the faults a stream cell can have: name -> patch of its family
FAULTS = {"state": lambda family: _faulty_program(family, "state"),
          "answer": lambda family: _faulty_program(family, "answer")}
