"""Cells whose traffic is ``kind: train``: the training step of the
configuration (``make_train_step`` over ``CRFP``) on a pool of batches on
the device, the loader bypassed.

Set-up builds the model, its optimizer and its train step once, and drives
that one object through its first ``reference_steps`` steps on distinct
batches (the steps the reference follows); those steps also warm up every
shape. The window then goes on with the same object: step ``k`` takes pool
batch ``k mod pool_batches`` at step index ``flow_freeze_iters +
steps_past_freeze + k``, so the flow group trains as in most of the
recipe's steps. The window ends at the first step boundary past
``--seconds``, after a device synchronisation.
"""

from __future__ import annotations

import time

import torch

from benchmark import compare, generate, program
from benchmark.reference import counts, names
from benchmark.reference.trunk import Trunk
from benchmark.trace import Tracer


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_readings(model, opt, step_fn, batches, first: int, steps: int, beta1: float,
                     weights: dict) -> dict:
    """Drive the program's train step through ``steps`` steps and read what
    the comparison needs: each step's loss, the first gradient from Adam's
    first moment after one step, the parameters' change after the last."""
    names_of = {p: n for n, p in model.named_parameters()}
    losses, grad_norms = [], None
    for k in range(steps):
        metrics = step_fn(opt, batches[k], first + k)
        losses.append(metrics["loss"])
        if k == 0:
            # a parameter that Adam has no moment of reads a zero gradient
            grad_norms = {n: float((opt.state[p]["exp_avg"] / (1.0 - beta1)).norm())
                          if "exp_avg" in opt.state.get(p, {}) else 0.0
                          for p, n in names_of.items()}
    return {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "update_norms": {n: float((p.detach() - weights[n]).norm())
                             for n, p in model.named_parameters()}}


def run(cell: dict, seed: int, seconds: float, trace: bool, device, setup_clock) -> dict:
    cfg, mix = cell["config"], cell["traffic"]
    rows = names.table(Trunk(compare.spec_of(cfg)))
    weights = names.seeded_weights(rows, seed, device)
    model, opt, step_fn, tcfg = program.trainer(cfg, weights, device)
    batches = generate.train_pool(mix, seed, device)
    first = tcfg.flow_freeze_iters + mix["steps_past_freeze"]
    n_ref = mix["reference_steps"]
    counted = None
    if trace:
        counted = counts.train_counts(Trunk(compare.spec_of(cfg)), mix["batch"], mix["frames"],
                                      mix["gt"], mix["scale"])
    prog = program_readings(model, opt, step_fn, batches, first, n_ref, tcfg.beta1, weights)
    _sync(device)
    setup_s = setup_clock()
    n_pool = mix["pool_batches"]
    # the window's steps from its second on are traced
    tracer = Tracer(mix["trace_steps"], n_ref + 1, lambda: _sync(device)) if trace else None
    t_start = time.perf_counter()
    k = n_ref
    while True:
        if tracer:
            tracer.before(k)
        step_fn(opt, batches[k % n_pool], first + k)
        if tracer:
            tracer.after(k)
        k += 1
        # a traced run also runs as many steps untraced after its spans (mfu.*)
        if time.perf_counter() - t_start >= seconds and k > (
                tracer.last + tracer.units if tracer else n_ref):
            break
    _sync(device)
    t_end = time.perf_counter()
    window_s = t_end - t_start
    steps = k - n_ref
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del model, opt, step_fn
    reading = None
    if trace:
        reading = tracer.reading("train")
        reading.counts = {"flops": reading.units * counted["flops_step"],
                          "bound_s": reading.units * counted["bound_s_step"],
                          "flops_untraced": (k - tracer.last - 1) * counted["flops_step"],
                          "untraced_s": t_end - tracer.t_done}
        reading.peak_flops = cfg["peak_flops"]
        del tracer
    ref = compare.train_reference(cfg, weights, batches, first, n_ref, device)
    numbers = compare.train_numbers(prog, ref)
    return {"attempted": steps, "failed": 0, "setup_s": setup_s, "peak": peak,
            "reading": reading, "numbers": numbers,
            "detail": compare.worst_leaves(prog, ref),
            "e2e": {"train_fps": steps * mix["batch"] * mix["frames"] / window_s}}
