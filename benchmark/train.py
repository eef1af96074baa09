"""Cells whose traffic is ``kind: train``: the training step of the
configuration (its family's, ``benchmark/families/``) on a pool of batches on
the device, the loader bypassed.

Set-up builds the model, its optimizer and its train step once, and drives
that one object through its first ``reference_steps`` steps on distinct
batches (the steps the reference follows); those steps also warm up every
shape. The window then goes on with the same object: step ``k`` takes pool
batch ``k mod pool_batches`` at step index ``flow_freeze_iters +
steps_past_freeze + k``, so the flow group trains as in most of the
recipe's steps. The window ends at the first step boundary past
``--seconds``, after a device synchronisation.

The family gives the port's ``(model, optimizer, train_step, TrainConfig)``
and the plain reference trunk, ``trunk(lrs, fvs, mks)`` on whole clips NCHW
(B, T, C, H, W); :data:`FAMILY` names what a cell of this kind calls of it.
Besides :func:`run`, the module gives the control, the TF32 witness and the
faults that ``benchmark/calibrate.py`` reads.
"""

from __future__ import annotations

import time

import torch

from benchmark import compare, generate
from benchmark.calibrate import ALTER, patched
from benchmark.reference import counts, names
from benchmark.trace import Tracer

# what a cell of this kind calls of its family
FAMILY = ("train_reference", "train_program", "train_loss")


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


def seeded_weights(cell: dict, seed: int, device) -> dict:
    """The run's float32 weights from ``seed``, under the family reference's
    names."""
    return names.seeded_weights(names.table(cell["family"].train_reference(cell["config"])),
                                seed, device)


def counted(cell: dict, batch: dict) -> dict:
    """The benchmark's FLOP and DCN-stage bound counts of one train step on a
    batch shaped as ``batch`` (``benchmark/reference/counts.py``)."""
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in compare.batch_nchw(batch)]
    return counts.train_counts(cell["family"].train_reference(cell["config"]), *meta)


def run(cell: dict, seed: int, seconds: float, trace: bool, device, setup_clock) -> dict:
    cfg, mix, family = cell["config"], cell["traffic"], cell["family"]
    weights = seeded_weights(cell, seed, device)
    model, opt, step_fn, tcfg = family.train_program(cfg, weights, device)
    batches = generate.train_pool(mix, seed, device)
    first = tcfg.flow_freeze_iters + mix["steps_past_freeze"]
    n_ref = mix["reference_steps"]
    count = counted(cell, batches[0]) if trace else None
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
        reading.counts = {"flops": reading.units * count["flops_step"],
                          "bound_s": reading.units * count["bound_s_step"],
                          "flops_untraced": (k - tracer.last - 1) * count["flops_step"],
                          "untraced_s": t_end - tracer.t_done}
        reading.peak_flops = cfg["peak_flops"]
        del tracer
    ref = compare.train_reference(family.train_reference(cfg), cfg, weights, batches, first,
                                  n_ref, device)
    numbers = compare.train_numbers(prog, ref)
    return {"attempted": steps, "failed": 0, "setup_s": setup_s, "peak": peak,
            "reading": reading, "numbers": numbers,
            "detail": compare.worst_leaves(prog, ref),
            "e2e": {"train_fps": steps * mix["batch"] * mix["frames"] / window_s}}


def control(cell: dict, seed: int, device, witness: bool = False) -> dict:
    """The numbers of the bfloat16 reference recipe against the float32 one;
    ``witness``: of the float32 reference with TF32 on instead (what TF32
    alone does to the numbers), each with the worst leaves."""
    cfg, mix, family = cell["config"], cell["traffic"], cell["family"]
    weights = seeded_weights(cell, seed, device)
    batches = generate.train_pool(mix, seed, device)
    first = cfg["train"]["flow_freeze_iters"] + mix["steps_past_freeze"]
    n = mix["reference_steps"]

    def follow(**how):
        return compare.train_reference(family.train_reference(cfg), cfg, weights, batches,
                                       first, n, device, **how)

    ref = follow()
    other = follow(exact=False) if witness else follow(amp=True)
    return dict(compare.train_numbers(other, ref), detail=compare.worst_leaves(other, ref))


def witness(cell: dict, seed: int, device) -> dict:
    return control(cell, seed, device, witness=True)


def _half_batch(family):
    """The loss taken over the first half of the batch alone."""
    owner, name = family.train_loss()
    loss = getattr(owner, name)

    def half(pred, target, *args, **kwargs):
        b = pred.shape[0] // 2
        return loss(pred[:b], target[:b], *args, **kwargs)

    return patched(owner, name, half)


def _altered_answer(family):
    """A patch of the family's ``train_program`` whose model alters the frames
    it produces."""
    build = family.train_program

    def train_program(*args, **kwargs):
        built = build(*args, **kwargs)
        model = built[0]
        forward = model.forward

        def faulty(*inputs, **kw):
            out = forward(*inputs, **kw)
            mask = torch.zeros_like(out)
            mask[..., :64, :64, :] = ALTER
            return out + mask

        model.forward = faulty
        return built

    return patched(family, "train_program", train_program)


# the faults a train cell can have: name -> patch of its family (a state left
# unchanged reads 1 on ``update_gap`` by construction, and is not run)
FAULTS = {"half": _half_batch, "answer": _altered_answer}
