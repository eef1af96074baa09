"""How ``correct`` is decided: the program's outputs against the plain
reference (``benchmark/reference``), computed after the window in float32
with TF32 off, from the benchmark's own weights and inputs.

Streams. The window keeps references to what the program produced for
(a) the first ``check_stream_start`` frames of its first stream and (b) a
seeded uniform sample of ``check_frames`` later frames. The reference
replays (a) from the stream's start with its own state, and for each of
(b) runs the one step from the program's state before that frame (it can
only follow the program's recurrent state from there; (a) checks the start
and the steps that (b) skips). Numbers: ``frame_err``, the widest gap
between a served frame and the reference's; ``state_err``, the widest gap
of each tensor of the carried state (v18: HR and the three level states),
each over the reference's largest magnitude of that tensor.

Training. Set-up drives the program's train step through its first
``reference_steps`` steps; the reference follows them from the same
weights and batches. Each leaf's gap is the gap between the program's and
the reference's norms over the reference's norm of that leaf or of the
median leaf, whichever is larger. Numbers: ``loss_gap``, the largest
relative gap of a step's loss; ``grad_gap``, the median leaf's gap of the
first gradient (the program's read back from Adam's first moment after one
step); ``update_gap``, the median leaf's gap of the parameters' change over
the steps, leaving out leaves whose reference gradient is under a
thousandth of the median leaf's (they move by round-off alone). The median
and not the worst leaf: the worst leaf's gap swings from seed to seed with
the gradients that pass through the bilinear sampler's positions, which
TF32 rounding moves across pixel boundaries (``PERF.md``).

The reference models are the model family's (``benchmark/families/``), built
on the meta device; the program's carried state reaches the reference
through the family's ``state_nchw``.
"""

from __future__ import annotations

import contextlib
import statistics

import torch

from torch import nn

from benchmark.reference import names
from benchmark.reference.trunk import adam_update, charbonnier, is_flow, lr_at


@contextlib.contextmanager
def exact_math():
    """float32 convolutions and matmuls without TF32 inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with a per-tensor scale (its largest
    magnitude at the format's largest value), back in x's dtype."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2).float()


def _gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return float((prog.float() - ref.float()).abs().max())


def leaves(state) -> list[torch.Tensor]:
    """The tensors of a state of nested dicts (by key) and tuples, in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in leaves(state[k])]
    return [t for x in state for t in leaves(x)]


def tree_map(fn, state):
    """``state`` with ``fn`` applied to each of its tensors."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, dict):
        return {k: tree_map(fn, v) for k, v in state.items()}
    return type(state)(tree_map(fn, x) for x in state)


def _state_gap(prog, ref) -> float:
    """The widest gap of each state tensor over its reference magnitude."""
    return max(_gap(p, r) / max(float(r.abs().max()), 1e-12)
               for p, r in zip(leaves(prog), leaves(ref), strict=True))


def stream_reference(model: nn.Module, weights, device, dtype=torch.float32, quant=None):
    """The reference streaming ``model`` (the family's, on the meta device) on
    ``device`` in ``dtype`` with ``weights``, and a ``run(fn)`` that calls
    ``fn`` under the reference's arithmetic (``quant``: every conv's input and
    weight rounded through it)."""
    from benchmark.reference.nets import quantized

    model = names.materialize(model, weights, device, dtype)

    def run(fn):
        with torch.no_grad(), exact_math(), (quantized(quant) if quant else
                                             contextlib.nullcontext()):
            return fn()

    return model, run


def stream_numbers(ref, run, pool: dict, start: dict, samples: list, state_nchw):
    """``frame_err`` and ``state_err`` of the program's kept outputs
    (``start``: 'pos', 'outs', 'state' of a stream's first frames;
    ``samples``: (pos, prev_pos, state_in, out, state_out) of later frames;
    frames NHWC, states as ``state_nchw`` takes them to the reference's
    form) against the reference ``ref`` (:func:`stream_reference`)."""
    def frame(p):
        return pool["lr"][p].permute(0, 3, 1, 2).float(), \
            pool["fv"][p].permute(0, 3, 1, 2).float()

    frame_err, state_err = 0.0, 0.0

    def replay():
        nonlocal frame_err
        state, prev = None, None
        for j, (p, out) in enumerate(zip(start["pos"], start["outs"])):
            lr, fv = frame(p)
            x_lr, x_hr = ref.encode(lr, fv)
            if j == 0:
                state, r = ref.step0(lr, x_lr, x_hr)
            else:
                state, r = ref.step(state, lr, prev, x_lr, x_hr)
            frame_err = max(frame_err, _gap(_nchw(out), r))
            prev = lr
        return state

    state = run(replay)
    state_err = max(state_err, _state_gap(state_nchw(start["state"]), state))
    for p, prev_p, s_in, out, s_out in samples:
        lr, fv = frame(p)
        prev, _ = frame(prev_p)
        s = state_nchw(s_in)

        def one():
            x_lr, x_hr = ref.encode(lr, fv)
            return ref.step(s, lr, prev, x_lr, x_hr)

        r_state, r_out = run(one)
        frame_err = max(frame_err, _gap(_nchw(out), r_out))
        state_err = max(state_err, _state_gap(state_nchw(s_out), r_state))
    return {"frame_err": frame_err, "state_err": state_err}


def batch_nchw(batch: dict, dtype=torch.float32):
    def f(t):
        return t.permute(0, 1, 4, 2, 3).to(dtype)
    return f(batch["lr"]), f(batch["fv"]), f(batch["mk"]), f(batch["hr"])


def train_reference(model: nn.Module, cfg: dict, weights: dict, batches: list,
                    first_step: int, steps: int, device, amp: bool = False,
                    exact: bool = True) -> dict:
    """The reference recipe of ``cfg`` over ``batches[:steps]`` from
    ``weights``, on the reference trunk ``model`` (the family's, on the meta
    device): 'losses', 'grad_norms' (the first step's, per leaf),
    'update_norms' (the change after ``steps`` updates, per leaf). ``amp``:
    forward and backward in bfloat16 on casts of the float32 masters (the
    control); ``exact`` False: TF32 as PyTorch's defaults leave it (a witness
    of what TF32 alone does)."""
    tr = cfg["train"]
    dtype = torch.bfloat16 if amp else torch.float32
    model = names.materialize(model, weights, device, dtype)
    params = dict(model.named_parameters())
    masters = {k: v.detach().float().clone() for k, v in weights.items()}
    moments: dict = {}
    out = {"losses": [], "grad_norms": None}
    for k in range(steps):
        step = first_step + k
        lrs = (lr_at(tr["lr_rate"], step, tr["period"], tr["min_lr"]),
               lr_at(tr["lr_rate_flow"], max(step - tr["flow_freeze_iters"], 0), tr["period"],
                     tr["min_lr"]))
        for p in params.values():
            p.grad = None
        lr, fv, mk, hr = batch_nchw(batches[k], dtype)
        with exact_math() if exact else contextlib.nullcontext():
            pred = model(lr, fv, mk).float()
            loss = tr.get("rec_w", 1.0) * charbonnier(pred, hr.float())
            loss.backward()
        grads = {n: p.grad.float() for n, p in params.items()}
        if step < tr["flow_freeze_iters"]:
            grads = {n: (torch.zeros_like(g) if is_flow(n) else g) for n, g in grads.items()}
        out["losses"].append(float(loss.detach()))
        if k == 0:
            out["grad_norms"] = {n: float(g.norm()) for n, g in grads.items()}
        adam_update(masters, grads, moments, k + 1, lrs, (tr["beta1"], tr["beta2"]), tr["eps"])
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(masters[n].to(dtype))
    out["update_norms"] = {n: float((masters[n] - weights[n].float()).norm()) for n in masters}
    return out


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> list[float]:
    """Each leaf's gap between the program's and the reference's norms over
    the reference's norm of that leaf or of the median leaf, the larger."""
    names_ = [n for n in ref if keep is None or keep(n)]
    median = statistics.median(ref[n] for n in names_)
    return [abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names_]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``loss_gap``, ``grad_gap``, ``update_gap`` of the program's readings
    (same keys as :func:`train_reference`'s) against the reference's: the
    largest relative gap of a step's loss, and the median leaf's gap of the
    first gradient and of the change (leaves that the reference's gradient
    moves by round-off alone left out of the change)."""
    steps = len(ref["losses"])
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"][:steps], ref["losses"]))
    g_med = statistics.median(ref["grad_norms"].values())
    moved = lambda n: ref["grad_norms"][n] >= 1e-3 * g_med  # noqa: E731
    return {"loss_gap": loss_gap,
            "grad_gap": statistics.median(_leaf_gaps(prog["grad_norms"], ref["grad_norms"])),
            "update_gap": statistics.median(
                _leaf_gaps(prog["update_norms"], ref["update_norms"], moved))}


def worst_leaves(prog: dict, ref: dict, k: int = 4) -> dict:
    """For each per-leaf norm, its ``k`` worst leaves: (name, gap, the
    program's norm, the reference's norm); the first is the worst leaf's
    gap, the number before the median was taken."""
    out = {}
    for key in ("grad_norms", "update_norms"):
        median = statistics.median(ref[key].values())
        gaps = sorted(((abs(prog[key][n] - r) / max(r, median, 1e-30), n, prog[key][n], r)
                       for n, r in ref[key].items()), reverse=True)[:k]
        out[key] = {"median": median, "worst": [[n, g, p, r] for g, n, p, r in gaps]}
    return out
