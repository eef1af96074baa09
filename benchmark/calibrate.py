"""The readings that a cell's comparison limits are set from, on the card at
the cell's own sizes (step 4 of how ``correct`` is decided):

- the program: a short window on each of ``--seeds``, every number;
- the control: the reference in the precision one step below the
  configuration's (bfloat16 storage with every conv's input and weight
  rounded through scaled float8 e4m3 for a bfloat16 configuration;
  bfloat16 for a float32 one), put in the program's place on each of
  ``--control-seeds``;
- the faults a cell can have, planted in the program on each of
  ``--control-seeds``: a step that returns its state unchanged, an answer
  altered where it is produced, and for training half of the batch left
  out of the loss (a state left unchanged reads 1 on ``update_gap`` by
  construction, and is not run).

    python3 benchmark/calibrate.py --workload deploy.streams4_1080p --seeds 1,2,3 \\
        --control-seeds 4,5,6 --out calib.jsonl

Writes one JSON object per reading to ``--out`` (one a line) and prints it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

import torch  # noqa: E402

from benchmark import compare, generate, manifest, stream, train  # noqa: E402
from benchmark.reference import names  # noqa: E402
from benchmark.reference.runtime import RuntimeV18  # noqa: E402
from benchmark.reference.trunk import Trunk  # noqa: E402

ALTER = 0.1  # what the planted answer fault adds to a 64 x 64 patch


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _altered(t: torch.Tensor) -> torch.Tensor:
    """``t`` (…, H, W, C) with ALTER added to its top-left 64 x 64 patch."""
    t = t.clone()
    t[..., :64, :64, :] += ALTER
    return t


def stream_fault(kind: str):
    """A patch of the streaming model's ``step``: 'state' returns the state
    it was given, 'answer' alters the frame it produces."""
    from crfp_torch.models.runtime import CRFPRuntimeV18

    orig = CRFPRuntimeV18.step

    def step(self, state, *args):
        new, out = orig(self, state, *args)
        return (state, out) if kind == "state" else (new, _altered(out))

    return patched(CRFPRuntimeV18, "step", step)


def train_fault(kind: str):
    """A patch of the training entry: 'half' takes the loss over the first
    half of the batch, 'answer' alters the frames the model produces."""
    import crfp_torch.train.loop as loop
    from crfp_torch.models.crfp import CRFP

    if kind == "half":
        orig = loop.charbonnier_loss

        def half(pred, target, weight=None, eps=1e-12):
            b = pred.shape[0] // 2
            return orig(pred[:b], target[:b], weight, eps)

        return patched(loop, "charbonnier_loss", half)
    orig_fwd = CRFP.forward

    def forward(self, *args):
        out = orig_fwd(self, *args)
        mask = torch.zeros_like(out)
        mask[..., :64, :64, :] = ALTER
        return out + mask

    return patched(CRFP, "forward", forward)


def stream_control(cell: dict, seed: int, device) -> dict:
    """The numbers of the reference one precision below the configuration's,
    streamed in the program's place: a stream's first frames from its start,
    then as many later frames each judged from the control's own state."""
    cfg, mix = cell["config"], cell["traffic"]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    quant = compare.fp8_round if dtype == torch.bfloat16 else None
    ctrl_dtype = torch.bfloat16
    rows = names.table(RuntimeV18(compare.spec_of(cfg), mix["warp_hw"]))
    weights = names.seeded_weights(rows, seed, device, dtype)
    pool = generate.stream_pool(mix, seed, device, dtype)
    ctrl, run_ctrl = compare.stream_reference(cfg, mix, weights, device, ctrl_dtype, quant)
    n_start, n_keep = mix["check_stream_start"], mix["check_frames"]
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    as_nhwc = lambda s: {"hr": nhwc(s["hr"]), "lv": tuple(nhwc(t) for t in s["lv"])}  # noqa: E731
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
            start["state"] = as_nhwc(new)
        else:
            samples.append((p, prev, as_nhwc(state), nhwc(out), as_nhwc(new)))
        state, prev = new, p
    ref, run_ref = compare.stream_reference(cfg, mix, weights, device)
    return compare.stream_numbers(ref, run_ref, pool, start, samples)


def train_control(cell: dict, seed: int, device, witness: bool = False) -> dict:
    """The numbers of the bfloat16 reference recipe against the float32 one;
    ``witness``: of the float32 reference with TF32 on instead (what TF32
    alone does to the numbers, with the worst leaves)."""
    cfg, mix = cell["config"], cell["traffic"]
    weights = names.seeded_weights(names.table(Trunk(compare.spec_of(cfg))), seed, device)
    batches = generate.train_pool(mix, seed, device)
    first = cfg["train"]["flow_freeze_iters"] + mix["steps_past_freeze"]
    n = mix["reference_steps"]
    ref = compare.train_reference(cfg, weights, batches, first, n, device)
    if witness:
        other = compare.train_reference(cfg, weights, batches, first, n, device, exact=False)
        return dict(compare.train_numbers(other, ref), detail=compare.worst_leaves(other, ref))
    ctrl = compare.train_reference(cfg, weights, batches, first, n, device, amp=True)
    return dict(compare.train_numbers(ctrl, ref), detail=compare.worst_leaves(ctrl, ref))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="", help="training: the TF32 witness")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--no-faults", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = manifest.cell(args.workload)
    kind = cell["traffic"]["kind"]
    runner = {"stream": stream.run, "train": train.run}[kind]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a")

    def emit(what, seed, numbers, t0):
        rec = {"workload": args.workload, "what": what, "seed": seed, **numbers,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        out.write(json.dumps(rec) + "\n")
        out.flush()

    for s in seeds:
        t0 = time.perf_counter()
        res = runner(cell, s, args.seconds, False, device, lambda: 0.0)
        emit("program", s, dict(res["numbers"], **({"detail": res["detail"]}
                                                   if "detail" in res else {})), t0)
        torch.cuda.empty_cache()
    control = {"stream": stream_control, "train": train_control}[kind]
    faults = {"stream": (("state", stream_fault), ("answer", stream_fault)),
              "train": (("half", train_fault), ("answer", train_fault))}[kind]
    for s in cseeds:
        t0 = time.perf_counter()
        emit("control", s, control(cell, s, device), t0)
        torch.cuda.empty_cache()
        if args.no_faults:
            continue
        for name, make in faults:
            t0 = time.perf_counter()
            with make(name):
                numbers = runner(cell, s, args.seconds, False, device, lambda: 0.0)["numbers"]
            emit(f"fault_{name}", s, numbers, t0)
            torch.cuda.empty_cache()
    for s in [int(x) for x in args.witness_seeds.split(",") if x]:
        t0 = time.perf_counter()
        emit("witness_tf32", s, train_control(cell, s, device, witness=True), t0)
        torch.cuda.empty_cache()
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
