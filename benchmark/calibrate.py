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

The module of the cell's traffic kind (``benchmark/<kind>.py``) gives its
``run``, its ``control``, its ``FAULTS`` (name -> a patch of the model's
family) and, for training, its ``witness``; this module plants nothing of
its own.

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

from benchmark import manifest  # noqa: E402

ALTER = 0.1  # what the planted answer fault adds to a 64 x 64 patch


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def altered(t: torch.Tensor) -> torch.Tensor:
    """``t`` (…, H, W, C) with ALTER added to its top-left 64 x 64 patch."""
    t = t.clone()
    t[..., :64, :64, :] += ALTER
    return t


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
    kind_mod = manifest.kind_module(cell["traffic"]["kind"])
    witness_seeds = [int(x) for x in args.witness_seeds.split(",") if x]
    if witness_seeds and not hasattr(kind_mod, "witness"):
        raise SystemExit(f"traffic kind {cell['traffic']['kind']!r} has no witness")
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
        res = kind_mod.run(cell, s, args.seconds, False, device, lambda: 0.0)
        emit("program", s, dict(res["numbers"], **({"detail": res["detail"]}
                                                   if "detail" in res else {})), t0)
        torch.cuda.empty_cache()
    for s in cseeds:
        t0 = time.perf_counter()
        emit("control", s, kind_mod.control(cell, s, device), t0)
        torch.cuda.empty_cache()
        if args.no_faults:
            continue
        for name, make in kind_mod.FAULTS.items():
            t0 = time.perf_counter()
            with make(cell["family"]):
                numbers = kind_mod.run(cell, s, args.seconds, False, device, lambda: 0.0)["numbers"]
            emit(f"fault_{name}", s, numbers, t0)
            torch.cuda.empty_cache()
    for s in witness_seeds:
        t0 = time.perf_counter()
        emit("witness_tf32", s, kind_mod.witness(cell, s, device), t0)
        torch.cuda.empty_cache()
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
