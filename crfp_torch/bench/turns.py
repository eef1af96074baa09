"""Device times of two trees read in turns, parent, change, change, parent
(P C C P), in one chip call: the ``{"modes": [...]}`` line that
``chip_smoke.py --kernels-only`` or ``--widths-only`` prints last, from each
run's saved output, matched mode by mode (kernel and mode name).

    python -m crfp_torch.bench.turns P1.log C1.log C2.log P2.log

Prints, per mode, the two parent and the two change readings of
``device_ms`` (20 calls replayed from one CUDA graph), the change's mean
over the parent's, whether the digests (where a mode prints one) agree
across all four runs, and a JSON summary last. Reads no card."""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def modes(log: Path) -> dict[tuple[str, str], dict]:
    """{(kernel, mode): record} of the last ``{"modes": ...}`` line of a log."""
    line = next(ln for ln in reversed(log.read_text().splitlines())
                if ln.startswith('{"modes"'))
    return {(m["kernel"], m["mode"]): m for m in json.loads(line)["modes"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("logs", type=Path, nargs=4, help="P1 C1 C2 P2")
    args = ap.parse_args(argv)
    p1, c1, c2, p2 = (modes(p) for p in args.logs)
    rows = []
    for key in p1:
        if not all(key in r for r in (c1, c2, p2)):
            continue
        runs = [r[key] for r in (p1, c1, c2, p2)]
        dev = [m.get("device_ms") for m in runs]
        if any(d is None for d in dev):
            continue
        ratio = (dev[1] + dev[2]) / (dev[0] + dev[3])
        digests = {m.get("digest") for m in runs}
        same = None if digests == {None} else len(digests) == 1
        rows.append({"kernel": key[0], "mode": key[1], "parent": [dev[0], dev[3]],
                     "change": [dev[1], dev[2]], "change_over_parent": ratio,
                     "parent_spread": abs(dev[0] - dev[3]) / min(dev[0], dev[3]),
                     "digests_equal": same, "branch": runs[1].get("branch")})
        print(f"[turns] {key[0]:18s} {key[1][:60]:60s} P {dev[0]:.4f} {dev[3]:.4f}  C "
              f"{dev[1]:.4f} {dev[2]:.4f}  C/P {ratio:.3f}  digests "
              f"{'-' if same is None else 'equal' if same else 'DIFFER'}"
              + (f"  {runs[1]['branch']}" if runs[1].get("branch") else ""))
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
