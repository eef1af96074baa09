"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload deploy.streams4_1080p --seed 7 --seconds 10 --trace 0

(``python3 -m benchmark.run`` takes the same arguments.) The cell's
configuration and its model's family, traffic mix and its kind's module,
per-layer readers and comparison limits are found by the names in
``BENCHMARK.json`` (``benchmark/manifest.py``). The
run makes its weights and inputs on the card from ``--seed``, warms up,
measures for ``--seconds`` and then checks what the timed path produced
against the plain reference (``benchmark/compare.py``). With ``--trace 0``
the line's metrics are the cell's end-to-end ones; with ``--trace 1`` a
profiler traces a fixed span of the window and the metrics are its
per-layer ones, with the trace's busy time, window and breakdown.

The last line of standard output is one JSON object; the numbers compared
and their limits end it (key ``checks``) and end standard error. Without a
CUDA card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded once the window has closed, the run exits with code 2 and
prints no result.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.time()
_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

# caches the process could write stay inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, str(_ROOT / ".bench_cache" / _sub))
os.environ.setdefault("USE_FLAX", "0")


def process_start() -> float:
    """The wall-clock time this process started (Linux), else the time this
    module was imported."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def execute(cell: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    """Run ``cell`` (``benchmark.manifest.cell``) on ``device`` and return the
    result line's object (without the card checks of :func:`main`)."""
    import torch

    from benchmark import manifest

    t0 = process_start()
    runner = manifest.kind_module(cell["traffic"]["kind"]).run
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(0, device=device)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    res = runner(cell, seed, seconds, trace, device, lambda: time.time() - t0)
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]["limit"]} for k, v in res["numbers"].items()}
    correct = all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = manifest.reader(m["name"])(res["reading"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": res["peak"]}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        r = res["reading"]
        dev["busy_s"], dev["window_s"] = r.busy_s, r.window_s
        line["breakdown"] = {"device_ops": r.top_ops(), "idle_gaps": r.gaps}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import manifest

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    loaded = manifest.forbidden_loaded()
    if loaded:
        print(f"the process has loaded {loaded}: the benchmark runs the port alone",
              file=sys.stderr)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
