"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is
``benchmark/configs/<config>.json`` (the manifest's ``file``), and a traffic
mix, ``benchmark/traffic/<traffic>.json``. The configuration file names its
model's family, ``benchmark/families/<family>.py``: the port's model and its
plain reference (``benchmark/reference/``), built from the configuration. The
mix names its kind, whose module is ``benchmark/<kind>.py``. Each metric of
``per_layer`` is read by ``benchmark/layer_metrics/<name>.py``, and each
cell's comparison limits are in ``benchmark/limits/<cell>.json``. A later
model, configuration, mix, kind, metric or cell is new files and new entries;
no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

# what the process that prints a result may not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "crfp_tpu")

# a configuration file's ``dtype``
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load(path: Path = MANIFEST) -> dict:
    return json.loads(path.read_text())


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell(name: str, manifest: dict | None = None) -> dict:
    """Everything a run of cell ``name`` needs: its entry, configuration,
    traffic mix, limits, and the end-to-end and per-layer metrics it
    reports."""
    m = manifest or load()
    entries = {w["name"]: w for w in m["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    w = entries[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    config = _read_json(ROOT / conf["file"])
    e2e = [x for x in m["end_to_end"] if name in x.get("workloads", [name])]
    reported = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"]
             if (name in x["workloads"] if "workloads" in x else x["moves"] in reported)]
    return {
        "name": name, "chips": w["chips"],
        "config": config, "family": family(config["family"]),
        "traffic": _read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        "limits": _read_json(BENCH_DIR / "limits" / f"{name}.json"),
        "end_to_end": e2e, "per_layer": layer,
    }


def reader(metric: str):
    """The ``read`` function of ``benchmark/layer_metrics/<metric>.py``."""
    path = BENCH_DIR / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_layer_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(name: str):
    """The module ``benchmark/families/<name>.py``, loaded once a process
    (so that a patch of one of its functions reaches every caller)."""
    key = f"benchmark_family_{name}"
    if key not in sys.modules:
        path = BENCH_DIR / "families" / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no model family {name!r}: {path.relative_to(ROOT)} is missing")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def kind_module(kind: str):
    """The module of traffic kind ``kind``, ``benchmark/<kind>.py``, whose
    ``run`` runs a cell of that kind."""
    path = BENCH_DIR / f"{kind}.py"
    if not kind.isidentifier() or not path.is_file():
        raise KeyError(f"no module for traffic kind {kind!r}: {path.relative_to(ROOT)} is missing")
    mod = importlib.import_module(f"benchmark.{kind}")
    if not callable(getattr(mod, "run", None)):
        raise KeyError(f"benchmark/{kind}.py has no run() for traffic kind {kind!r}")
    return mod


def forbidden_loaded(modules=None) -> list[str]:
    """Modules of JAX or of the JAX package that this process has loaded
    (or that ``modules`` names), compared by whole top-level name."""
    tops = {k.split(".", 1)[0] for k in list(sys.modules if modules is None else modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
