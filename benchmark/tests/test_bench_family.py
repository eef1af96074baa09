"""A new model enters the benchmark as new files and new entries alone.

In a copy of the benchmark, the v18 family is copied under another name
(``families/v18_copy.py``), a configuration file names it, its cell gets a
limits file, and the manifest gains the configuration and the cell. A tiny
run of that cell, in a fresh process on the copy, is correct and reads the
same numbers as the v18 cell it copies, and no file that the copy held
before is written."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from benchmark import manifest

NEW = "copy.streams4_1080p"
OLD = "ref.streams4_1080p"

RUN = """
import json, torch
from benchmark.run import execute
from benchmark.tests.tiny import tiny_cell
out = {}
for name in (%r, %r):
    cell = tiny_cell(name)
    line = execute(cell, 41, 0.0, False, torch.device("cpu"))
    out[name] = {"correct": line["correct"], "family": cell["family"].__file__,
                 "checks": {k: c["value"] for k, c in line["checks"].items()}}
print(json.dumps(out))
""" % (NEW, OLD)


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_family_is_only_new_files(tmp_path):
    root = tmp_path / "tree"
    bench = root / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(bench)

    # the new files: a family, a configuration that names it, the cell's limits
    shutil.copy(bench / "families" / "v18.py", bench / "families" / "v18_copy.py")
    conf = json.loads((bench / "configs" / "v18_mid32_ref.json").read_text())
    conf.update(name="v18_copy_ref", family="v18_copy")
    (bench / "configs" / "v18_copy_ref.json").write_text(json.dumps(conf))
    shutil.copy(bench / "limits" / f"{OLD}.json", bench / "limits" / f"{NEW}.json")

    # the new entries
    m = manifest.load()
    entry = {c["name"]: c for c in m["configs"]}["v18_mid32_ref"]
    m["configs"].append(dict(entry, name="v18_copy_ref",
                             file="benchmark/configs/v18_copy_ref.json"))
    cell = {w["name"]: w for w in m["workloads"]}[OLD]
    m["workloads"].append(dict(cell, name=NEW, config="v18_copy_ref"))
    for metric in m["end_to_end"] + m["per_layer"]:
        if OLD in metric.get("workloads", []):
            metric["workloads"].append(NEW)
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.pathsep.join([str(root), str(manifest.ROOT)]))
    out = subprocess.run([sys.executable, "-c", RUN], cwd=root, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got[NEW]["correct"] and got[OLD]["correct"]
    assert got[NEW]["family"] == str(bench / "families" / "v18_copy.py")
    assert got[NEW]["checks"] == got[OLD]["checks"]

    after = _files(bench)
    assert {p: after[p] for p in before} == before
    assert set(after) - set(before) == {
        p.relative_to(bench) for p in (bench / "families" / "v18_copy.py",
                                       bench / "configs" / "v18_copy_ref.json",
                                       bench / "limits" / f"{NEW}.json")}
