"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name, and the reference loads nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from benchmark import manifest

BENCH = manifest.BENCH_DIR
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(manifest.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "crfp_torch" not in top_level_imports(path)


def test_prefix_is_not_a_match():
    """``crfp_torch`` begins with the JAX package's name and is not it."""
    assert manifest.forbidden_loaded(["crfp_torch.ops", "crfp_tpu_x", "jaxtyping"]) == []
    assert manifest.forbidden_loaded(["crfp_tpu.models", "jax", "numpy"]) == ["crfp_tpu", "jax"]


def test_a_run_loads_no_jax():
    """A tiny run of each kind in a fresh process leaves no JAX module."""
    code = (
        "import sys, torch\n"
        "from benchmark.tests.tiny import tiny_cell\n"
        "from benchmark.run import execute\n"
        "from benchmark import manifest\n"
        "for n in ('deploy.streams4_1080p', 'ref.train_sh'):\n"
        "    execute(tiny_cell(n), 3, 0.1, False, torch.device('cpu'))\n"
        "print(manifest.forbidden_loaded())\n")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(manifest.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


OUTSIDE = [p for p in SOURCES if not {"families", "reference"} & set(p.relative_to(BENCH).parts)]


@pytest.mark.parametrize("path", OUTSIDE, ids=lambda p: str(p.relative_to(BENCH)))
def test_only_the_families_know_the_model(path):
    """Outside ``benchmark/families/`` and ``benchmark/reference/`` no module
    names a model class of either side, and the harness (tests aside) takes
    nothing of the port but its store of spans."""
    tree = ast.parse(path.read_text())
    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    used |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    used |= {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) for a in n.names}
    assert not used & {"RuntimeV18", "Trunk", "CRFPRuntimeV18", "CRFP"}
    if "tests" in path.relative_to(BENCH).parts:
        return
    port = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            port |= {a.name for a in node.names if a.name.split(".")[0] == "crfp_torch"}
        elif isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == "crfp_torch":
            port |= {f"{node.module}.{a.name}" for a in node.names}
    assert port <= {"crfp_torch.trace"}, port
