"""``BENCHMARK.json`` against the rules it is checked by, and every name in
it resolving to a file of the benchmark."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import manifest

M = manifest.load()
ROOT = manifest.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
TEXT = re.compile(r"[^\t\n\r]{1,200}\Z")
METRICS = M["end_to_end"] + M["per_layer"]
CELLS = [w["name"] for w in M["workloads"]]
KINDS = sorted({json.loads(p.read_text())["kind"]
                for p in (manifest.BENCH_DIR / "traffic").glob("*.json")})


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len(manifest.MANIFEST.read_bytes()) <= 64 * 1024
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert len(M["command"]) <= 32
    for word in M["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in M["paths"])
            assert (ROOT / word).is_file()


def test_files_under_paths_are_named_from_name_characters():
    for p in M["paths"]:
        for f in (ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts:
                assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(f.relative_to(ROOT))), f


@pytest.mark.parametrize("entry", M["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and TEXT.match(entry["source"]) and TEXT.match(entry["why"])
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    assert any(entry["file"].startswith(p + "/") for p in M["paths"])
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"] and conf["reduced"] == entry["reduced"]
    assert conf["dtype"] in ("float32", "bfloat16") and conf["peak_flops"] > 0
    assert entry["name"] in {w["config"] for w in M["workloads"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    w = {x["name"]: x for x in M["workloads"]}[name]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and TEXT.match(w["why"])
    cell = manifest.cell(name)
    assert cell["traffic"]["kind"] in KINDS
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and cell["per_layer"]
    assert set(cell["limits"]) and all(v["limit"] > 0 for v in cell["limits"].values())


def test_cells_unique_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(set(CELLS)) == len(CELLS)
    assert 1 <= len(CELLS) <= 24
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    per_layer = metric in M["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if per_layer:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert TEXT.match(metric["layer"])
        moves = {m["name"]: m for m in M["end_to_end"]}[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in moves.get("workloads", CELLS)
        assert callable(manifest.reader(metric["name"]))
        if metric["unit"] == "%":  # a share of a roofline or of a peak
            base = metric["name"].split(".")[0]
            assert base.endswith("_roofline") or "mfu" in base
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_names_unique():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert len({c["name"] for c in M["configs"]}) == len(M["configs"])


def test_one_layer_name_per_layer():
    for m in M["per_layer"]:
        prefix = m["name"].split(".")[0]
        same = {x["layer"] for x in M["per_layer"] if x["name"].split(".")[0] == prefix}
        assert len(same) == 1


@pytest.mark.parametrize("entry", M["configs"], ids=lambda c: c["name"])
def test_config_family_has_the_contract(entry):
    """A configuration's ``family`` resolves to a module of
    ``benchmark/families/`` with everything that its cells' kinds call."""
    family = manifest.family(json.loads((ROOT / entry["file"]).read_text())["family"])
    kinds = {manifest.cell(w["name"])["traffic"]["kind"] for w in M["workloads"]
             if w["config"] == entry["name"]}
    for kind in kinds:
        for need in manifest.kind_module(kind).FAMILY:
            assert callable(getattr(family, need, None)), (kind, need)


@pytest.mark.parametrize("kind", KINDS)
def test_every_traffic_kind_has_a_module(kind):
    kind_mod = manifest.kind_module(kind)
    assert kind_mod.__file__ == str(manifest.BENCH_DIR / f"{kind}.py")
    assert callable(kind_mod.run) and callable(kind_mod.control) and kind_mod.FAULTS
    assert all(callable(f) for f in kind_mod.FAULTS.values())


def test_unknown_kind_and_family_are_named():
    with pytest.raises(KeyError, match="no_such_kind"):
        manifest.kind_module("no_such_kind")
    with pytest.raises(KeyError, match="no_such_family"):
        manifest.family("no_such_family")
