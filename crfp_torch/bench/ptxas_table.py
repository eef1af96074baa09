"""Registers and spills of every kernel instantiation of two builds of
``crfp_torch/csrc``, side by side, from the ``-Xptxas -v`` lines that
``crfp_torch/ops/cuda/_build.py`` keeps in each build directory
(``<kernel>.log``). An instantiation is matched by its mangled name (its
anonymous namespace, which hashes the checkout's path, set aside), so a
kernel whose template or parameters did not change is compared with
itself; those only one build has are listed as gone or new.

    python -m crfp_torch.bench.ptxas_table PARENT_BUILD_DIR CHANGE_BUILD_DIR

Prints, per kernel library, how many common instantiations have equal
registers, stack and spills, every one that differs, and the counts of
the gone and new ones; the last line is a JSON summary. Reads no card."""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


_ANON = re.compile(r"(\d+)_GLOBAL__N__")


def _anonymous(name: str) -> str:
    """A mangled name with its anonymous namespace (whose mangled form hashes
    the source's path, so it differs between two checkouts) named ANON."""
    m = _ANON.search(name)
    if m is None:
        return name
    end = m.end(1) + int(m.group(1))
    return name[:m.start()] + "4ANON" + name[end:]


def parse(log: str) -> dict[str, dict]:
    """{mangled entry name (its anonymous namespace named ANON): {"regs",
    "stack", "spill_st", "spill_ld"}} of one build log."""
    out: dict[str, dict] = {}
    entry = props = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = _anonymous(m.group(1))
            out.setdefault(entry, {})
        elif m := _PROPS.search(line):
            props = _anonymous(m.group(1))
        elif (m := _STACK.search(line)) and props in out:
            out[props].update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                              spill_ld=int(m.group(3)))
        elif (m := _REGS.search(line)) and entry is not None:
            out[entry]["regs"] = int(m.group(1))
    return out


def _demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None or not names:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    return dict(zip(names, res.stdout.splitlines())) if res.returncode == 0 else \
        {n: n for n in names}


def compare(parent: Path, change: Path) -> dict:
    """{kernel library: {"equal", "common", "differ": [...], "gone", "new"}}."""
    summary = {}
    for log in sorted(parent.glob("*.log")):
        other = change / log.name
        if not other.exists():
            continue
        a, b = parse(log.read_text()), parse(other.read_text())
        common = sorted(set(a) & set(b))
        differ = [n for n in common if a[n] != b[n]]
        names = _demangle(differ)
        summary[log.stem] = {
            "equal": len(common) - len(differ), "common": len(common),
            "differ": [{"kernel": names[n], "parent": a[n], "change": b[n]} for n in differ],
            "gone": len(set(a) - set(b)), "new": len(set(b) - set(a))}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    args = ap.parse_args(argv)
    summary = compare(args.parent, args.change)
    for lib, s in summary.items():
        print(f"[ptxas] {lib}: {s['equal']} of {s['common']} common instantiations equal "
              f"(registers, stack, spills); {s['gone']} gone, {s['new']} new")
        for d in s["differ"]:
            print(f"[ptxas]   differs: {d['kernel']}: parent {d['parent']} change {d['change']}")
    total = sum(s["equal"] for s in summary.values()), sum(s["common"] for s in summary.values())
    print(json.dumps({"equal": total[0], "common": total[1],
                      "libraries": {k: {x: v for x, v in s.items() if x != "differ"}
                                    for k, s in summary.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
