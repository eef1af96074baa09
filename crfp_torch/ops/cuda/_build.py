"""Build and load the CUDA kernels of ``crfp_torch/csrc``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, into a shared library with a plain C interface
under ``crfp_torch/build/`` (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. The libraries are
loaded with ``ctypes``; pointers and the stream pass as ``c_void_p``. Each
C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when it is not 0. A missing ``nvcc`` or a failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "crfp_torch CUDA kernels are built from crfp_torch/csrc at first use")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for dep in sorted(SRC_DIR.glob("*.cuh")):
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel.

    Returns {kernel name: library path}. Raises on a missing ``nvcc`` or a
    failed compile, with the compiler's output."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    targets = {s.stem: _target(s) for s in sources}
    todo = [s for s in sources if not targets[s.stem].exists()]
    if not todo:
        return targets
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for s in todo:
        tmp = targets[s.stem].with_suffix(f".{os.getpid()}.tmp")
        p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        procs.append((s, tmp, p))
    failed = []
    for s, tmp, p in procs:
        log, _ = p.communicate()
        (BUILD_DIR / f"{s.stem}.log").write_text(log)
        if p.returncode != 0:
            failed.append(f"{s.name} (exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, targets[s.stem])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def function(lib_name: str, fn_name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry ``fn_name`` of kernel library ``lib_name`` (built on
    first use), with its argument types set and an int return."""
    lib = _libs.get(lib_name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[lib_name]))
        lib.crfp_error_string.argtypes = [ctypes.c_int]
        lib.crfp_error_string.restype = ctypes.c_char_p
        _libs[lib_name] = lib
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, lib_name: str, fn_name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = _libs[lib_name].crfp_error_string(rc).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {rc}: {msg}")


def window(max_displacement: int | None) -> float:
    """The kernels' clamp argument: a negative D means no clamp."""
    return -1.0 if max_displacement is None else float(max_displacement)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
