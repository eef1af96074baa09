"""Build and load the CUDA kernels of ``crfp_torch/csrc``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, into a shared library with a plain C interface
under ``crfp_torch/build/`` (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -split-compile=0 -o build/lib<name>-<hash>.so
         csrc/<name>.cu

``-split-compile=0`` lets one ``nvcc`` run its device optimisation on
every core: the longest source, ``dcn_bwd.cu`` (many template
instances), bounds the build. ``chip_smoke.py``'s build line on the H100
machine's host (8 cores, CUDA 12.9): 70.6-75.1 s without it, 38.7 s with
it, with ptxas' register and spill lines and every digest of the kernels'
results unchanged.

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. A missing ``nvcc``
or a failed build raises: there is no fallback.

The libraries are loaded with ``ctypes``, and everything that can be done
once is done once. :func:`function` configures each C entry (``argtypes``,
an int ``restype``) when it is first asked for and hands back that same
object ever after. :func:`launch`, which every dispatcher calls, then does
per call only what a launch needs: a dictionary lookup, the current
device's index (``torch.cuda.device`` is entered only for a tensor on
another card), the current stream's raw handle, taken once and without
building a ``torch.cuda.Stream`` object, and the foreign call.
Pointers and the stream pass as plain Python ints, which the configured
``c_void_p`` argument types convert; no ``ctypes`` object is built per
call. Each C entry returns ``cudaGetLastError()`` after its launches, and
:func:`launch` raises on a non-zero code with the entry's name. Nothing
here synchronises or allocates, so the launches can be captured in a CUDA
graph.

Measured with ``python -m crfp_torch.bench.launch_path`` on an NVIDIA H100
80GB HBM3 (700.00 W), torch 2.11, host clock, three runs: the bare foreign
call that launches kernel B 4.8-8.9 us, :func:`launch` around it 6.7-11.0,
the whole warp dispatcher 10.2-17.0 (one in-place PyTorch add 6.4-11.0). What :func:`launch` no longer does per call:
``torch.cuda.current_stream().cuda_stream`` 5.0-9.2 us (the raw handle:
0.2-0.4), ``with torch.cuda.device(...)`` 1.9-5.0, and ``argtypes`` set anew
with three ``c_void_p`` objects built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-split-compile=0", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


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
    """The C entry ``fn_name`` of kernel library ``lib_name``, configured
    once: the first call builds (if need be) and loads the library, sets
    the entry's argument types and its int return; every later call returns
    the same object untouched."""
    fn = _fns.get((lib_name, fn_name))
    if fn is None:
        lib = _libs.get(lib_name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[lib_name]))
            lib.crfp_error_string.argtypes = [ctypes.c_int]
            lib.crfp_error_string.restype = ctypes.c_char_p
            _libs[lib_name] = lib
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib_name, fn_name)] = fn
    return fn


def stream_handle(index: int) -> int:
    """The ``cudaStream_t`` of PyTorch's current stream on device ``index``
    as an int. ``torch._C._cuda_getCurrentRawStream`` returns it directly;
    ``torch.cuda.current_stream(index).cuda_stream``, which builds a
    ``Stream`` object first (several microseconds), is the route where that
    function is missing."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(lib_name: str, fn_name: str, argtypes: list, device: torch.device,
           *args) -> None:
    """Call the C entry ``fn_name`` with ``args`` and, last, PyTorch's
    current stream on ``device``; raise on a CUDA error code.

    ``args`` are plain Python numbers: ``tensor.data_ptr()`` (0 or None for
    a null pointer), ints and floats, in the order of ``argtypes``, whose
    last entry is the stream's. The call neither synchronises nor
    allocates."""
    fn = function(lib_name, fn_name, argtypes)
    index = device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, stream_handle(index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream_handle(index))
    if rc != 0:
        msg = _libs[lib_name].crfp_error_string(rc).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {rc}: {msg}")


def window(max_displacement: int | None) -> float:
    """The kernels' clamp argument: a negative D means no clamp."""
    return -1.0 if max_displacement is None else float(max_displacement)
