"""Build + ctypes bindings for the host preprocessing library
(preprocess.cpp; crfp_tpu/native/bindings.py).

The library is compiled on first use with ``g++ -O3 -march=native
-fopenmp`` into ``crfp_torch/build/`` (its name carries a hash of the source
and the flags) and loaded with ctypes. Where it does not build (no
compiler), ``native_available()`` is false and the readers take their
Pillow/numpy path, the JAX package's selection rule. This is host code: the
data pipeline runs on the CPU and the train step moves its batches to the
card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libcrfp_native-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name of its own per process: loader processes may build at once
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL | None:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        target = library_path()
        try:
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or ""
            print(f"crfp_torch native preprocess: build failed ({e}) {detail.strip()}; "
                  "the readers use Pillow/numpy", file=sys.stderr)
            _failed = True
            return None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        c = ctypes.c_int
        lib.resize_bicubic_u8.argtypes = [u8p, c, c, c, c, u8p, c, c, c]
        lib.resize_bicubic_u8.restype = None
        lib.crop_normalize_flip_f32.argtypes = [u8p, c, c, c, c, f32p, c, c, c, c, c, c, c]
        lib.crop_normalize_flip_f32.restype = None
        lib.fill_fovea_f32.argtypes = [f32p, c, c, c, c, i32p, c, c, f32p, f32p, c]
        lib.fill_fovea_f32.restype = None
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native preprocess library did not build "
                           "(native_available() is false)")
    return lib


def resize_bicubic_u8(src: np.ndarray, dh: int, dw: int, nthreads: int = 1) -> np.ndarray:
    """(T, H, W, C) uint8 -> (T, dh, dw, C) uint8, PIL-compatible bicubic.

    nthreads: OpenMP threads. Keep 1 when called from loader worker
    threads (the pool already parallelizes across samples); raise it for
    single-threaded bulk use."""
    lib = _lib_or_raise()
    src = np.ascontiguousarray(src, np.uint8)
    t, sh, sw, c = src.shape
    dst = np.empty((t, dh, dw, c), np.uint8)
    lib.resize_bicubic_u8(src, t, sh, sw, c, dst, dh, dw, nthreads)
    return dst


def crop_normalize_flip_f32(
    src: np.ndarray, y0: int, x0: int, ch: int, cw: int,
    hflip: bool = False, vflip: bool = False, nthreads: int = 1,
) -> np.ndarray:
    """(T, H, W, C) uint8 -> (T, ch, cw, C) float32 in [0, 1], cropped at
    (y0, x0) and optionally flipped."""
    lib = _lib_or_raise()
    src = np.ascontiguousarray(src, np.uint8)
    t, h, w, c = src.shape
    if not (0 <= y0 and y0 + ch <= h and 0 <= x0 and x0 + cw <= w):
        raise ValueError(f"crop ({y0}, {x0}, {ch}, {cw}) outside a {h}x{w} frame")
    dst = np.empty((t, ch, cw, c), np.float32)
    lib.crop_normalize_flip_f32(src, t, h, w, c, dst, y0, x0, ch, cw,
                                int(hflip), int(vflip), nthreads)
    return dst


def fill_fovea_f32(gt: np.ndarray, coords: np.ndarray, fh: int, fw: int,
                   nthreads: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """gt (T, H, W, C) float32, coords (T, 2) top-left (y, x) -> (fovea
    frames (T, H, W, C), masks (T, H, W, 1))."""
    lib = _lib_or_raise()
    gt = np.ascontiguousarray(gt, np.float32)
    t, h, w, c = gt.shape
    coords = np.ascontiguousarray(coords, np.int32)
    if coords.shape != (t, 2):
        raise ValueError(f"coords {coords.shape}, expected ({t}, 2)")
    fv = np.empty_like(gt)
    mask = np.empty((t, h, w), np.float32)
    lib.fill_fovea_f32(gt, t, h, w, c, coords, fh, fw, fv, mask, nthreads)
    return fv, mask[..., None]
