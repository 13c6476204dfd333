"""Build and bind the host entropy parser (``native/entropy_decode.cpp``).

Port of ``dwt_tpu/runtime/native.py``.  The serial bit parse of one
stream stays on the host, as in the JAX package: ``native/`` holds the
port's own copy of the JAX package's C++ source (a test keeps the two
byte-identical).  Plain ``g++`` and ``ctypes``, no build system.

The library is built at first use into
``build/dwt_tpu_torch/native/<key>/`` at the root of the checkout, where
``key`` hashes the sources and the flags (as ``runtime/build.py`` does for
the CUDA kernels).  ``-march=native`` ties the library to the machine that
built it, so ``build/`` is never copied to another one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .build import BUILD_ROOT

SRC = Path(__file__).resolve().parent.parent / "native"
LIB_NAME = "libdwt_tpu_torch_native.so"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def sources() -> list[Path]:
    return sorted(SRC.glob("*.cpp"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / "native" / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile ``native/*.cpp`` with one g++ call unless the library for
    these sources and flags exists.  Raises when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the host entropy parser "
            "(dwt_tpu_torch/native/entropy_decode.cpp) cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, *map(str, sources()), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loaded parser library, built first if needed (once a process)."""
    lib = ctypes.CDLL(str(build()))
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.dwt_entropy_decode.restype = ctypes.c_int
    lib.dwt_entropy_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64), i32, i32,
        ctypes.POINTER(ctypes.c_int32), i32]
    lib.dwt_entropy_decode_batch.restype = ctypes.c_int
    lib.dwt_entropy_decode_batch.argtypes = [
        ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), i32, i32, i32, i32, i32, ctypes.c_int]
    lib.dwt_zero_i32.restype = None
    lib.dwt_zero_i32.argtypes = [i32, ctypes.c_int64, ctypes.c_int]
    return lib


def zeroed_i32(shape) -> np.ndarray:
    """``np.zeros`` with the pages faulted in and zeroed by all cores up
    front (native ``dwt_zero_i32``) instead of lazily inside the parse."""
    out = np.empty(shape, np.int32)
    get_lib().dwt_zero_i32(out.reshape(-1), out.size, 0)
    return out


def _check_out(out: np.ndarray, shape: tuple, name: str) -> None:
    if out.shape != shape or out.dtype != np.int32:
        raise ValueError(f"{name}: out must be {shape} int32, got "
                         f"{out.shape} {out.dtype}")


def _pixels(pixels, levels: int):
    return (ctypes.c_int64 * (levels + 1))(*[int(p) for p in pixels[:levels + 1]])


def entropy_decode(stream: bytes, channels: int, levels: int, levels_max: int,
                   pixels, out: np.ndarray | None = None) -> tuple:
    """Run the native bit parser on the stream after its 6-byte header.

    ``out``, when given, is the zeroed (C, pixels[levels]) int32 buffer to
    fill (a pinned one, say); by default one is made.  Returns (coeffs
    (C, total) int32 signed, missing (C, 16), level, planes).  Raises
    ValueError on a hard error (unreadable root or planes: the reference
    exits with no output there).
    """
    lib = get_lib()
    total = int(pixels[levels])
    if out is None:
        out = zeroed_i32((channels, total))
    _check_out(out, (channels, total), "entropy_decode")
    missing = np.zeros((channels, 16), np.int32)
    planes = np.zeros(channels, np.int32)
    level = ctypes.c_int32(-1)
    rc = lib.dwt_entropy_decode(stream, len(stream), channels, levels,
                                levels_max, _pixels(pixels, levels), out,
                                missing,
                                ctypes.byref(level), planes)
    if rc != 0:
        raise ValueError("stream too short for root band")
    return out, missing, int(level.value), planes


def entropy_decode_batch(payloads: list, channels: int, levels: int,
                         levels_max: int, pixels, nthreads: int = 0,
                         out: np.ndarray | None = None) -> tuple:
    """Parse many same-geometry headerless streams (the tiles of a
    ``.dwtt`` container) on the parser's host thread pool; ``nthreads``
    0 means the hardware's concurrency.

    ``out``, when given, is the zeroed (N, C, pixels[levels]) int32 buffer
    to fill (a pinned one, say).  Returns (coeffs (N, C, total), missing
    (N, C, 16), level (N,), planes (N, C), rc (N,)); rc != 0 marks a
    stream that died inside its root band."""
    lib = get_lib()
    n = len(payloads)
    total = int(pixels[levels])
    if out is None:
        out = zeroed_i32((n, channels, total))
    _check_out(out, (n, channels, total), "entropy_decode_batch")
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(p) for p in payloads], out=offsets[1:])
    missing = np.zeros((n, channels, 16), np.int32)
    level = np.full(n, -1, np.int32)
    planes = np.zeros((n, channels), np.int32)
    rc = np.zeros(n, np.int32)
    lib.dwt_entropy_decode_batch(
        b"".join(payloads), offsets, n, channels, levels, levels_max,
        _pixels(pixels, levels), out, missing, level, planes, rc, nthreads)
    return out, missing, level, planes, rc
