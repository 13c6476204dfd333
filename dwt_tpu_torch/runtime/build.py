"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` goes to ONE ``nvcc`` call that writes one shared
library with a plain ``extern "C"`` interface, loaded with ``ctypes``.
No PyTorch header is compiled (a source that includes them takes minutes
to build where this takes seconds), and neither ``ninja`` nor
``torch.utils.cpp_extension`` is needed.

The library is built at first use into ``build/dwt_tpu_torch/<key>/`` at
the root of the checkout, where ``key`` hashes the sources and the flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dwt_tpu_torch"
LIB_NAME = "libdwt_tpu_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry points -> argument types.  Every pointer and the CUDA stream go
# in as c_void_p: an undeclared Python int would be passed as a 32-bit int
# and cut the pointer.
ENTRY_POINTS = {
    # (co, src, out, nlin, C, stream)
    "dwt_hilbert_gather": (_P, _P, _P, _L, _I, _P),
    # (vmag, meta, pairs, units, sub, E, npairs, stream)
    "dwt_compact_tokens": (_P, _P, _P, _I, _I, _I, _L, _P),
    # (vmag, meta, words, units, sub, E, nwords, stream)
    "dwt_scatter_refbits": (_P, _P, _P, _I, _I, _I, _L, _P),
    # (widx, c0, c1, c2, words, ntok, nwords, stream)
    "dwt_pack_words": (_P, _P, _P, _P, _P, _L, _L, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _key() / LIB_NAME


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (not on PATH, nor under CUDA_HOME or "
            "/usr/local/cuda): the CUDA kernels cannot be built")
    return path


def build() -> tuple[Path, float]:
    """Compile every ``csrc/*.cu`` with one nvcc call unless the library
    for these sources exists.  Returns (library path, seconds spent in
    nvcc; 0.0 when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file
    return out, dt


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once a process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.dwt_error_string.argtypes = [ctypes.c_int]
    lib.dwt_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = library().dwt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {msg}")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
