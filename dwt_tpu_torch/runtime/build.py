"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links the objects into one shared
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
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry points -> argument types.  Every pointer and the CUDA stream go
# in as c_void_p: an undeclared Python int would be passed as a 32-bit int
# and cut the pointer.
ENTRY_POINTS = {
    # (co, src, out, nlin, C, nframes, frame_elems, stream)
    "dwt_hilbert_gather": (_P, _P, _P, _L, _I, _I, _L, _P),
    # (lin, src, sq_ptr, runs, out, H, W, L, C, nruns, group, stream)
    "dwt_hilbert_scatter": (_P, _P, _P, _P, _P, _I, _I, _L, _I, _L, _I,
                            _P),
    # (vmag, meta, table, hist, groups, P, U, sub, E, nsub, stream)
    "dwt_compact_count": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # (vmag, meta, table, hist, pairs, groups, P, U, sub, E, nsub, npairs,
    #  stream)
    "dwt_compact_place": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L,
                          _P),
    # (vmag, meta, table, hist, words, groups, P, U, sub, E, nsub, nwords,
    #  stream)
    "dwt_refbits_scatter": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L,
                            _P),
    # (widx, c0, c1, c2, words, flag, ntok, nwords, stream)
    "dwt_pack_words": (_P, _P, _P, _P, _P, _P, _L, _L, _P),
    # (in, out, R, C, elem_bytes, vec, stream)
    "dwt_transpose": (_P, _P, _L, _L, _I, _I, _P),
    # (tile, idx, out, bad, n, stream)
    "dwt_engine_probe": (_P, _P, _P, _P, _I, _P),
    # (val, val_row, vli, vli_row, out, nframes, T, scratch, cap, vec,
    #  stream)
    "dwt_vli_orders": (_P, _L, _P, _L, _P, _L, _L, _P, _L, _I, _P),
    # (src, src_u8, colour, src_frame, src_row, coeff, co_frame, co_row, ll,
    #  ll_frame, ll_row, n, h, w, C, bp, stream)
    "dwt_lift_level": (_P, _I, _I, _L, _L, _P, _L, _L, _P, _L, _L, _I, _I,
                       _I, _I, _I, _P),
    # (src, src_u8, colour, src_frame, src_row, coeff, co_frame, co_row, n,
    #  h, w, C, nlev, stream)
    "dwt_lift_tail": (_P, _I, _I, _L, _L, _P, _L, _L, _I, _I, _I, _I, _I,
                      _P),
    # (lin, valid, unit_chunk, chunk_base, nS, lastS, z0, zup, planes,
    #  rows, nlin, n, nchunk, group, stream)
    "dwt_plane_stats": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I,
                        _P),
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
    """Compile every ``csrc/*.cu`` (one nvcc process each, in parallel) and
    link them, unless the library for these sources exists.  Returns
    (library path, seconds spent in nvcc; 0.0 when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    exe, pid = nvcc(), os.getpid()
    objs = [out.with_name(f"{src.stem}.{pid}.o") for src in sources()]
    tmp = out.with_name(f"{LIB_NAME}.{pid}.tmp")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([exe, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources(), objs)]
    outputs = [p.communicate() for p in procs]  # waits for every process
    failed = [(src, p.returncode, o, e) for src, p, (o, e)
              in zip(sources(), procs, outputs) if p.returncode != 0]
    link = None
    if not failed:
        link = subprocess.run([exe, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
    dt = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{src.name} ({rc}):\n{o}\n{e}" for src, rc, o, e in failed))
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
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


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, for a launch: the
    raw handle, as PyTorch's own kernel launchers read it, without the
    Python stream object that ``torch.cuda.current_stream`` builds (host
    time is what the small launches cost)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
