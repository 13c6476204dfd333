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


@functools.lru_cache(maxsize=None)
def offsets(n: int) -> type:
    """The C struct of ``n`` int64 byte offsets that a wrapper passes by
    value: where each output lies in its one allocation."""
    return type(f"Offsets{n}", (ctypes.Structure,),
                {"_fields_": [("at", ctypes.c_int64 * n)]})


# Levels a chain of csrc/lifting_inv.cu holds (its MAXL): one more than
# the deepest pyramid's.
CHAIN_LEVELS = 17


class Chain(ctypes.Structure):
    """The C struct of an inverse transform's chain that a wrapper passes
    by value: ``n`` levels, level k's output ``h[k - 1]`` x ``w[k - 1]``,
    coarsest first."""
    _fields_ = [("n", ctypes.c_int), ("h", ctypes.c_int * CHAIN_LEVELS),
                ("w", ctypes.c_int * CHAIN_LEVELS)]


def chain(sizes) -> Chain:
    """A :class:`Chain` of the (h, w) sizes ``sizes``, coarsest first."""
    c = Chain(len(sizes))
    for k, (h, w) in enumerate(sizes):
        c.h[k], c.w[k] = h, w
    return c


class EmitPlan(ctypes.Structure):
    """The C struct of kernel 17's launch plan, by value
    (``ops/emit_tables.py:launch_plan``)."""
    _fields_ = [(k, ctypes.c_int) for k in ("np", "tf", "fpb", "bpf", "ub")]


class View(ctypes.Structure):
    """The C struct of a tensor view that a wrapper passes by value: its
    data pointer and its (frame, row, column, channel) strides in
    elements."""
    _fields_ = [("p", ctypes.c_void_p), ("f", ctypes.c_int64),
                ("r", ctypes.c_int64), ("c", ctypes.c_int64),
                ("ch", ctypes.c_int64)]


def view(t) -> View:
    """A :class:`View` of a 4-D tensor ``t``."""
    return View(t.data_ptr(), *t.stride())


class HaloArgs(ctypes.Structure):
    """The C struct of one halo level of one rank's block that the
    wrappers of kernels 18 and 19 pass by value (``ops/halo.py:_args``)."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("src", "fine", "ll", "edge",
                                                "out")]
                + [("fine_row", ctypes.c_int64)]
                + [(k, ctypes.c_int) for k in (
                    "src_rows", "src_u8", "colour", "out_u8", "s", "w",
                    "rows", "g0", "n_even", "n_upd", "prev", "next",
                    "coarsest", "C", "bp")])


class HaloLevel(ctypes.Structure):
    """One level of a pair (``ops/halo.py:Level``), as the C struct of
    ``csrc/halo_lifting.cu``."""
    _fields_ = [(k, ctypes.c_int) for k in (
        "s", "w", "rows", "g0", "n_even", "n_upd", "prev", "next",
        "coarsest")]


class PairArgs(ctypes.Structure):
    """The C struct of a launch of the pair, the two finest halo levels of
    a rank without neighbours (``ops/halo.py:_pair_args``); ``bp`` is the
    entry point's own (the row pairs of a band)."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("src", "fine", "ll", "out")]
                + [("fine_row", ctypes.c_int64)]
                + [(k, ctypes.c_int) for k in (
                    "src_rows", "src_u8", "colour", "out_u8", "C", "bp")]
                + [("lv", HaloLevel * 2)])


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
    # (det, ll, bias, blev, dst, dst_frame, dst_row, n, h, w, C, bp, F,
    #  colour, u8, stream): the views by value
    "dwt_unlift_level": (View, View, _P, _I, _P, _L, _L, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P),
    # (det, root, bias, n, C, chain, dst, dst_frame, dst_row, colour, u8,
    #  cb, K, R, pitch, Y, stream): the views and the tail's levels by value
    "dwt_unlift_tail": (View, View, _P, _I, _I, Chain, _P, _L, _L, _I, _I,
                        _I, _I, _I, _I, _I, _P),
    # (val, val_row, raw, raw_row, vli, vli_row, ord, ord_row, site, nref,
    #  S, off, widx, c0, c1, c2, chunks, nframes, T, nwords, bounds, grid,
    #  scratch, cap, stream)
    "dwt_codeword_pieces": (_P, _L, _P, _L, _P, _L, _P, _L, _P, _P, _L, _P,
                            _P, _P, _P, _P, _P, _L, _L, _L, _P, _L, _P, _L,
                            _P),
    # (S, sms, per_sm, smem): the codeword kernel's launch plan
    "dwt_codeword_plan": (_L, _P, _P, _P),
    # (pairs, pair_row, base, base_row, nS, ns_row, cin, cin_row, valid,
    #  valid_row, S, root, root_frame, root_ch, pix0, C, root_cnt,
    #  root_base, planes_base, planes, rr_ok, step_base, step_nS, rr_val, G,
    #  T, carry_end, val, raw, vli, nframes, padded_T, stream)
    "dwt_finish_tokens": (_P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _L, _P,
                          _L, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P,
                          _L, _P, _P, _P, _P, _P, _L, _L, _P),
    # (lin, lin_frame, lin_ch, nframes, C, root_pad, n, valid, tail, out,
    #  stream)
    "dwt_packed_elems": (_P, _L, _L, _L, _L, _L, _L, _P, _L, _P, _P),
    # (lin, valid, unit_chunk, chunk_base, nS, lastS, z0, zup, planes,
    #  rows, nlin, n, nchunk, group, stream)
    "dwt_plane_stats": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I,
                        _P),
    # (planes, nS_ck, lastS_ck, z0_ck, zup_ck, root, root_frame, root_ch,
    #  pix0, real, lcb, lnc, nframes, C, L, nchunk, arena, offsets, stream):
    #  the offsets of csrc/schedule.cu's 24 outputs, by value
    "dwt_schedule": (_P, _P, _P, _P, _P, _P, _L, _L, _L, _P, _P, _P, _L, _L,
                     _L, _L, _P, offsets(24), _P),
    # (order, ubase, valid_sched, step_base, nS_ck, scar, zcar, lcb,
    #  ch_start, ch_len, nframes, C, L, nchunk, n, padded_T, arena, offsets,
    #  stream): the offsets of csrc/units.cu's 8 outputs, by value
    "dwt_unit_tables": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L,
                        _L, _L, _L, _P, offsets(8), _P),
    # (off, chunks, nref, site, order, step_end, refpfx, step_base,
    #  planes, planes_max, nS_ck, nZ_ck, scar_ck, zcar_ck, elem, elen, p,
    #  flat_step, flat_ck, valid, ch_valid, vcar, nframes, T, NC, C, L,
    #  nchunk, n, nwords, wsmax, arena, offsets, plan, stream): the offsets
    #  of csrc/emit_tables.cu's 3 outputs and its launch plan, by value
    "dwt_emit_tables": (_P,) * 22 + (_L,) * 9 + (_P, offsets(3), EmitPlan,
                                                 _P),
    # (level, mode, stream): the level by value
    "dwt_halo_forward": (HaloArgs, _I, _P),
    "dwt_halo_inverse": (HaloArgs, _I, _P),
    # (pair, stream): the two levels by value
    "dwt_halo_forward_pair": (PairArgs, _P),
    "dwt_halo_inverse_pair": (PairArgs, _P),
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
