"""Kernel A's unit tables (kernel 15, ``csrc/units.cu``).

No TPU kernel to port: the JAX package computes them as XLA
(``dwt_tpu/codec/encoder.py:_unit_common``, :521, and
``_kernel_a_meta``, :550) and its scalar-prefetched grid walks them.  A
unit is one (schedule step, chunk of up to ``compact.E`` elements) pair:
U = C * PMAX * nchunk a frame, in each frame's stream order (steps in
schedule order, a step's chunks in order).  Unit u of frame f lies in
the step s whose exclusive sum of ``level_nchunk[l_s]`` over the
schedule is the last at most u, at chunk k = u less that sum of its
level: stage 1's ``ubase_sched`` (``ops/schedule.py``).
:func:`unit_tables` writes, per unit:

* the six (N, U) columns that kernel B's meta reads too: ``elem`` (the
  unit's first element of the frame's packed elements), ``elen``, ``p``,
  ``flat_step`` (the step's (c, l, p) index), ``flat_ck`` (the unit's
  (c, chunk, p) index) and ``valid`` (the step's);
* kernel A's (N * U, 8) int32 meta rows (``ops/compact.py``): the
  element row, the length, the plane, the pair window's start (the pair
  base's 128-aligned floor, clamped so the window fits the frame's pair
  buffer of ``pairbuf`` pairs, plus f * pairbuf), the offset in the
  window, the zero-run carry (``zcar_ck``), the output count (``nS_ck``,
  0 for an invalid step) and 0.  The pair base is the step's base / 2
  plus ``scar_ck``: the level-exclusive cumsums of ``nS_ck`` and
  ``nZ_ck`` are stage 1's (``ops/schedule.py``, from its walk over each
  column of chunks);
* the (N * C * nchunk, PMAX) inverse table: the meta row of each
  (frame, channel, chunk, plane) unit.

On the card one launch (``launches`` grows by 1), one unit a thread,
its outputs carved from one allocation (:func:`_layout`).  On the CPU:
:func:`unit_tables_plain`, the eager passes (searchsorted, gathers, a
scatter) the encoder ran before.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime import build
from . import compact
from ._launch import arena_layout, carve, cuda_or_cpu, need
from .plane_stats import PMAX
from .schedule import MAX_STEPS

_I32 = torch.int32
COM_KEYS = ("elem", "elen", "p", "flat_step", "flat_ck", "valid")
OUT_KEYS = COM_KEYS + ("meta", "table")
# The inputs: names, dtypes.
_IN_NAMES = ("order", "ubase_sched", "valid_sched", "step_base", "nS_ck",
             "scar_ck", "zcar_ck", "level_chunk_base", "ch_start", "ch_len")
_IN_TYPES = (_I32, _I32, torch.bool) + (_I32,) * 7
_IN_DIMS = (2, 2, 2, 4, 4, 4, 4, 1, 1, 1)


def pair_buffer(padded_T: int) -> int:
    """Pairs of one frame's buffer of kernel A: the token bucket's pairs
    and a window's slack."""
    return padded_T // 2 + compact.WTOK_BIG + 256


@functools.lru_cache(maxsize=64)
def _layout(N: int, C: int, nchunk: int) -> tuple:
    """The kernel's one allocation at a shape: (its bytes, the views of
    ``OUT_KEYS`` as ``_launch.carve`` takes them, the offsets struct the C
    entry point takes)."""
    U = C * PMAX * nchunk
    nbytes, views, offsets = arena_layout(
        [(_I32, (N, U))] * 5 + [(torch.bool, (N, U)), (_I32, (N * U, 8)),
                                (_I32, (N * C * nchunk, PMAX))])
    return (nbytes, views, build.offsets(len(offsets))(
        (ctypes.c_int64 * len(offsets))(*offsets)))


def _check(order, ubase_sched, valid_sched, step_base, nS_ck, scar_ck,
           zcar_ck, level_chunk_base, ch_start, ch_len) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on anything the kernel does not take.  One pass over
    the tensors: the wrapper's host time is most of the call's."""
    ts = (order, ubase_sched, valid_sched, step_base, nS_ck, scar_ck,
          zcar_ck, level_chunk_base, ch_start, ch_len)
    if (tuple(t.dtype for t in ts) != _IN_TYPES
            or tuple(t.dim() for t in ts) != _IN_DIMS):
        for name, t, dt, nd in zip(_IN_NAMES, ts, _IN_TYPES, _IN_DIMS):
            need(f"unit_tables {name}", t, dt, nd)
    N, S = order.shape
    C, L, nchunk = step_base.shape[1], step_base.shape[2], nS_ck.shape[2]
    ck = (N, C, nchunk, PMAX)
    if (ubase_sched.shape != (N, S) or valid_sched.shape != (N, S)
            or step_base.shape != (N, C, L, PMAX) or S != C * L * PMAX
            or nS_ck.shape != ck or scar_ck.shape != ck
            or zcar_ck.shape != ck or level_chunk_base.numel() != L
            or ch_start.numel() != nchunk or ch_len.numel() != nchunk):
        raise ValueError(
            f"unit_tables: inconsistent shapes: order {tuple(order.shape)}, "
            f"step grid {tuple(step_base.shape)}, chunk tables "
            f"{tuple(nS_ck.shape)}, {level_chunk_base.numel()} levels, "
            f"{ch_start.numel()} chunks")
    if not cuda_or_cpu("unit_tables", ts):
        return False
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("unit_tables: every table must be contiguous")
    if S > MAX_STEPS:
        raise ValueError(f"unit_tables: {S} steps a frame, past the "
                         f"kernel's {MAX_STEPS}")
    if N * C * nchunk * PMAX >= 2**31:
        raise ValueError(f"unit_tables: {N} frames of {C * nchunk * PMAX} "
                         "units pass int32 indices")
    return True


def unit_tables_plain(order, ubase_sched, valid_sched, step_base, nS_ck,
                      scar_ck, zcar_ck, level_chunk_base, ch_start, ch_len,
                      n: int, padded_T: int) -> tuple:
    """Plain PyTorch version of :func:`unit_tables`."""
    _check(order, ubase_sched, valid_sched, step_base, nS_ck, scar_ck,
           zcar_ck, level_chunk_base, ch_start, ch_len)
    N, S = order.shape
    C, L, nchunk = step_base.shape[1], step_base.shape[2], nS_ck.shape[2]
    dev = order.device
    U = C * PMAX * nchunk

    # Each unit's step, chunk and plane, in each frame's stream order.
    c_s = order // (L * PMAX)
    l_s = (order // PMAX) % L
    p_s = order % PMAX
    u = torch.arange(U, dtype=_I32, device=dev).expand(N, U).contiguous()
    sidx = torch.searchsorted(ubase_sched, u, right=True) - 1
    k = u - ubase_sched.gather(1, sidx)
    c_u, l_u, p_u = (x.gather(1, sidx) for x in (c_s, l_s, p_s))
    chunkid = level_chunk_base[l_u.long()] + k
    elem = c_u * n + ch_start[chunkid.long()]
    flat_ck = (c_u * nchunk + chunkid) * PMAX + p_u
    com = dict(elem=elem, elen=ch_len[chunkid.long()], p=p_u,
               flat_step=order.gather(1, sidx), flat_ck=flat_ck,
               valid=valid_sched.gather(1, sidx))

    # Kernel A's meta rows over the N frames: frame f's rows read its
    # elements (col 0 past the earlier frames' N*C*n) and write pairs
    # f * pairbuf onwards (col 3).
    fck = flat_ck.long()
    nS_u = nS_ck.reshape(N, -1).gather(1, fck)
    u_pair0 = ((step_base.reshape(N, -1).gather(1, com["flat_step"].long())
                >> 1) + scar_ck.reshape(N, -1).gather(1, fck))
    pairbuf = pair_buffer(padded_T)
    # The window start is kept as the TPU kernel's (128-aligned, clipped),
    # so the table compares one to one; the kernel writes at col3 + col4.
    ws = torch.clamp(u_pair0 & ~127, 0,
                     (pairbuf - compact.WTOK_BIG) // 128 * 128)
    f = torch.arange(N, dtype=_I32, device=dev)[:, None]
    meta = torch.stack([
        (elem + f * (C * n)) // compact.SUBA, com["elen"], p_u,
        ws + f * pairbuf, u_pair0 - ws,
        zcar_ck.reshape(N, -1).gather(1, fck),
        torch.where(com["valid"], nS_u, 0),
        torch.zeros_like(nS_u),
    ], dim=2).to(_I32).reshape(-1, 8)

    # The meta row of each (frame, channel, chunk, plane) unit: the
    # inverse of the permutation flat_ck, frame f's units offset by f * U.
    flat = (fck + f.long() * U).reshape(-1)
    table = torch.empty(N * U, dtype=_I32, device=dev)
    table[flat] = torch.arange(N * U, dtype=_I32, device=dev)
    return (*(com[k] for k in COM_KEYS), meta, table.reshape(-1, PMAX))


def unit_tables(order, ubase_sched, valid_sched, step_base, nS_ck, scar_ck,
                zcar_ck, level_chunk_base, ch_start, ch_len, n: int,
                padded_T: int) -> tuple:
    """Stage 1's (N, S) ``order``, ``ubase_sched`` and ``valid_sched``,
    (N, C, L, PMAX) ``step_base``, (N, C, nchunk, PMAX) ``nS_ck``,
    ``scar_ck`` and ``zcar_ck``, the levels' first chunks (L,), the chunks'
    starts and lengths (nchunk,), the detail elements of a channel ``n``
    and the token bucket ``padded_T`` -> the (N, U) columns of
    ``COM_KEYS`` (int32, ``valid`` bool), kernel A's (N * U, 8) int32 meta
    rows and its (N * C * nchunk, PMAX) int32 unit table.  ``ubase_sched``
    must be the schedule's (each step's first unit).  On the card one
    launch (``launches`` grows by 1); its outputs are views of one new
    allocation a call, 256-byte aligned."""
    if not _check(order, ubase_sched, valid_sched, step_base, nS_ck,
                  scar_ck, zcar_ck, level_chunk_base, ch_start, ch_len):
        return unit_tables_plain(order, ubase_sched, valid_sched, step_base,
                                 nS_ck, scar_ck, zcar_ck, level_chunk_base,
                                 ch_start, ch_len, n, padded_T)
    N = order.shape[0]
    C, L, nchunk = step_base.shape[1], step_base.shape[2], nS_ck.shape[2]
    nbytes, views, offsets = _layout(N, C, nchunk)
    outs = carve(nbytes, views, order.device)
    if N:
        build.check(build.library().dwt_unit_tables(
            order.data_ptr(), ubase_sched.data_ptr(), valid_sched.data_ptr(),
            step_base.data_ptr(), nS_ck.data_ptr(), scar_ck.data_ptr(),
            zcar_ck.data_ptr(), level_chunk_base.data_ptr(),
            ch_start.data_ptr(), ch_len.data_ptr(), N, C, L, nchunk, n,
            padded_T, outs[0].data_ptr(), offsets, build.stream_of(order)),
            "unit_tables")
        unit_tables.launches += 1
    return tuple(outs)


unit_tables.launches = 0
