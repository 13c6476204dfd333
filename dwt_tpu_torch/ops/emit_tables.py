"""The emit half's step tables (kernel 17, ``csrc/emit_tables.cu``).

No TPU kernel to port: the JAX package computes these tables as XLA
fused into its encode (``dwt_tpu/codec/encoder.py``: the tail of
``_codeword_contribs``, :916-922; ``_bit_partials``, :1000;
``_kernel_b_meta``, :1018; ``_layer_boundaries``, :844, with the int32
total of :1137).  :func:`emit_tables` takes kernel 11's offsets and
chunk sums (``ops/codeword.py``), stage 1's step and chunk tables, kernel
15's unit columns (``ops/units.py``) and the pyramid's chunk tables, for
the N frames of a sub-batch, and writes:

* ``refstart`` (N, C, L, PMAX): each step's first refinement bit,
  ``off[end] - inj_le_end + refpfx`` with ``end`` the step's last token
  slot clamped to [0, T - 1] and ``inj_le_end`` the refinement bits
  injected at sites at most ``end``;
* ``bits_parts`` (N, K): int32 partial sums whose Python-int total is the
  exact stream bit count, K = ceil(NC / 512) + ceil(S / 8);
* kernel B's (N * U, 8) meta rows (``ops/compact.py``): the element row,
  the length, the plane, the word window (the first refinement bit's
  word, 128-aligned and clamped so the window fits the frame's words,
  plus f * nwords), the bit offset in the window, 0, the unit's
  refinement bits (0 for an invalid step) and 0;
* ``layer_ends`` (N, LMAX): the bit at which each quality layer ends,
  capped by the frame's int32 total of ``bits_parts``;
* ``head``: the pack kernel's order flag (0), then ``bits_parts`` and
  ``layer_ends`` (views of it), which the encoder copies to the host in
  one copy.

On the card two launches (``launches`` grows by 1): a block a frame for
the step tables (each step's first refinement bit, the bit partials, the
layer ends), then a thread a unit for the meta rows (each summing its
chunk's level prefix of refinement bits itself); its outputs are views of
one allocation (:func:`_layout`).  On the CPU:
:func:`emit_tables_plain`, the eager passes the encoder ran before.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime import build
from . import compact
from ._launch import arena_layout, carve, cuda_or_cpu, need
from .plane_stats import PMAX, _excl_cumsum
from .schedule import MAX_STEPS

_I32 = torch.int32
LMAX = 64  # bound on progressive quality layers (2*max(levels,planes)-1)
BIGBIT = 2**31 - 1
PART_CHUNKS = 512  # kernel 11's chunk sums a token part of bits_parts
PART_STEPS = 8     # steps a refinement part
# The inputs: names, dtypes, dimensions.
_IN_NAMES = ("off", "chunks", "nref_step", "inj_site", "step_end", "refpfx",
             "step_base", "planes", "planes_max", "nS_ck", "nZ_ck", "elem",
             "elen", "p", "flat_step", "flat_ck", "valid", "ch_valid",
             "level_chunk_base", "level_nchunk")
_IN_TYPES = (_I32,) * 16 + (torch.bool,) + (_I32,) * 3
_IN_DIMS = (2, 2, 2, 2, 4, 4, 4, 2, 1, 4, 4, 2, 2, 2, 2, 2, 2, 1, 1, 1)


def parts_count(nchunks: int, S: int) -> int:
    """K, the columns of ``bits_parts``."""
    return -(-nchunks // PART_CHUNKS) + -(-S // PART_STEPS)


def steps_threads(S: int) -> int:
    """Threads a block of the step tables' launch at ``S`` steps a frame:
    the least power of two of at least 64 whose double holds S (its
    bitonic sort exchanges a pair a thread)."""
    if S > MAX_STEPS:
        raise ValueError(f"emit_tables: {S} steps a frame, past the "
                         f"kernel's {MAX_STEPS}")
    nt = 64
    while 2 * nt < S:
        nt *= 2
    return nt


@functools.lru_cache(maxsize=64)
def _layout(N: int, C: int, L: int, nchunk: int, K: int) -> tuple:
    """The kernel's one allocation at a shape: (its bytes, the views of
    refstart, meta and head as ``_launch.carve`` takes them, the offsets
    struct the C entry point takes)."""
    U = C * nchunk * PMAX
    nbytes, views, offsets = arena_layout(
        [(_I32, (N, C, L, PMAX)), (_I32, (N * U, 8)),
         (_I32, (1 + N * (K + LMAX),))])
    return (nbytes, views, build.offsets(len(offsets))(
        (ctypes.c_int64 * len(offsets))(*offsets)))


def head_views(head: torch.Tensor, N: int) -> tuple:
    """(order flag (1,), bits_parts (N, K), layer_ends (N, LMAX)): the
    views of ``head``."""
    K = (head.numel() - 1) // N - LMAX if N else 0
    return (head[:1], head[1:1 + N * K].view(N, K),
            head[1 + N * K:].view(N, LMAX))


def _check(off, chunks, nref_step, inj_site, step_end, refpfx, step_base,
           planes, planes_max, nS_ck, nZ_ck, elem, elen, p, flat_step,
           flat_ck, valid, ch_valid, level_chunk_base, level_nchunk,
           n: int, nwords: int) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on anything the kernel does not take.  One pass over
    the tensors: the wrapper's host time is most of the call's."""
    ts = (off, chunks, nref_step, inj_site, step_end, refpfx, step_base,
          planes, planes_max, nS_ck, nZ_ck, elem, elen, p, flat_step,
          flat_ck, valid, ch_valid, level_chunk_base, level_nchunk)
    if (tuple(t.dtype for t in ts) != _IN_TYPES
            or tuple(t.dim() for t in ts) != _IN_DIMS):
        for name, t, dt, nd in zip(_IN_NAMES, ts, _IN_TYPES, _IN_DIMS):
            need(f"emit_tables {name}", t, dt, nd)
    N, T = off.shape
    C, L = step_end.shape[1], step_end.shape[2]
    nchunk = nS_ck.shape[2]
    S, U = C * L * PMAX, C * nchunk * PMAX
    grid, ck = (N, C, L, PMAX), (N, C, nchunk, PMAX)
    if (T < 1 or chunks.shape[0] != N or chunks.shape[1] < 1
            or nref_step.shape != (N, S) or inj_site.shape != (N, S)
            or step_end.shape != grid or refpfx.shape != grid
            or step_base.shape != grid or planes.shape != (N, C)
            or planes_max.shape != (N,) or nS_ck.shape != ck
            or nZ_ck.shape != ck
            or any(t.shape != (N, U) for t in (elem, elen, p, flat_step,
                                                flat_ck, valid))
            or ch_valid.numel() != nchunk or level_chunk_base.numel() != L
            or level_nchunk.numel() != L):
        raise ValueError(
            f"emit_tables: inconsistent shapes: off {tuple(off.shape)}, "
            f"chunks {tuple(chunks.shape)}, steps {tuple(nref_step.shape)}, "
            f"step grid {tuple(step_end.shape)}, chunk tables "
            f"{tuple(nS_ck.shape)}, units {tuple(elem.shape)}, "
            f"{ch_valid.numel()} chunks, {level_nchunk.numel()} levels")
    if not (0 <= n and 0 <= nwords and N * nwords < 2**31
            and N * C * n < 2**31):
        raise ValueError(f"emit_tables: {N} frames of {nwords} words and "
                         f"{C * n} elements pass int32 indices")
    if not cuda_or_cpu("emit_tables", ts):
        return False
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("emit_tables: every table must be contiguous")
    steps_threads(S)
    if N * U >= 2**31:
        raise ValueError(f"emit_tables: {N} frames of {U} units pass int32 "
                         "indices")
    return True


def refstart_plain(off, nref_step, inj_site, step_end, refpfx):
    """Each step's first refinement bit (N, C, L, PMAX): the token offset
    at the step's end, less the injections at sites up to it (an (N, S, S)
    where-sum), plus the step's refinement-bit prefix."""
    N, T = off.shape
    end_idx = step_end.clamp(0, T - 1).reshape(N, -1)
    inj_le_end = torch.where(inj_site[:, None, :] <= end_idx[:, :, None],
                             nref_step[:, None, :], 0).sum(dim=2, dtype=_I32)
    return (off.gather(1, end_idx.long()) - inj_le_end
            + refpfx.reshape(N, -1)).to(_I32).reshape(refpfx.shape)


def bit_partials_plain(chunks, nref_step):
    """int32 partial sums, a row a frame, whose Python-int total is the
    exact stream bit count: the (N, ceil(T / 2048)) token-bit chunk sums
    of kernel 11 over 512-chunk groups, per-step refinement bits over
    8-step groups, every part far below 2^31."""
    def sums(x, m):
        r = (-x.shape[-1]) % m
        if r:
            x = torch.cat([x, x.new_zeros((*x.shape[:-1], r))], dim=-1)
        return x.reshape(*x.shape[:-1], -1, m).sum(dim=-1, dtype=_I32)

    return torch.cat([sums(chunks, PART_CHUNKS),
                      sums(nref_step.to(_I32), PART_STEPS)], dim=-1)


def kernel_b_meta_plain(refstart, planes_max, nS_ck, nZ_ck, elem, elen, p,
                        flat_step, flat_ck, valid, ch_valid, level_bases,
                        level_counts, n: int, nwords: int):
    """(N * U, 8) int32 meta rows of kernel B over the N frames, from the
    steps' first refinement bits ``refstart`` and the unit columns;
    ``level_bases``/``level_counts``: each level's first chunk and chunk
    count (ints); ``n``: a channel's detail elements; ``nwords``: the
    words of one frame, whose buffer starts at f * nwords (col 3)."""
    dev = refstart.device
    fck, fst = flat_ck.long(), flat_step.long()
    N, C = fck.shape[0], nS_ck.shape[1]
    p_ix = torch.arange(PMAX, dtype=_I32, device=dev)
    vc = ch_valid[:, None]
    nR_ck = torch.where(p_ix < planes_max[:, None, None, None],
                        vc - nS_ck - nZ_ck, 0)
    rcar = torch.cat([_excl_cumsum(nR_ck[..., b:b + c, :], dim=-2)
                      for b, c in zip(level_bases, level_counts)],
                     dim=-2).reshape(N, -1)
    u_bit0 = refstart.reshape(N, -1).gather(1, fst) + rcar.gather(1, fck)
    nR_u = nR_ck.reshape(N, -1).gather(1, fck)
    ws = torch.clamp((u_bit0 >> 5) & ~127, 0,
                     (nwords - compact.WREF) // 128 * 128)
    f = torch.arange(N, dtype=_I32, device=dev)[:, None]
    return torch.stack([
        (elem + f * (C * n)) // compact.SUBB, elen, p, ws + f * nwords,
        u_bit0 - 32 * ws,
        torch.zeros_like(nR_u),
        torch.where(valid, nR_u, 0),
        torch.zeros_like(nR_u),
    ], dim=2).to(_I32).reshape(-1, 8)


def layer_ends_plain(off, step_base, planes, planes_max, total_bits):
    """(N, LMAX) int32 bit offset at which each progressive quality layer
    ends (encode.c:183-220; the pre-step is layer 0): where the first token
    of any step of a later layer begins, capped by the (N,) int32
    ``total_bits``."""
    N, C, L = step_base.shape[:3]
    dev = off.device
    pm = planes_max[:, None, None, None]
    c_ix = torch.arange(C, dtype=_I32, device=dev)[:, None, None]
    l_ix = torch.arange(L, dtype=_I32, device=dev)[None, :, None]
    p_ix = torch.arange(PMAX, dtype=_I32, device=dev)[None, None, :]
    layers = torch.where(c_ix == 0, pm - 2 - p_ix + l_ix,
                         pm - 1 - p_ix + l_ix)
    bucket = (torch.clamp(layers, min=-1) + 1).reshape(N, 1, -1)
    valid = (p_ix < planes[:, :, None, None]).expand(
        N, C, L, PMAX).reshape(N, 1, -1)
    start_bits = off.gather(1, step_base.clamp(
        0, off.shape[1] - 1).reshape(N, -1).long())[:, None, :]
    ks = torch.arange(LMAX, dtype=_I32, device=dev)[:, None]
    ends = torch.where((bucket > ks) & valid, start_bits, BIGBIT).amin(dim=2)
    return torch.minimum(ends, total_bits[:, None]).to(_I32)


def emit_tables_plain(off, chunks, nref_step, inj_site, step_end, refpfx,
                      step_base, planes, planes_max, nS_ck, nZ_ck, elem,
                      elen, p, flat_step, flat_ck, valid, ch_valid,
                      level_chunk_base, level_nchunk, n: int,
                      nwords: int) -> tuple:
    """Plain PyTorch version of :func:`emit_tables`."""
    _check(off, chunks, nref_step, inj_site, step_end, refpfx, step_base,
           planes, planes_max, nS_ck, nZ_ck, elem, elen, p, flat_step,
           flat_ck, valid, ch_valid, level_chunk_base, level_nchunk, n,
           nwords)
    N = off.shape[0]
    refstart = refstart_plain(off, nref_step, inj_site, step_end, refpfx)
    bits_parts = bit_partials_plain(chunks, nref_step)
    meta = kernel_b_meta_plain(
        refstart, planes_max, nS_ck, nZ_ck, elem, elen, p, flat_step,
        flat_ck, valid, ch_valid, level_chunk_base.tolist(),
        level_nchunk.tolist(), n, nwords)
    ends = layer_ends_plain(off, step_base, planes, planes_max,
                            bits_parts.sum(dim=1, dtype=_I32))
    head = torch.cat([bits_parts.new_zeros(1), bits_parts.reshape(-1),
                      ends.reshape(-1)])
    _, bits_parts, ends = head_views(head, N)
    return refstart, bits_parts, meta, ends, head


def emit_tables(off, chunks, nref_step, inj_site, step_end, refpfx,
                step_base, planes, planes_max, nS_ck, nZ_ck, elem, elen, p,
                flat_step, flat_ck, valid, ch_valid, level_chunk_base,
                level_nchunk, n: int, nwords: int) -> tuple:
    """Kernel 11's (N, T) ``off`` and (N, NC) ``chunks``; (N, S)
    ``nref_step`` and ``inj_site`` (clamped to [0, T]); stage 1's (N, C,
    L, PMAX) ``step_end``, ``refpfx`` and ``step_base``, (N, C)
    ``planes``, (N,) ``planes_max`` and (N, C, nchunk, PMAX) ``nS_ck`` and
    ``nZ_ck``; kernel 15's (N, U) unit columns ``elem``, ``elen``, ``p``,
    ``flat_step``, ``flat_ck`` (int32) and ``valid`` (bool); the chunks'
    valid counts (nchunk,), the levels' first chunks and chunk counts (L,),
    which partition the chunks in order; a channel's detail elements ``n``
    and a frame's stream words ``nwords`` -> (refstart, bits_parts, meta,
    layer_ends, head), all int32.  On the card two launches (``launches``
    grows by 1); the outputs are views of one new allocation a call."""
    args = (off, chunks, nref_step, inj_site, step_end, refpfx, step_base,
            planes, planes_max, nS_ck, nZ_ck, elem, elen, p, flat_step,
            flat_ck, valid, ch_valid, level_chunk_base, level_nchunk)
    if not _check(*args, n, nwords):
        return emit_tables_plain(*args, n, nwords)
    N, T = off.shape
    C, L = step_end.shape[1], step_end.shape[2]
    NC, nchunk = chunks.shape[1], nS_ck.shape[2]
    K = parts_count(NC, C * L * PMAX)
    nbytes, views, offsets = _layout(N, C, L, nchunk, K)
    refstart, meta, head = carve(nbytes, views, off.device)
    if N:
        build.check(build.library().dwt_emit_tables(
            *(t.data_ptr() for t in args[:19]), N, T, NC, C, L, nchunk, n,
            nwords, (nwords - compact.WREF) // 128 * 128,
            refstart.data_ptr(), offsets, build.stream_of(off)),
            "emit_tables")
        emit_tables.launches += 1
    else:
        head.zero_()
    _, bits_parts, ends = head_views(head, N)
    return refstart, bits_parts, meta, ends, head


emit_tables.launches = 0
