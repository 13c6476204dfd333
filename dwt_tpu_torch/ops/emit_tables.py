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

On the card one launch (``launches`` grows by 1; :func:`launch_plan`):
each frame's steps gathered in schedule order through kernel 14's
``order`` (sorted in shared memory only where that order is not a
permutation or leaves its injection sites out of order, which no encode
path makes) and scanned, every block of a frame recomputing the step
tables: small frames several a block, a larger frame's first block
writing its step tables and the others its meta rows, whose level
prefixes come in closed form from kernel 14's level scans (``scar_ck``,
``zcar_ck``) and the pyramid's ``vcar``.  Its outputs are views of one
int32 allocation (:func:`_layout`, :func:`_carve`).  On the CPU:
:func:`emit_tables_plain`, the eager passes the encoder ran before, which
ignores ``order``, ``scar_ck``, ``zcar_ck`` and ``vcar``.
"""

from __future__ import annotations

import ctypes
import functools
from operator import attrgetter

import torch

from ..runtime import build
from . import compact
from ._launch import arena_layout, cuda_or_cpu, need
from .plane_stats import PMAX, _excl_cumsum
from .schedule import MAX_STEPS

_I32 = torch.int32
LMAX = 64  # bound on progressive quality layers (2*max(levels,planes)-1)
BIGBIT = 2**31 - 1
PART_CHUNKS = 512  # kernel 11's chunk sums a token part of bits_parts
PART_STEPS = 8     # steps a refinement part
# The launch (csrc/emit_tables.cu): threads a block, keys a thread of a
# frame's sort and scan at most, units a thread of a small frame's group
# at most, and units a thread of a larger frame's blocks (1, 2 and 8 were
# no faster at 4K: PERF.md, section 6).
BLOCK = 256
MAX_RUN = 8
MAX_UPT = 8
UPT = 4
# Threads a frame's group at most where several frames share a block.
SMALL = 64
# The inputs: names, dtypes, dimensions.
_IN_NAMES = ("off", "chunks", "nref_step", "inj_site", "order", "step_end",
             "refpfx", "step_base", "planes", "planes_max", "nS_ck", "nZ_ck",
             "scar_ck", "zcar_ck", "elem", "elen", "p", "flat_step",
             "flat_ck", "valid", "ch_valid", "vcar", "level_chunk_base",
             "level_nchunk")
_IN_TYPES = (_I32,) * 19 + (torch.bool,) + (_I32,) * 4
_IN_DIMS = (2, 2, 2, 2, 2, 4, 4, 4, 2, 1, 4, 4, 4, 4, 2, 2, 2, 2, 2, 2, 1,
            1, 1, 1)
# The tensors the kernel reads (it takes the levels from vcar).
_KERNEL_IN = 22
_SHAPE, _DTYPE = attrgetter("shape"), attrgetter("dtype")


def parts_count(nchunks: int, S: int) -> int:
    """K, the columns of ``bits_parts``."""
    return -(-nchunks // PART_CHUNKS) + -(-S // PART_STEPS)


def launch_plan(S: int, U: int) -> tuple:
    """The kernel's launch at ``S`` steps and ``U`` units a frame: (np,
    the keys a frame, a power of two of at least 64 that holds S; tf, the
    threads a frame's group; fpb, the frames a block; bpf, the blocks a
    frame; ub, the units of a frame a block writes).  A frame of at most
    256 keys whose units fit a group of np / 4 threads (and at least a
    warp), 8 a thread, is one group of a block of 256 threads' frames
    (16x16 RGB tiles: 4 frames a block, 2 warps a frame).  A larger one
    takes a block of 256 threads for its step tables and as many more as
    hold its units at ``UPT`` a thread, each recomputing the step tables
    in its shared memory."""
    if S > MAX_STEPS:
        raise ValueError(f"emit_tables: {S} steps a frame, past the "
                         f"kernel's {MAX_STEPS}")
    np_ = max(64, 1 << (S - 1).bit_length())
    tf = max(32, np_ // 4)
    if tf <= SMALL and U <= tf * MAX_UPT:
        return np_, tf, BLOCK // tf, 1, U
    blocks = -(-U // (BLOCK * UPT))
    return np_, BLOCK, 1, 1 + blocks, -(-U // blocks)


def _head_parts(N: int, K: int) -> tuple:
    """The head's format: the (shape, strides, offset in the head) of the
    order flag, ``bits_parts`` and ``layer_ends``, end to end."""
    return (((1,), (1,), 0), ((N, K), (K, 1), 1),
            ((N, LMAX), (LMAX, 1), 1 + N * K))


@functools.lru_cache(maxsize=64)
def _layout(N: int, C: int, L: int, nchunk: int, K: int) -> tuple:
    """The kernel's one allocation at a shape: (its int32 words, the
    (shape, strides, offset) of refstart, meta, head, bits_parts and
    layer_ends in it, the offsets struct the C entry point takes, the
    launch plan struct)."""
    U = C * nchunk * PMAX
    nbytes, views, offsets = arena_layout(
        [(_I32, (N, C, L, PMAX)), (_I32, (N * U, 8)),
         (_I32, (1 + N * (K + LMAX),))])
    head = views[2][3]
    views = tuple(v[1:] for v in views) + tuple(
        (shape, strides, head + at)
        for shape, strides, at in _head_parts(N, K)[1:])
    return (nbytes // 4, views, build.offsets(len(offsets))(
        (ctypes.c_int64 * len(offsets))(*offsets)),
        build.EmitPlan(*launch_plan(C * L * PMAX, U)))


def _carve(words: int, views: tuple, device) -> list:
    """One new int32 allocation of ``words`` on ``device`` and
    (refstart, meta, head, bits_parts, layer_ends) as views of it."""
    arena = torch.empty(words, dtype=_I32, device=device)
    return [arena.as_strided(*v) for v in views]


def head_views(head: torch.Tensor, N: int) -> tuple:
    """(order flag (1,), bits_parts (N, K), layer_ends (N, LMAX)): the
    views of ``head``."""
    K = (head.numel() - 1) // N - LMAX if N else 0
    at = head.storage_offset()
    return tuple(head.as_strided(shape, strides, at + off)
                 for shape, strides, off in _head_parts(N, K))


@functools.lru_cache(maxsize=64)
def _shapes(N: int, T: int, NC: int, C: int, L: int, nchunk: int) -> tuple:
    """The shape of each of the 24 tensors at a call's sizes."""
    S, U = C * L * PMAX, C * nchunk * PMAX
    grid, ck = (N, C, L, PMAX), (N, C, nchunk, PMAX)
    return tuple(map(torch.Size, (
        (N, T), (N, NC), (N, S), (N, S), (N, S), grid, grid, grid, (N, C),
        (N,), ck, ck, ck, ck, *((N, U),) * 6, (nchunk,), (nchunk,), (L,),
        (L,))))


def _check(*ts, n: int, nwords: int) -> bool:
    """True when every tensor of ``ts`` (the 24 of :func:`emit_tables`)
    lies on one CUDA device, False when all lie on the CPU; raises on
    anything the kernel does not take.  One pass over the tensors' dtypes
    and one over their shapes, held to the shapes that the sizes of
    ``off``, ``chunks``, ``step_end`` and ``nS_ck`` give (the wrapper's
    host time is most of the call's); each name checked where either
    differs."""
    shapes = tuple(map(_SHAPE, ts))
    try:
        (N, T), NC = shapes[0], shapes[1][-1]
        C, L, nchunk = shapes[5][1], shapes[5][2], shapes[10][2]
        ok = shapes == _shapes(N, T, NC, C, L, nchunk)
    except (ValueError, IndexError):
        ok = False
    if not ok or tuple(map(_DTYPE, ts)) != _IN_TYPES:
        _explain(ts)
    S, U = C * L * PMAX, C * nchunk * PMAX
    if T < 1 or NC < 1:
        raise ValueError(f"emit_tables: {T} token slots and {NC} chunk "
                         "sums a frame")
    if not (0 <= n and 0 <= nwords and N * nwords < 2**31
            and N * C * n < 2**31):
        raise ValueError(f"emit_tables: {N} frames of {nwords} words and "
                         f"{C * n} elements pass int32 indices")
    if not cuda_or_cpu("emit_tables", ts):
        return False
    if not all(map(torch.Tensor.is_contiguous, ts)):
        raise ValueError("emit_tables: every table must be contiguous")
    if S > MAX_STEPS:
        raise ValueError(f"emit_tables: {S} steps a frame, past the "
                         f"kernel's {MAX_STEPS}")
    if N * U >= 2**31:
        raise ValueError(f"emit_tables: {N} frames of {U} units pass int32 "
                         "indices")
    return True


def _explain(ts) -> None:
    """Raise on the first of ``ts`` whose dtype or dimensions are not the
    kernel's, else on their inconsistent shapes."""
    for name, t, dt, nd in zip(_IN_NAMES, ts, _IN_TYPES, _IN_DIMS):
        need(f"emit_tables {name}", t, dt, nd)
    shape = dict(zip(_IN_NAMES, (tuple(t.shape) for t in ts)))
    raise ValueError(
        f"emit_tables: inconsistent shapes: off {shape['off']}, chunks "
        f"{shape['chunks']}, steps {shape['nref_step']}, order "
        f"{shape['order']}, step grid {shape['step_end']}, chunk tables "
        f"{shape['nS_ck']}, units {shape['elem']}, {shape['ch_valid']} "
        f"chunks, {shape['vcar']} level scans, {shape['level_nchunk']} "
        "levels")


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


def emit_tables_plain(off, chunks, nref_step, inj_site, order, step_end,
                      refpfx, step_base, planes, planes_max, nS_ck, nZ_ck,
                      scar_ck, zcar_ck, elem, elen, p, flat_step, flat_ck,
                      valid, ch_valid, vcar, level_chunk_base, level_nchunk,
                      n: int, nwords: int) -> tuple:
    """Plain PyTorch version of :func:`emit_tables`; ``order``,
    ``scar_ck``, ``zcar_ck`` and ``vcar`` are checked and not read."""
    _check(off, chunks, nref_step, inj_site, order, step_end, refpfx,
           step_base, planes, planes_max, nS_ck, nZ_ck, scar_ck, zcar_ck,
           elem, elen, p, flat_step, flat_ck, valid, ch_valid, vcar,
           level_chunk_base, level_nchunk, n=n, nwords=nwords)
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


def emit_tables(off, chunks, nref_step, inj_site, order, step_end, refpfx,
                step_base, planes, planes_max, nS_ck, nZ_ck, scar_ck,
                zcar_ck, elem, elen, p, flat_step, flat_ck, valid, ch_valid,
                vcar, level_chunk_base, level_nchunk, n: int,
                nwords: int) -> tuple:
    """Kernel 11's (N, T) ``off`` and (N, NC) ``chunks``; (N, S)
    ``nref_step`` and ``inj_site`` (clamped to [0, T]); stage 1's (N, S)
    ``order`` (each schedule position's step), (N, C, L, PMAX)
    ``step_end``, ``refpfx`` and ``step_base``, (N, C) ``planes``, (N,)
    ``planes_max`` and (N, C, nchunk, PMAX) ``nS_ck``, ``nZ_ck`` and their
    level-exclusive scans over the chunks ``scar_ck`` and ``zcar_ck``;
    kernel 15's (N, U) unit columns ``elem``, ``elen``, ``p``,
    ``flat_step``, ``flat_ck`` (int32) and ``valid`` (bool); the chunks'
    valid counts and their level-exclusive scan ``vcar`` (nchunk,), the
    levels' first chunks and chunk counts (L,), which partition the chunks
    in order; a channel's detail elements ``n`` and a frame's stream words
    ``nwords`` -> (refstart, bits_parts, meta, layer_ends, head), all
    int32.  On the card one launch (``launches`` grows by 1), which equals
    the plain version where ``scar_ck``, ``zcar_ck`` and ``vcar`` are the
    scans they are said to be (kernel 14's and ``_Segs``'); the outputs
    are views of one new allocation a call."""
    args = (off, chunks, nref_step, inj_site, order, step_end, refpfx,
            step_base, planes, planes_max, nS_ck, nZ_ck, scar_ck, zcar_ck,
            elem, elen, p, flat_step, flat_ck, valid, ch_valid, vcar,
            level_chunk_base, level_nchunk)
    if not _check(*args, n=n, nwords=nwords):
        return emit_tables_plain(*args, n, nwords)
    N, T = off.shape
    C, L = step_end.shape[1], step_end.shape[2]
    NC, nchunk = chunks.shape[1], nS_ck.shape[2]
    K = parts_count(NC, C * L * PMAX)
    words, views, offsets, plan = _layout(N, C, L, nchunk, K)
    refstart, meta, head, bits_parts, ends = _carve(words, views, off.device)
    if N:
        build.check(build.library().dwt_emit_tables(
            *map(torch.Tensor.data_ptr, args[:_KERNEL_IN]), N, T, NC, C, L,
            nchunk, n, nwords, (nwords - compact.WREF) // 128 * 128,
            refstart.data_ptr(), offsets, plan, build.stream_of(off)),
            "emit_tables")
        emit_tables.launches += 1
    else:
        head.zero_()
    return refstart, bits_parts, meta, ends, head


emit_tables.launches = 0
