"""Encoder stage 2, tokens half: significance tokens, the dense token
finisher and the adaptive-VLI order scan.

Port of ``dwt_tpu/codec/encoder.py`` ``_packed_elems``,
``_unit_common`` and ``_kernel_a_meta`` (here :func:`_unit_tables`),
``_sig_tokens_pallas`` (here :func:`_sig_tokens`, always through kernel
A), ``_finish_tokens``, ``_vli_ab``, ``_vli_orders`` and
``_stage2_tokens``.  Every function takes a leading frame axis (N frames
of one geometry at one token bucket: the JAX package's functions under
``jax.vmap``); the kernels launch once for the N frames, over their
arrays laid end to end.  On the card kernel A's unit tables (kernel 15),
the packed elements (kernel 13), kernel A, the token finisher (kernel 12)
and the VLI order scan are one call each; the token arrays come back
contiguous, rows at stride padded_T.
"""

from __future__ import annotations

import torch

from ..geometry import Pyramid
from ..ops import compact, units
from ..ops.compact import compact_tokens
from ..ops.finish import finish_tokens, packed_elems
# Not called on the encode path since the VLI order scan reads the token
# arrays in place; the benchmark wraps ``tokens.transpose2d`` by this name.
from ..ops.transpose import transpose2d  # noqa: F401
from ..ops.units import unit_tables
from ..ops.vli_scan import vli_orders
from .stage1 import _Segs, _ilog2, segs_for

_I32 = torch.int32

# Tokens a block of the VLI order scan's plain version
# (``ops/vli_scan.py:vli_orders_plain``); any power of two that divides the
# token bucket gives the same orders.
VLI_BLOCK = 128


def _packed_elems(lin, segs: _Segs):
    """((N*C*n + E) / SUBA, SUBA) int32 rows for the compaction kernels,
    frame after frame: bits 0-29 |coeff|, bit 30 sign, -1 = padding.  One
    call of :func:`packed_elems` (kernel 13 on the card)."""
    return packed_elems(lin, segs.valid_t)


def _unit_tables(stats, segs: _Segs, padded_T: int) -> tuple:
    """Per-unit (schedule step x E-element chunk) tables of the N frames,
    in each frame's stream order: one call of :func:`unit_tables` (kernel
    15 on the card).  Returns (unit indexing: the (N, U) columns of
    ``units.COM_KEYS`` that both compaction kernels read, U = C * PMAX *
    nchunk, each frame's own, and kernel A's (N * C * nchunk, PMAX) unit
    table as "table"; kernel A's (N*U, 8) int32 meta rows, frame f's rows
    reading its elements past the earlier frames' N*C*n and writing pairs
    f * pairbuf onwards; the pair buffer of one frame, pairbuf)."""
    out = unit_tables(
        stats["order"], stats["ubase_sched"], stats["valid_sched"],
        stats["step_base"], stats["nS_ck"], stats["scar_ck"],
        stats["zcar_ck"], segs.level_chunk_base_t, segs.ch_start_t,
        segs.ch_len_t, segs.n, padded_T)
    com = dict(zip(units.OUT_KEYS, out))
    return com, com.pop("meta"), units.pair_buffer(padded_T)


def _sig_tokens(lin, stats, pyr: Pyramid, channels: int, padded_T: int):
    """Kernel A, one launch pair for the N frames: each newly significant
    element's ``(zero-prefix << 1) | sign`` at its PAIR rank (step bases
    are even, so pair rank = token slot / 2).  Returns ((N, padded_T / 2)
    pairs, a view of kernel A's pair buffer at row stride pairbuf; packed
    elements; unit indexing); the unit indexing also holds kernel A's unit
    table ("table") and the key histograms of its count launch ("hist"),
    which kernel B reuses: B's meta rows come in the same order, and every
    group live for B has a live A unit (ops/compact.py:scatter_refbits).
    ``ops/finish.py:_split_pairs`` splits the pairs into zero-prefixes
    and signs."""
    del channels  # the stats' shapes
    N = lin.shape[0]
    segs = segs_for(pyr, lin.device)
    com, meta, pairbuf = _unit_tables(stats, segs, padded_T)
    vmag = _packed_elems(lin, segs)
    com["hist"] = compact.hist_for(com["table"])
    pairs = compact_tokens(vmag, meta, N * pairbuf, com["table"],
                           com["hist"]).reshape(N, pairbuf)[:, : padded_T // 2]
    return pairs, vmag, com


def _finish_tokens(pairs, lin, stats, pyr: Pyramid, channels: int,
                   padded_T: int):
    """Dense completion of the (N, padded_T) token arrays (values, raw bit
    counts, VLI flags) from kernel A's (N, padded_T / 2) pairs: one call of
    :func:`finish_tokens` (kernel 12 on the card) on the pairs and the root
    band as they lie and the schedule's step tables.  Returns contiguous
    arrays, rows at stride padded_T."""
    del channels, padded_T  # the pairs' and the root band's shapes
    return finish_tokens(
        pairs, lin[:, :, :pyr.pixels[0]], stats["base_sched"],
        stats["nS_sched"], stats["cin_sched"], stats["valid_sched"],
        stats["root_cnt"], stats["root_base"], stats["planes_base"],
        stats["planes"], stats["refrun_ok"], stats["step_base"], stats["nS"],
        stats["refrun_val"], stats["T"], stats["carry_end"])


def _vli_ab(tok_val, tok_vli):
    """Per-token transition parameters, +1-biased (0 = non-VLI no-op):
    ns = clamp(ilog2(v + 2^s) - 2) and ilog2(v + 2^s) = max(s, A +
    (s >= B)) with A = ilog2(v) and B = ceil_log2(2^(A+1) - v)."""
    A = torch.clamp(_ilog2(tok_val.clamp(min=1)), min=0)
    rem = (2 << A) - tok_val
    Bt = torch.where(rem <= 1, 0, _ilog2((rem - 1).clamp(min=1)) + 1)
    return torch.where(tok_vli, (A | (Bt << 5)) + 1, 0)


def _vli_orders(tok_val, tok_vli, padded_T: int):
    """Exact adaptive-VLI order state (vli.h:67-84) at every token of
    (N, padded_T) token arrays: :func:`vli_orders`, one launch of
    ``csrc/vli_scan.cu`` on the card over the arrays as they lie (each
    token's :func:`_vli_ab` parameters computed in the kernel, no
    transpose), whatever N and padded_T are; its plain version on the
    CPU.  The order is a chain over NSTATE values through every VLI token
    of a frame, from order 0; no order carries across frames.  ``padded_T``
    is the arrays' width (the JAX package's signature)."""
    return vli_orders(tok_val, tok_vli)


def _stage2_tokens(lin, stats, pyr: Pyramid, channels: int, padded_T: int):
    """Stage-2 first half over N frames: token build + VLI order scan.
    Returns ((N, padded_T) tv, tr, tf, orders, vmag, com): the packed
    elements and unit indexing of kernel A, which kernel B reuses in
    :func:`emit._stage2_emit`."""
    pairs, vmag, com = _sig_tokens(lin, stats, pyr, channels, padded_T)
    tv, tr, tf = _finish_tokens(pairs, lin, stats, pyr, channels, padded_T)
    return tv, tr, tf, _vli_orders(tv, tf, padded_T), vmag, com
