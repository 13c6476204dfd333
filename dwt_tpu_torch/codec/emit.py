"""Encoder stage 2, emit half: codeword packing, refinement bits and
quality-layer boundaries.

Port of ``dwt_tpu/codec/encoder.py`` ``_codeword_contribs``,
``_pack_bits``, ``_bit_partials``, ``_kernel_b_meta``,
``_ref_bits_pallas``, ``_layer_boundaries``, ``_stage2_emit`` and
``_stream_words``.  Every function takes a leading frame axis (the JAX
package's functions under ``jax.vmap``); the codeword pieces' kernel
(kernel 11), the step tables' kernel (kernel 17: each step's first
refinement bit, the bit partials, kernel B's meta and the layer ends),
the pack kernel and kernel B launch once for the N frames, whose word
buffers lie end to end (frame f's words from f * nwords).  Stream words
and pieces are int32 tensors holding uint32 bit patterns
(``torch.uint32`` has no add, shift or scatter).
"""

from __future__ import annotations

import torch

from ..geometry import Pyramid
from ..ops import pack
from ..ops.codeword import codeword_pieces
from ..ops.compact import scatter_refbits
# LMAX is the encoder's too (codec/tiled.py and the tests read it here).
from ..ops.emit_tables import (LMAX, bit_partials_plain,  # noqa: F401
                               emit_tables, kernel_b_meta_plain,
                               layer_ends_plain)
from ..ops.pack import pack_words
from ..ops.units import COM_KEYS
from .stage1 import PMAX, _Segs, segs_for


def _codeword_contribs(stats, tok_val, tok_raw, tok_vli, orders,
                       padded_T: int, nwords: int):
    """Per-token final-stream bit offsets, word indices and <= 3 word
    pieces, and the tokens' per-2048-slot bit sums: one launch of
    :func:`codeword_pieces` over the (N, padded_T) token arrays, after the
    (N, S) steps' refinement-bit counts and injection sites it reads.
    ``nwords``: the words of one frame, whose buffer starts at f * nwords
    (``widx`` holds the offset).

    Returns (chunks, nref_step, inj_site, off, widx, c0, c1, c2), all
    int32, the pieces as uint32 bit patterns."""
    # Each step's nRef refinement bits land after the step's compact
    # tokens, at its injection site; the one inclusive scan serves every
    # consumer: off[t] = incl[t] - nbits[t], and the step tables' first
    # refinement bits (:func:`_step_tables`).
    N = tok_val.shape[0]
    nref_step = torch.where(stats["valid"], stats["nRef"], 0).reshape(N, -1)
    inj_site = stats["inj_pos"].reshape(N, -1).clamp(0, padded_T)
    off, widx, c0, c1, c2, chunks = codeword_pieces(
        tok_val, tok_raw, tok_vli, orders, inj_site, nref_step, nwords)
    return chunks, nref_step, inj_site, off, widx, c0, c1, c2


def _step_tables(stats, com, pyr: Pyramid, off, chunks, nref_step,
                 inj_site, nwords: int):
    """One call of :func:`emit_tables` (kernel 17) on kernel 11's outputs,
    stage 1's stats (the schedule order and the chunk tables' level scans
    among them) and kernel A's unit columns ``com``: (refstart (N, C,
    L, PMAX), bits_parts (N, K), kernel B's (N * U, 8) meta, layer_ends
    (N, LMAX), head), head holding the pack kernel's order flag (0) and
    then bits_parts and layer_ends."""
    segs = segs_for(pyr, off.device)
    return emit_tables(
        off, chunks, nref_step, inj_site, stats["order"], stats["step_end"],
        stats["refpfx"], stats["step_base"], stats["planes"],
        stats["planes_max"], stats["nS_ck"], stats["nZ_ck"],
        stats["scar_ck"], stats["zcar_ck"], *(com[k] for k in COM_KEYS),
        segs.ch_valid_t, segs.vcar_t, segs.level_chunk_base_t,
        segs.level_nchunk_t, segs.n, nwords)


def _pack_bits(stats, tok_val, tok_raw, tok_vli, orders, com, pyr: Pyramid,
               padded_T: int, nwords: int):
    """Compact-token codewords -> (N, nwords) packed stream words: kernel
    11, the step tables (kernel 17) and one launch of the pack kernel over
    the frames' words laid end to end (frame f's word indices offset by f
    * nwords, so they stay nondecreasing), its order flag left in the step
    tables' head for the caller to check.  Returns (words, the step tables
    of :func:`_step_tables`)."""
    chunks, nref_step, inj_site, off, widx, c0, c1, c2 = _codeword_contribs(
        stats, tok_val, tok_raw, tok_vli, orders, padded_T, nwords)
    tables = _step_tables(stats, com, pyr, off, chunks, nref_step, inj_site,
                          nwords)
    N = widx.shape[0]
    words = pack_words(widx.reshape(-1), c0.reshape(-1), c1.reshape(-1),
                       c2.reshape(-1), N * nwords, order_flag=tables[4][:1])
    return words.reshape(N, nwords), tables


def _bit_partials(chunks, nref_step):
    """int32 partial sums, a row a frame, whose Python-int total is the
    exact stream bit count (the plain version of kernel 17's
    ``bits_parts``)."""
    return bit_partials_plain(chunks, nref_step)


def _kernel_b_meta(stats, segs: _Segs, com, refstart, pyr: Pyramid,
                   padded_T: int, nwords: int):
    """(N*U, 8) int32 metadata of kernel B over the N frames (the plain
    version of kernel 17's meta).  ``refstart``: (N, C, L, PMAX) first
    refinement-bit positions; ``nwords``: the words of one frame, whose
    buffer starts at f * nwords (col 3)."""
    return kernel_b_meta_plain(
        refstart, stats["planes_max"], stats["nS_ck"], stats["nZ_ck"],
        *(com[k] for k in COM_KEYS), segs.ch_valid_t, segs.level_chunk_base,
        segs.level_nchunk, segs.n, nwords)


def _layer_boundaries(stats, off, total_bits, pyr: Pyramid, channels: int):
    """(N, LMAX) int32 bit offset at which each progressive quality layer
    ends, capped by the (N,) ``total_bits`` (the plain version of kernel
    17's layer ends)."""
    return layer_ends_plain(off, stats["step_base"], stats["planes"],
                            stats["planes_max"], total_bits)


def _stream_words(pyr: Pyramid, channels: int, padded_T: int) -> int:
    """Static word-buffer size: worst-case compact-token bits (64/token) +
    worst-case refinement bits (PMAX per detail coefficient), plus the JAX
    package's pack-window slack and one spare slot (kept equal to it)."""
    n_det = (pyr.total - pyr.pixels[0]) * channels
    return (2 * padded_T + (n_det * PMAX) // 32
            + pack._win() + pack._win1() + 520)


def _stage2_emit(lin, stats, tv, tr, tf, orders, vmag, com, pyr: Pyramid,
                 channels: int, padded_T: int):
    """Stage-2 second half over N frames: codeword packing + refinement
    bits + layer boundaries: kernel 11, kernel 17, the pack kernel and
    kernel B (in place on the packed words).  ``vmag`` and ``com`` are
    kernel A's packed elements and unit indexing (from
    :func:`tokens._stage2_tokens`).  Returns ((N, nwords) words, (N, K)
    bits_parts, wild (0), (N, LMAX) layer_ends, head): bits_parts and
    layer_ends are views of head, after the pack kernel's order flag, for
    the caller to copy to the host in one copy and check (the int32 layer
    ends are exact for valid (< 2^31-bit) streams; the host checks the
    Python-int total of bits_parts before trusting them).

    ``wild`` is always 0: the JAX package's straggler pass for "wild"
    blocks (encoder.py:956-979) exists only for the TPU kernel's window
    budget, and the CUDA kernel sends pieces past its window to atomics."""
    nwords = _stream_words(pyr, channels, padded_T)
    words, (_, bits_parts, meta, layer_ends, head) = _pack_bits(
        stats, tv, tr, tf, orders, com, pyr, padded_T, nwords)
    scatter_refbits(vmag, meta, words.view(-1), com["table"], com["hist"])
    return words, bits_parts, 0, layer_ends, head
