"""Encoder stage 2, emit half: codeword packing, refinement bits and
quality-layer boundaries.

Port of ``dwt_tpu/codec/encoder.py`` ``_codeword_contribs``,
``_pack_bits``, ``_bit_partials``, ``_kernel_b_meta``,
``_ref_bits_pallas`` (here :func:`_ref_bits`), ``_layer_boundaries``,
``_stage2_emit`` and ``_stream_words``.  Every function takes a leading
frame axis (the JAX package's functions under ``jax.vmap``); the codeword
pieces' kernel (kernel 11), the pack kernel and kernel B launch once for
the N frames, whose word buffers lie end to end (frame f's words from
f * nwords).  Stream words and pieces are int32 tensors holding uint32
bit patterns (``torch.uint32`` has no add, shift or scatter).
"""

from __future__ import annotations

import torch

from ..geometry import Pyramid
from ..ops import compact, pack
from ..ops.codeword import codeword_pieces
from ..ops.compact import scatter_refbits
from ..ops.pack import pack_words
from .stage1 import PMAX, _I32, _Segs, segs_for

LMAX = 64  # bound on progressive quality layers (2*max(levels,planes)-1)


def _codeword_contribs(stats, tok_val, tok_raw, tok_vli, orders,
                       padded_T: int, nwords: int):
    """Per-token final-stream bit offsets, word indices and <= 3 word
    pieces, each step's first-refinement-bit position, and the tokens'
    per-2048-slot bit sums: one launch of :func:`codeword_pieces` over the
    (N, padded_T) token arrays, then (N, S) gathers of the step tables.
    ``nwords``: the words of one frame, whose buffer starts at f * nwords
    (``widx`` holds the offset).

    Returns (chunks, nref_step, off, refstart, widx, c0, c1, c2), all
    int32, the pieces as uint32 bit patterns."""
    # Each step's nRef refinement bits land after the step's compact
    # tokens, at its injection site; the one inclusive scan serves every
    # consumer:
    #   off[t] = incl[t] - nbits[t], and
    #   refstart[s] = off[end_s] - (injections at sites <= end_s) + refpfx[s].
    N = tok_val.shape[0]
    nref_step = torch.where(stats["valid"], stats["nRef"], 0).reshape(N, -1)
    inj_site = stats["inj_pos"].reshape(N, -1).clamp(0, padded_T)
    off, widx, c0, c1, c2, chunks = codeword_pieces(
        tok_val, tok_raw, tok_vli, orders, inj_site, nref_step, nwords)
    end_idx = stats["step_end"].clamp(0, padded_T - 1).reshape(N, -1)
    inj_le_end = torch.where(inj_site[:, None, :] <= end_idx[:, :, None],
                             nref_step[:, None, :], 0).sum(dim=2, dtype=_I32)
    refstart = (off.gather(1, end_idx.long()) - inj_le_end
                + stats["refpfx"].reshape(N, -1)).to(_I32).reshape(
                    stats["refpfx"].shape)
    return chunks, nref_step, off, refstart, widx, c0, c1, c2


def _pack_bits(lin, stats, tok_val, tok_raw, tok_vli, orders,
               pyr: Pyramid, channels: int, padded_T: int, nwords: int,
               order_flag=None):
    """Compact-token codewords -> (N, nwords) packed stream words (+
    offsets), through one launch of the pack kernel over the frames' words
    laid end to end (frame f's word indices offset by f * nwords, so they
    stay nondecreasing).  Returns (words, bits_parts, wild, off,
    refstart).  ``order_flag``: passed to :func:`pack_words` (the caller
    checks it).

    ``wild`` is always 0: the JAX package's straggler pass for "wild"
    blocks (encoder.py:956-979) exists only for the TPU kernel's window
    budget, and the CUDA kernel sends pieces past its window to atomics."""
    chunks, nref_step, off, refstart, widx, c0, c1, c2 = _codeword_contribs(
        stats, tok_val, tok_raw, tok_vli, orders, padded_T, nwords)
    N = widx.shape[0]
    words = pack_words(widx.reshape(-1), c0.reshape(-1), c1.reshape(-1),
                       c2.reshape(-1), N * nwords, order_flag=order_flag)
    return (words.reshape(N, nwords), _bit_partials(chunks, nref_step), 0,
            off, refstart)


def _bit_partials(chunks, nref_step):
    """int32 partial sums, a row a frame, whose Python-int total is the
    exact stream bit count: the (N, ceil(padded_T / 2048)) token-bit chunk
    sums of :func:`codeword_pieces` over 512-chunk groups, per-step
    refinement bits over 8-step groups — every part far below 2^31."""
    def sums(x, m):
        r = (-x.shape[-1]) % m
        if r:
            x = torch.cat([x, x.new_zeros((*x.shape[:-1], r))], dim=-1)
        return x.reshape(*x.shape[:-1], -1, m).sum(dim=-1, dtype=_I32)

    return torch.cat([sums(chunks, 512), sums(nref_step.to(_I32), 8)],
                     dim=-1)


def _kernel_b_meta(stats, segs: _Segs, com, refstart, pyr: Pyramid,
                   padded_T: int, nwords: int):
    """(N*U, 8) int32 metadata of kernel B over the N frames.
    ``refstart``: (N, C, L, PMAX) first refinement-bit positions from
    :func:`_codeword_contribs`; ``nwords``: the words of one frame, whose
    buffer starts at f * nwords (col 3)."""
    dev = refstart.device
    fck, fst = com["flat_ck"].long(), com["flat_step"].long()
    N, C = fck.shape[0], stats["planes"].shape[1]
    p_ix = torch.arange(PMAX, dtype=_I32, device=dev)
    vc = segs.ch_valid_t[:, None]
    nR_ck = torch.where(p_ix < stats["planes_max"][:, None, None, None],
                        vc - stats["nS_ck"] - stats["nZ_ck"], 0)
    rcar = segs.level_excl_cumsum(nR_ck).reshape(N, -1)
    u_bit0 = refstart.reshape(N, -1).gather(1, fst) + rcar.gather(1, fck)
    nR_u = nR_ck.reshape(N, -1).gather(1, fck)
    ws = torch.clamp((u_bit0 >> 5) & ~127, 0,
                     (nwords - compact.WREF) // 128 * 128)
    f = torch.arange(N, dtype=_I32, device=dev)[:, None]
    return torch.stack([
        (com["elem"] + f * (C * segs.n)) // compact.SUBB, com["elen"],
        com["p"], ws + f * nwords,
        u_bit0 - 32 * ws,
        torch.zeros_like(nR_u),
        torch.where(com["valid"], nR_u, 0),
        torch.zeros_like(nR_u),
    ], dim=2).to(_I32).reshape(-1, 8)


def _ref_bits(words, refstart, vmag, com, stats, pyr: Pyramid,
              channels: int, padded_T: int):
    """Kernel B, one launch for the N frames: add the refinement bits into
    the (N, nwords) stream words (in place), over kernel A's unit table and
    key histograms (``com``)."""
    segs = segs_for(pyr, words.device)
    meta = _kernel_b_meta(stats, segs, com, refstart, pyr, padded_T,
                          words.shape[1])
    scatter_refbits(vmag, meta, words.view(-1), com["table"], com["hist"])
    return words


def _layer_boundaries(stats, off, total_bits, pyr: Pyramid, channels: int):
    """(N, LMAX) int32 bit offset at which each progressive quality layer
    ends (encode.c:183-220; the pre-step is layer 0): where the first token
    of any step of a later layer begins, capped by the (N,) ``total_bits``."""
    C, L = channels, pyr.levels
    N, dev = off.shape[0], off.device
    pm = stats["planes_max"][:, None, None, None]
    c_ix = torch.arange(C, dtype=_I32, device=dev)[:, None, None]
    l_ix = torch.arange(L, dtype=_I32, device=dev)[None, :, None]
    p_ix = torch.arange(PMAX, dtype=_I32, device=dev)[None, None, :]
    layers = torch.where(c_ix == 0, pm - 2 - p_ix + l_ix,
                         pm - 1 - p_ix + l_ix)
    bucket = (torch.clamp(layers, min=-1) + 1).reshape(N, 1, -1)
    valid = (p_ix < stats["planes"][:, :, None, None]).expand(
        N, C, L, PMAX).reshape(N, 1, -1)
    BIGBIT = 2**31 - 1
    start_bits = off.gather(1, stats["step_base"].clamp(
        0, off.shape[1] - 1).reshape(N, -1).long())[:, None, :]
    ks = torch.arange(LMAX, dtype=_I32, device=dev)[:, None]
    ends = torch.where((bucket > ks) & valid, start_bits, BIGBIT).amin(dim=2)
    return torch.minimum(ends, total_bits[:, None]).to(_I32)


def _stream_words(pyr: Pyramid, channels: int, padded_T: int) -> int:
    """Static word-buffer size: worst-case compact-token bits (64/token) +
    worst-case refinement bits (PMAX per detail coefficient), plus the JAX
    package's pack-window slack and one spare slot (kept equal to it)."""
    n_det = (pyr.total - pyr.pixels[0]) * channels
    return (2 * padded_T + (n_det * PMAX) // 32
            + pack._win() + pack._win1() + 520)


def _stage2_emit(lin, stats, tv, tr, tf, orders, vmag, com, pyr: Pyramid,
                 channels: int, padded_T: int, order_flag=None):
    """Stage-2 second half over N frames: codeword packing + refinement
    bits + layer boundaries.  ``vmag`` and ``com`` are kernel A's packed
    elements and unit indexing (from :func:`tokens._stage2_tokens`);
    ``order_flag`` as in :func:`_pack_bits`.  Returns ((N, nwords) words,
    (N, K) bits_parts, wild, (N, LMAX) layer_ends)."""
    C = channels
    nwords = _stream_words(pyr, C, padded_T)
    words, bits_parts, wild, off, refstart = _pack_bits(
        lin, stats, tv, tr, tf, orders, pyr, C, padded_T, nwords,
        order_flag)
    words = _ref_bits(words, refstart, vmag, com, stats, pyr, C, padded_T)
    # int32 device totals: exact for valid (< 2^31-bit) streams; the host
    # checks the Python-int total of bits_parts before trusting the ends.
    tot32 = bits_parts.sum(dim=1, dtype=_I32)
    layer_ends = _layer_boundaries(stats, off, tot32, pyr, C)
    return words, bits_parts, wild, layer_ends
