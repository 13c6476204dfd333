"""Encoder stage 2, emit half: codeword packing, refinement bits and
quality-layer boundaries.

Port of ``dwt_tpu/codec/encoder.py`` ``_codeword_contribs``,
``_pack_bits``, ``_bit_partials``, ``_kernel_b_meta``,
``_ref_bits_pallas`` (here :func:`_ref_bits`), ``_layer_boundaries``,
``_stage2_emit`` and ``_stream_words``.  Stream words are int32 tensors
holding uint32 bit patterns (``torch.uint32`` has no add, shift or
scatter); codeword arithmetic runs in int64 on values below 2^32.
"""

from __future__ import annotations

import torch

from ..geometry import Pyramid
from ..ops import compact, pack
from ..ops.compact import scatter_refbits
from ..ops.pack import pack_words
from .stage1 import PMAX, _I32, _Segs, _ilog2, segs_for

LMAX = 64  # bound on progressive quality layers (2*max(levels,planes)-1)
_M32 = 0xFFFFFFFF


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(_I32)


def _vli_k(v, s):
    """Prefix zeros put_vli emits for value v at order s (vli.h:73-78):
    k = max(0, ilog2(v + 2^s) - s)."""
    return torch.clamp(_ilog2(v + (torch.ones_like(s) << s)) - s, min=0)


def _codeword_contribs(stats, tok_val, tok_raw, tok_vli, orders,
                       padded_T: int):
    """Per-token codeword bit lengths, final-stream offsets, the <= 3
    uint32 word pieces and each step's first-refinement-bit position.

    Returns (nbits, nref_step, off, refstart, widx, c0, c1, c2); the
    pieces are int64 values below 2^32."""
    s = orders
    k = torch.where(tok_vli, _vli_k(tok_val, s), 0)
    nbits = torch.where(tok_vli, 2 * k + s + 1, tok_raw)
    # A VLI codeword is k prefix zeros, a 1, then s + k payload bits:
    # 2k + s + 1 <= 61 bits with s + k <= 30, split into (lo, hi) words.
    s64, k64 = s.long(), k.long()
    one = torch.ones_like(s64)
    payload = tok_val.long() - ((one << (s64 + k64)) - (one << s64))
    lo_vli = ((one << k64) | (payload << (k64 + 1))) & _M32
    hi_vli = (payload & _M32) >> (31 - k64)
    lo = torch.where(tok_vli, lo_vli, tok_val.long() & _M32)
    hi = torch.where(tok_vli, hi_vli, 0)

    # int32 bit offsets (single streams stay below 2^31 bits).  Each
    # step's nRef refinement bits land after the step's compact tokens, at
    # its injection site; one inclusive cumsum serves every consumer:
    #   off[t] = incl[t] - nbits[t], and
    #   refstart[s] = off[end_s] - (injections at sites <= end_s) + refpfx[s].
    nref_step = torch.where(stats["valid"], stats["nRef"], 0).reshape(-1)
    inj_site = stats["inj_pos"].reshape(-1).clamp(0, padded_T)
    inject = torch.zeros(padded_T + 1, dtype=_I32, device=tok_val.device
                         ).index_add_(0, inj_site.long(), nref_step)[:padded_T]
    incl = torch.cumsum(nbits + inject, dim=0).to(_I32)
    off = incl - nbits
    end_idx = stats["step_end"].clamp(0, padded_T - 1).reshape(-1)
    inj_le_end = torch.where(inj_site[None, :] <= end_idx[:, None],
                             nref_step[None, :], 0).sum(dim=1, dtype=_I32)
    refstart = (off[end_idx.long()] - inj_le_end
                + stats["refpfx"].reshape(-1)).to(_I32).reshape(
                    stats["refpfx"].shape)

    widx = off >> 5
    sh = (off & 31).long()
    shc = 31 - sh  # >> (32 - sh) as >> 1 >> (31 - sh): valid for sh == 0
    c0 = (lo << sh) & _M32
    c1 = (((lo >> 1) >> shc) | (hi << sh)) & _M32
    c2 = (hi >> 1) >> shc
    return nbits, nref_step, off, refstart, widx, c0, c1, c2


def _pack_bits(lin, stats, tok_val, tok_raw, tok_vli, orders,
               pyr: Pyramid, channels: int, padded_T: int, nwords: int):
    """Compact-token codewords -> packed stream words (+ offsets), through
    the pack kernel.  Returns (words, bits_parts, wild, off, refstart).

    ``wild`` is always 0: the JAX package's straggler pass for "wild"
    blocks (encoder.py:956-979) exists only for the TPU kernel's window
    budget, and the CUDA kernel has no windows."""
    nbits, nref_step, off, refstart, widx, c0, c1, c2 = _codeword_contribs(
        stats, tok_val, tok_raw, tok_vli, orders, padded_T)
    words = pack_words(widx.contiguous(), _as_i32(c0), _as_i32(c1),
                            _as_i32(c2), nwords)
    return words, _bit_partials(nbits, nref_step), 0, off, refstart


def _bit_partials(nbits, nref_step):
    """int32 partial sums whose Python-int total is the exact stream bit
    count: tokens over 2048-token chunks then 512-chunk groups, per-step
    refinement bits over 8-step groups — every part far below 2^31."""
    def sums(x, m):
        r = (-x.shape[0]) % m
        if r:
            x = torch.cat([x, torch.zeros(r, dtype=x.dtype, device=x.device)])
        return x.reshape(-1, m).sum(dim=1, dtype=_I32)

    return torch.cat([sums(sums(nbits, 2048), 512),
                      sums(nref_step.to(_I32), 8)])


def _kernel_b_meta(stats, segs: _Segs, com, refstart, pyr: Pyramid,
                   padded_T: int, nwords: int):
    """(U, 8) int32 metadata of kernel B.  ``refstart``: (C, L, PMAX) first
    refinement-bit positions from :func:`_codeword_contribs`."""
    dev = refstart.device
    fck, fst = com["flat_ck"].long(), com["flat_step"].long()
    p_ix = torch.arange(PMAX, dtype=_I32, device=dev)[None, None, :]
    vc = torch.as_tensor(segs.ch_valid, dtype=_I32, device=dev)[None, :, None]
    nR_ck = torch.where(p_ix < stats["planes_max"],
                        vc - stats["nS_ck"] - stats["nZ_ck"], 0)
    rcar = segs.level_excl_cumsum(nR_ck)
    u_bit0 = refstart.reshape(-1)[fst] + rcar.reshape(-1)[fck]
    nR_u = nR_ck.reshape(-1)[fck]
    ws = torch.clamp((u_bit0 >> 5) & ~127, 0,
                     (nwords - compact.WREF) // 128 * 128)
    return torch.stack([
        com["elem"] // compact.SUBB, com["elen"], com["p"], ws,
        u_bit0 - 32 * ws,
        torch.zeros_like(nR_u),
        torch.where(com["valid"], nR_u, 0),
        torch.zeros_like(nR_u),
    ], dim=1).to(_I32)


def _ref_bits(words, refstart, vmag, com, stats, pyr: Pyramid,
              channels: int, padded_T: int):
    """Kernel B: add the refinement bits into the stream words (in place)."""
    segs = segs_for(pyr, words.device)
    meta = _kernel_b_meta(stats, segs, com, refstart, pyr, padded_T,
                          words.shape[0])
    return scatter_refbits(vmag, meta, words)


def _layer_boundaries(stats, off, total_bits, pyr: Pyramid, channels: int):
    """(LMAX,) int32 bit offset at which each progressive quality layer
    ends (encode.c:183-220; the pre-step is layer 0): where the first token
    of any step of a later layer begins, capped by ``total_bits``."""
    C, L = channels, pyr.levels
    dev = off.device
    pm = stats["planes_max"]
    c_ix = torch.arange(C, dtype=_I32, device=dev)[:, None, None]
    l_ix = torch.arange(L, dtype=_I32, device=dev)[None, :, None]
    p_ix = torch.arange(PMAX, dtype=_I32, device=dev)[None, None, :]
    layers = torch.where(c_ix == 0, pm - 2 - p_ix + l_ix,
                         pm - 1 - p_ix + l_ix)
    bucket = torch.clamp(layers, min=-1) + 1  # pre-step -> 0
    valid = (p_ix < stats["planes"][:, None, None]).expand(C, L, PMAX)
    BIGBIT = 2**31 - 1
    start_bits = off[stats["step_base"].clamp(0, off.shape[0] - 1).long()]
    start_bits = torch.where(valid, start_bits, BIGBIT)
    ks = torch.arange(LMAX, dtype=_I32, device=dev)[:, None]
    later = (bucket.reshape(-1)[None, :] > ks) & valid.reshape(-1)[None, :]
    ends = torch.where(later, start_bits.reshape(-1)[None, :],
                       BIGBIT).amin(dim=1)
    return torch.minimum(ends, total_bits).to(_I32)


def _stream_words(pyr: Pyramid, channels: int, padded_T: int) -> int:
    """Static word-buffer size: worst-case compact-token bits (64/token) +
    worst-case refinement bits (PMAX per detail coefficient), plus the JAX
    package's pack-window slack and one spare slot (kept equal to it)."""
    n_det = (pyr.total - pyr.pixels[0]) * channels
    return (2 * padded_T + (n_det * PMAX) // 32
            + pack._win() + pack._win1() + 520)


def _stage2_emit(lin, stats, tv, tr, tf, orders, vmag, com, pyr: Pyramid,
                 channels: int, padded_T: int):
    """Stage-2 second half: codeword packing + refinement bits + layer
    boundaries.  ``vmag`` and ``com`` are kernel A's packed elements and
    unit indexing (from :func:`tokens._stage2_tokens`).  Returns (words,
    bits_parts, wild, layer_ends)."""
    C = channels
    nwords = _stream_words(pyr, C, padded_T)
    words, bits_parts, wild, off, refstart = _pack_bits(
        lin, stats, tv, tr, tf, orders, pyr, C, padded_T, nwords)
    words = _ref_bits(words, refstart, vmag, com, stats, pyr, C, padded_T)
    # int32 device total: exact for valid (< 2^31-bit) streams; the host
    # checks the Python-int total of bits_parts before trusting the ends.
    tot32 = bits_parts.sum(dtype=_I32)
    layer_ends = _layer_boundaries(stats, off, tot32, pyr, C)
    return words, bits_parts, wild, layer_ends
