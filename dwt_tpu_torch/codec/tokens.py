"""Encoder stage 2, tokens half: significance tokens, the dense token
finisher and the adaptive-VLI order scan.

Port of ``dwt_tpu/codec/encoder.py`` ``_packed_elems``,
``_unit_common``, ``_kernel_a_meta``, ``_sig_tokens_pallas`` (here
:func:`_sig_tokens`, always through kernel A), ``_finish_tokens``,
``_vli_ab``, ``_vli_orders`` and ``_stage2_tokens``.
"""

from __future__ import annotations

import torch

from ..geometry import Pyramid
from ..ops import compact
from ..ops.compact import compact_tokens
from .stage1 import NSTATE, PMAX, _Segs, _excl_cumsum, _ilog2, segs_for

_I32 = torch.int32

# Sequential steps of the VLI order scan (tokens per block); the blocks'
# transition maps compose in a log-depth scan.  Any power of two that
# divides the token bucket gives the same orders.
VLI_BLOCK = 128


def _packed_elems(lin, segs: _Segs):
    """((C*n + E) / SUBA, SUBA) int32 rows for the compaction kernels:
    bits 0-29 |coeff|, bit 30 sign, -1 = padding."""
    det = lin[:, segs.root_pad :]
    valid = segs.valid_t[None, :]
    vm = torch.where(valid, det.abs() | ((det < 0).to(_I32) << 30), -1)
    flat = torch.cat([vm.reshape(-1),
                      torch.full((compact.E,), -1, dtype=_I32,
                                 device=lin.device)])
    return flat.reshape(-1, compact.SUBA)


def _unit_common(stats, segs: _Segs, pyr: Pyramid, channels: int):
    """Per-unit (schedule step x E-element chunk) indexing shared by both
    compaction kernels, in stream order.  All (U,) int32 with
    U = C * PMAX * nchunk."""
    L, C = pyr.levels, channels
    dev = stats["order"].device
    order = stats["order"]
    c_s = order // (L * PMAX)
    l_s = (order // PMAX) % L
    p_s = order % PMAX
    npl = torch.as_tensor(segs.level_nchunk, dtype=_I32, device=dev)
    ups = npl[l_s.long()]
    ubase = _excl_cumsum(ups)
    U = C * PMAX * segs.nchunk
    u = torch.arange(U, dtype=_I32, device=dev)
    sidx = (torch.searchsorted(ubase, u, right=True) - 1).long()
    k = u - ubase[sidx]
    c_u, l_u, p_u = c_s[sidx], l_s[sidx], p_s[sidx]
    chunkid = torch.as_tensor(segs.level_chunk_base, dtype=_I32,
                              device=dev)[l_u.long()] + k
    elem = c_u * segs.n + torch.as_tensor(
        segs.ch_start, dtype=_I32, device=dev)[chunkid.long()]
    elen = torch.as_tensor(segs.ch_len, dtype=_I32, device=dev)[chunkid.long()]
    flat_step = order[sidx]
    flat_ck = (c_u * segs.nchunk + chunkid) * PMAX + p_u
    return dict(elem=elem, elen=elen, p=p_u, flat_step=flat_step,
                flat_ck=flat_ck, valid=stats["valid_sched"][sidx])


def _kernel_a_meta(stats, segs: _Segs, com, padded_T: int):
    """(U, 8) int32 metadata of kernel A and the pair-buffer size."""
    fck, fst = com["flat_ck"].long(), com["flat_step"].long()
    scar = segs.level_excl_cumsum(stats["nS_ck"])
    zcar = segs.level_excl_cumsum(stats["nZ_ck"])
    nS_u = stats["nS_ck"].reshape(-1)[fck]
    u_pair0 = (stats["step_base"].reshape(-1)[fst] >> 1) + scar.reshape(-1)[fck]
    pairbuf = padded_T // 2 + compact.WTOK_BIG + 256
    # The window start is kept as the TPU kernel's (128-aligned, clipped),
    # so the table compares one to one; the kernel writes at col3 + col4.
    ws = torch.clamp(u_pair0 & ~127, 0,
                     (pairbuf - compact.WTOK_BIG) // 128 * 128)
    meta = torch.stack([
        com["elem"] // compact.SUBA, com["elen"], com["p"], ws, u_pair0 - ws,
        zcar.reshape(-1)[fck],
        torch.where(com["valid"], nS_u, 0),
        torch.zeros_like(nS_u),
    ], dim=1).to(_I32)
    return meta, pairbuf


def _sig_tokens(lin, stats, pyr: Pyramid, channels: int, padded_T: int):
    """Kernel A: each newly significant element's zero-prefix and sign at
    its PAIR rank (step bases are even, so pair rank = token slot / 2).
    Returns (zero-prefixes, signs, packed elements, unit indexing)."""
    segs = segs_for(pyr, lin.device)
    com = _unit_common(stats, segs, pyr, channels)
    meta, pairbuf = _kernel_a_meta(stats, segs, com, padded_T)
    vmag = _packed_elems(lin, segs)
    pairs = compact_tokens(vmag, meta, pairbuf)[: padded_T // 2]
    return pairs >> 1, pairs & 1, vmag, com


def _interleave2(a, b):
    """``[a0, b0, a1, b1, ...]`` for 1-D same-shape ``a`` and ``b``."""
    return torch.stack([a, b], dim=-1).reshape(-1)


def _fill_max(pos, vals, idx):
    """``cummax(zeros(n).scatter_reduce(0, pos, vals, "amax"))[idx]``: the
    max of 0 and of every ``vals[j]`` with ``pos[j] <= i``, by a binary
    search of the (S,) sorted positions instead of a scan over all n
    (torch's cummax kernel is slow)."""
    o = torch.argsort(pos, stable=True)
    best = torch.cummax(vals[o].clamp(min=0), dim=0).values
    k = torch.searchsorted(pos[o], idx, right=True) - 1
    return torch.where(k >= 0, best[k.clamp(min=0)], 0)


def _finish_tokens(zp, sgn, lin, stats, pyr: Pyramid, channels: int,
                   padded_T: int):
    """Dense completion of the token arrays (values, raw bit counts, VLI
    flags) from the pair-rank zero-prefixes and signs: step membership by
    forward fills of the schedule-step tables (:func:`_fill_max`), run values
    as diffs of consecutive zero-prefixes (+ the step's cross-step zero
    carry at its first pair), then root, plane-count, ref-run and flush
    tokens as small scatters."""
    C = channels
    dev = zp.device
    pix0 = pyr.pixels[0]
    DUMP = padded_T

    npair = padded_T // 2
    pa = torch.arange(npair, dtype=_I32, device=dev)
    base_p = stats["base_sched"] >> 1
    nS_sched = stats["nS_sched"]
    bpos = base_p.clamp(0, npair - 1).long()
    zero_p = torch.zeros(npair, dtype=_I32, device=dev)
    sb_f = _fill_max(bpos, base_p, pa)
    se_f = _fill_max(bpos, base_p + nS_sched, pa)
    in_sig = pa < se_f  # pad pairs / pre-step region: se_f <= pa
    first = pa == sb_f
    cin_add = zero_p.index_add(0, bpos, torch.where(
        stats["valid_sched"] & (nS_sched > 0), stats["cin_sched"], 0))
    prev1 = torch.cat([zero_p[:1], zp[:-1]])
    runval = zp - torch.where(first, 0, prev1) + cin_add

    tok_val = _interleave2(torch.where(in_sig, runval, zp), sgn)
    tok_raw = _interleave2(zero_p, in_sig.to(_I32))
    tok_vli = _interleave2(in_sig, torch.zeros_like(in_sig))

    # spare DUMP slot for masked small scatters
    tok_val = torch.cat([tok_val, zero_p[:1]])
    tok_raw = torch.cat([tok_raw, zero_p[:1]])
    tok_vli = torch.cat([tok_vli, in_sig[:1] & False])

    # --- root band tokens (encode.c:97-110) -------------------------------
    root = lin[:, :pix0]
    root_cnt, root_base = stats["root_cnt"], stats["root_base"]
    nnzpfx = _excl_cumsum((root != 0).to(_I32), dim=1)
    i_ix = torch.arange(pix0, dtype=_I32, device=dev)[None, :]
    tok_val[root_base.long()] = root_cnt
    tok_vli[root_base.long()] = True
    r_rank = root_base[:, None] + 1 + i_ix + nnzpfx
    r_ok = root_cnt[:, None] > 0
    r_rank_m = torch.where(r_ok, r_rank, DUMP).reshape(-1).long()
    tok_val[r_rank_m] = root.abs().reshape(-1)
    tok_raw[r_rank_m] = root_cnt[:, None].expand(root.shape).reshape(-1)
    s_ok = r_ok & (root != 0)
    s_rank = torch.where(s_ok, r_rank + 1, DUMP).reshape(-1).long()
    tok_val[s_rank] = (root < 0).to(_I32).reshape(-1)
    tok_raw[s_rank] = 1

    # --- per-channel plane counts (encode.c:181-182) ----------------------
    pr = (stats["planes_base"] + torch.arange(C, dtype=_I32, device=dev)).long()
    tok_val[pr] = stats["planes"]
    tok_vli[pr] = True

    # --- ref-pass leading run tokens + final flush (rle_flush) ------------
    rr_rank = torch.where(stats["refrun_ok"],
                          stats["step_base"] + 2 * stats["nS"],
                          DUMP).reshape(-1).long()
    tok_val[rr_rank] = stats["refrun_val"].reshape(-1)
    tok_vli[rr_rank] = True
    t_last = int(stats["T"]) - 1
    tok_val[t_last] = stats["carry_end"]
    tok_vli[t_last] = True

    return tok_val[:padded_T], tok_raw[:padded_T], tok_vli[:padded_T]


def _vli_ab(tok_val, tok_vli):
    """Per-token transition parameters, +1-biased (0 = non-VLI no-op):
    ns = clamp(ilog2(v + 2^s) - 2) and ilog2(v + 2^s) = max(s, A +
    (s >= B)) with A = ilog2(v) and B = ceil_log2(2^(A+1) - v)."""
    A = torch.clamp(_ilog2(tok_val.clamp(min=1)), min=0)
    rem = (2 << A) - tok_val
    Bt = torch.where(rem <= 1, 0, _ilog2((rem - 1).clamp(min=1)) + 1)
    return torch.where(tok_vli, (A | (Bt << 5)) + 1, 0)


def _vli_orders(tok_val, tok_vli, padded_T: int):
    """Exact adaptive-VLI order state (vli.h:67-84) at every token.

    The order is a chain over NSTATE values through every VLI token.  The
    tokens split into blocks of TB: pass A runs each block over all
    NSTATE entry states at once (TB sequential steps, every block in
    parallel), giving its transition map; pass B composes the maps with a
    log-depth inclusive scan (map composition is a gather); pass C replays
    each block from its true entry state and records every token's order
    before its own transition.
    """
    TB = VLI_BLOCK
    while padded_T % TB:
        TB //= 2
    nblk = padded_T // TB
    x = _vli_ab(tok_val, tok_vli).reshape(nblk, TB).T  # (TB, nblk)
    a_all = ((x - 1) & 31).to(torch.int8)
    b_all = (((x - 1) >> 5) & 31).to(torch.int8)
    act_all = x > 0

    def apply1(s, t):
        a, b, act = a_all[t], b_all[t], act_all[t]
        if s.dim() == 2:
            a, b, act = a[:, None], b[:, None], act[:, None]
        ns = torch.clamp(torch.maximum(s, a + (s >= b).to(torch.int8)) - 2,
                         0, NSTATE - 1)
        return torch.where(act, ns, s)

    # Pass A: per-block transition map for every entry state.
    maps = torch.arange(NSTATE, dtype=torch.int8,
                        device=x.device)[None, :].repeat(nblk, 1)
    for t in range(TB):
        maps = apply1(maps, t)

    # Pass B: minc[i] maps the order entering block 0 to the order leaving
    # block i (Hillis-Steele: apply the earlier map first).
    minc = maps.long()
    d = 1
    while d < nblk:
        nxt = minc.clone()
        nxt[d:] = torch.gather(minc[d:], 1, minc[:-d])
        minc = nxt
        d *= 2
    entry = torch.cat([torch.zeros(1, dtype=torch.int8, device=x.device),
                       minc[:-1, 0].to(torch.int8)])

    # Pass C: replay from the true entry states.
    orders = torch.empty((TB, nblk), dtype=torch.int8, device=x.device)
    s = entry
    for t in range(TB):
        orders[t] = s
        s = apply1(s, t)
    return orders.T.reshape(padded_T).to(_I32)


def _stage2_tokens(lin, stats, pyr: Pyramid, channels: int, padded_T: int):
    """Stage-2 first half: token build + VLI order scan.  Returns (tv, tr,
    tf, orders, vmag, com): the packed elements and unit indexing of
    kernel A, which kernel B reuses in :func:`emit._stage2_emit`."""
    zp, sgn, vmag, com = _sig_tokens(lin, stats, pyr, channels, padded_T)
    tv, tr, tf = _finish_tokens(zp, sgn, lin, stats, pyr, channels, padded_T)
    return tv, tr, tf, _vli_orders(tv, tf, padded_T), vmag, com
