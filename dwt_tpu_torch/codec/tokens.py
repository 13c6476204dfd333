"""Encoder stage 2, tokens half: significance tokens, the dense token
finisher and the adaptive-VLI order scan.

Port of ``dwt_tpu/codec/encoder.py`` ``_packed_elems``,
``_unit_common``, ``_kernel_a_meta``, ``_sig_tokens_pallas`` (here
:func:`_sig_tokens`, always through kernel A), ``_finish_tokens``,
``_vli_ab``, ``_vli_orders`` and ``_stage2_tokens``.  Every function
takes a leading frame axis (N frames of one geometry at one token bucket:
the JAX package's functions under ``jax.vmap``); the kernels launch once
for the N frames, over their arrays laid end to end.
"""

from __future__ import annotations

import torch

from ..geometry import Pyramid
from ..ops import compact
from ..ops.compact import compact_tokens
# Not called on the encode path since the VLI order scan reads the token
# arrays in place; the benchmark wraps ``tokens.transpose2d`` by this name.
from ..ops.transpose import transpose2d  # noqa: F401
from ..ops.vli_scan import vli_orders
from .stage1 import PMAX, _Segs, _excl_cumsum, _ilog2, segs_for

_I32 = torch.int32

# Tokens a block of the VLI order scan's plain version
# (``ops/vli_scan.py:vli_orders_plain``); any power of two that divides the
# token bucket gives the same orders.
VLI_BLOCK = 128


def _frame_ix(n: int, device) -> torch.Tensor:
    """(n, 1) int32 frame index, for per-frame offsets."""
    return torch.arange(n, dtype=_I32, device=device)[:, None]


def _packed_elems(lin, segs: _Segs):
    """((N*C*n + E) / SUBA, SUBA) int32 rows for the compaction kernels,
    frame after frame: bits 0-29 |coeff|, bit 30 sign, -1 = padding."""
    det = lin[..., segs.root_pad :]
    valid = segs.valid_t[None, :]
    vm = torch.where(valid, det.abs() | ((det < 0).to(_I32) << 30), -1)
    flat = torch.cat([vm.reshape(-1),
                      torch.full((compact.E,), -1, dtype=_I32,
                                 device=lin.device)])
    return flat.reshape(-1, compact.SUBA)


def _unit_common(stats, segs: _Segs, pyr: Pyramid, channels: int):
    """Per-unit (schedule step x E-element chunk) indexing shared by both
    compaction kernels, in each frame's stream order.  All (N, U) int32
    with U = C * PMAX * nchunk, each frame's own (elements counted from
    its first)."""
    L, C = pyr.levels, channels
    order = stats["order"]  # (N, S)
    N, dev = order.shape[0], order.device
    c_s = order // (L * PMAX)
    l_s = (order // PMAX) % L
    p_s = order % PMAX
    ups = segs.level_nchunk_t[l_s.long()]
    ubase = _excl_cumsum(ups)
    U = C * PMAX * segs.nchunk
    u = torch.arange(U, dtype=_I32, device=dev).expand(N, U).contiguous()
    sidx = torch.searchsorted(ubase, u, right=True) - 1
    k = u - ubase.gather(1, sidx)
    c_u, l_u, p_u = (x.gather(1, sidx) for x in (c_s, l_s, p_s))
    chunkid = segs.level_chunk_base_t[l_u.long()] + k
    elem = c_u * segs.n + segs.ch_start_t[chunkid.long()]
    elen = segs.ch_len_t[chunkid.long()]
    flat_step = order.gather(1, sidx)
    flat_ck = (c_u * segs.nchunk + chunkid) * PMAX + p_u
    return dict(elem=elem, elen=elen, p=p_u, flat_step=flat_step,
                flat_ck=flat_ck, valid=stats["valid_sched"].gather(1, sidx))


def _kernel_a_meta(stats, segs: _Segs, com, padded_T: int):
    """(N*U, 8) int32 metadata of kernel A over the N frames, and the pair
    buffer of one frame: frame f's rows read its elements (col 0 past the
    earlier frames' N*C*n) and write pairs f * pairbuf onwards (col 3)."""
    fck, fst = com["flat_ck"].long(), com["flat_step"].long()
    N, C = fck.shape[0], stats["planes"].shape[1]
    scar = segs.level_excl_cumsum(stats["nS_ck"]).reshape(N, -1)
    zcar = segs.level_excl_cumsum(stats["nZ_ck"]).reshape(N, -1)
    nS_u = stats["nS_ck"].reshape(N, -1).gather(1, fck)
    u_pair0 = ((stats["step_base"].reshape(N, -1).gather(1, fst) >> 1)
               + scar.gather(1, fck))
    pairbuf = padded_T // 2 + compact.WTOK_BIG + 256
    # The window start is kept as the TPU kernel's (128-aligned, clipped),
    # so the table compares one to one; the kernel writes at col3 + col4.
    ws = torch.clamp(u_pair0 & ~127, 0,
                     (pairbuf - compact.WTOK_BIG) // 128 * 128)
    f = _frame_ix(N, fck.device)
    meta = torch.stack([
        (com["elem"] + f * (C * segs.n)) // compact.SUBA, com["elen"],
        com["p"], ws + f * pairbuf, u_pair0 - ws,
        zcar.gather(1, fck),
        torch.where(com["valid"], nS_u, 0),
        torch.zeros_like(nS_u),
    ], dim=2).to(_I32)
    return meta.reshape(-1, 8), pairbuf


def _kernel_a_table(flat_ck):
    """(N * C * nchunk, PMAX) int32 unit table of kernel A's CUDA version:
    the meta row of each (frame, channel, chunk, plane) unit, i.e. the
    inverse of the permutation (N, U) ``flat_ck`` with frame f's units
    offset by f * U (one scatter on the device, no host sync).  Its grid
    is static for a geometry and batch size."""
    N, U = flat_ck.shape
    flat = (flat_ck + _frame_ix(N, flat_ck.device) * U).reshape(-1).long()
    table = torch.empty(N * U, dtype=_I32, device=flat_ck.device)
    table[flat] = torch.arange(N * U, dtype=_I32, device=flat_ck.device)
    return table.reshape(-1, PMAX)


def _sig_tokens(lin, stats, pyr: Pyramid, channels: int, padded_T: int):
    """Kernel A, one launch pair for the N frames: each newly significant
    element's zero-prefix and sign at its PAIR rank (step bases are even,
    so pair rank = token slot / 2).  Returns ((N, padded_T / 2)
    zero-prefixes, signs, packed elements, unit indexing); the unit
    indexing also holds kernel A's unit table ("table") and the key
    histograms of its count launch ("hist"), which kernel B reuses: B's
    meta rows come in the same order, and every group live for B has a
    live A unit (ops/compact.py:scatter_refbits)."""
    N = lin.shape[0]
    segs = segs_for(pyr, lin.device)
    com = _unit_common(stats, segs, pyr, channels)
    meta, pairbuf = _kernel_a_meta(stats, segs, com, padded_T)
    vmag = _packed_elems(lin, segs)
    com["table"] = _kernel_a_table(com["flat_ck"])
    com["hist"] = compact.hist_for(com["table"])
    pairs = compact_tokens(vmag, meta, N * pairbuf, com["table"],
                           com["hist"]).reshape(N, pairbuf)[:, : padded_T // 2]
    return pairs >> 1, pairs & 1, vmag, com


def _interleave2(a, b):
    """``[a0, b0, a1, b1, ...]`` along the last axis of same-shape ``a``
    and ``b``."""
    return torch.stack([a, b], dim=-1).reshape(*a.shape[:-1], -1)


def _fill_max(pos, vals, idx):
    """``cummax(zeros(n).scatter_reduce(-1, pos, vals, "amax"))[..., idx]``:
    the max of 0 and of every ``vals[..., j]`` with ``pos[..., j] <= i``,
    by a binary search of the (..., S) sorted positions instead of a scan
    over all n (torch's cummax kernel is slow).  ``idx`` (n,) is shared by
    the leading axes."""
    o = torch.argsort(pos, dim=-1, stable=True)
    best = torch.cummax(vals.gather(-1, o).clamp(min=0), dim=-1).values
    idx = idx.expand(*pos.shape[:-1], -1).contiguous()
    k = torch.searchsorted(pos.gather(-1, o), idx, right=True) - 1
    return torch.where(k >= 0, best.gather(-1, k.clamp(min=0)), 0)


def _finish_tokens(zp, sgn, lin, stats, pyr: Pyramid, channels: int,
                   padded_T: int):
    """Dense completion of the (N, padded_T) token arrays (values, raw bit
    counts, VLI flags) from the pair-rank zero-prefixes and signs: step
    membership by forward fills of the schedule-step tables
    (:func:`_fill_max`), run values as diffs of consecutive zero-prefixes
    (+ the step's cross-step zero carry at its first pair), then root,
    plane-count, ref-run and flush tokens as small scatters, each frame's
    into its own row (flat index f * (padded_T + 1) + slot; slot padded_T
    takes masked writes).  Constants go in by ``index_fill_``, whose scalar
    needs no host-to-device copy."""
    C = channels
    N, dev = zp.shape[0], zp.device
    pix0 = pyr.pixels[0]
    DUMP = padded_T

    npair = padded_T // 2
    pa = torch.arange(npair, dtype=_I32, device=dev)
    base_p = stats["base_sched"] >> 1
    nS_sched = stats["nS_sched"]
    bpos = base_p.clamp(0, npair - 1).long()
    zero_p = torch.zeros((N, npair), dtype=_I32, device=dev)
    sb_f = _fill_max(bpos, base_p, pa)
    se_f = _fill_max(bpos, base_p + nS_sched, pa)
    in_sig = pa < se_f  # pad pairs / pre-step region: se_f <= pa
    first = pa == sb_f
    cin_add = zero_p.scatter_add(1, bpos, torch.where(
        stats["valid_sched"] & (nS_sched > 0), stats["cin_sched"], 0))
    prev1 = torch.cat([zero_p[:, :1], zp[:, :-1]], dim=1)
    runval = zp - torch.where(first, 0, prev1) + cin_add

    # spare DUMP slot for masked small scatters
    tok_val = torch.cat([_interleave2(torch.where(in_sig, runval, zp), sgn),
                         zero_p[:, :1]], dim=1)
    tok_raw = torch.cat([_interleave2(zero_p, in_sig.to(_I32)),
                         zero_p[:, :1]], dim=1)
    tok_vli = torch.cat([_interleave2(in_sig, torch.zeros_like(in_sig)),
                         in_sig[:, :1] & False], dim=1)
    val, raw, vli = (t.view(-1) for t in (tok_val, tok_raw, tok_vli))
    rows = torch.arange(N, device=dev) * (padded_T + 1)  # row starts

    def at(slot):
        """Flat indices of the (N, ...) per-frame slots ``slot``."""
        return (slot.long() + rows.view(N, *[1] * (slot.dim() - 1))
                ).reshape(-1)

    # --- root band tokens (encode.c:97-110) -------------------------------
    root = lin[:, :, :pix0]
    root_cnt, root_base = stats["root_cnt"], stats["root_base"]
    nnzpfx = _excl_cumsum((root != 0).to(_I32), dim=2)
    i_ix = torch.arange(pix0, dtype=_I32, device=dev)[None, None, :]
    val[at(root_base)] = root_cnt.reshape(-1)
    vli.index_fill_(0, at(root_base), True)
    r_rank = root_base[:, :, None] + 1 + i_ix + nnzpfx
    r_ok = root_cnt[:, :, None] > 0
    r_rank_m = at(torch.where(r_ok, r_rank, DUMP))
    val[r_rank_m] = root.abs().reshape(-1)
    raw[r_rank_m] = root_cnt[:, :, None].expand(root.shape).reshape(-1)
    s_ok = r_ok & (root != 0)
    s_rank = at(torch.where(s_ok, r_rank + 1, DUMP))
    val[s_rank] = (root < 0).to(_I32).reshape(-1)
    raw.index_fill_(0, s_rank, 1)

    # --- per-channel plane counts (encode.c:181-182) ----------------------
    pr = at(stats["planes_base"][:, None]
            + torch.arange(C, dtype=_I32, device=dev))
    val[pr] = stats["planes"].reshape(-1)
    vli.index_fill_(0, pr, True)

    # --- ref-pass leading run tokens + final flush (rle_flush) ------------
    rr_rank = at(torch.where(stats["refrun_ok"],
                             stats["step_base"] + 2 * stats["nS"], DUMP))
    val[rr_rank] = stats["refrun_val"].reshape(-1)
    vli.index_fill_(0, rr_rank, True)
    t_last = at(stats["T"][:, None] - 1)
    val[t_last] = stats["carry_end"]
    vli.index_fill_(0, t_last, True)

    return (tok_val[:, :padded_T], tok_raw[:, :padded_T],
            tok_vli[:, :padded_T])


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
    zp, sgn, vmag, com = _sig_tokens(lin, stats, pyr, channels, padded_T)
    tv, tr, tf = _finish_tokens(zp, sgn, lin, stats, pyr, channels, padded_T)
    return tv, tr, tf, _vli_orders(tv, tf, padded_T), vmag, com
