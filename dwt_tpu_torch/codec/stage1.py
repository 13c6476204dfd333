"""Encoder stage 1: transform, linearization and plane statistics.

Port of the stage-1 half of ``dwt_tpu/codec/encoder.py`` (``_Segs``,
``_plane_stats``, ``_linearize``, ``_stats_from_lin``,
``_transform_and_stats``).  Every ``stats`` key keeps the JAX package's
name, shape, dtype and value (as the JAX package computes them on the
CPU).

Token ranks, not state machines: at plane p a coefficient with
significance plane q (MSB index of |coeff|) is a zero-run member when
q < p, newly significant (run-flush token + sign bit) when q == p and a
refinement bit when q > p, so every token's position in the stream is a
function of per-chunk plane histograms and one carry chain over the
(channel, level, plane) schedule.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..geometry import Pyramid
from ..hilbert import padded_layout
from ..ops import compact
from ..ops.color import rgb_to_ycocg
from ..ops.hilbert_gather import hilbert_gather
from ..ops.lifting import dwt2d_fwd

# Adaptive VLI order states (vli.h:67-84): enough for run lengths < 2^28.
NSTATE = 31
# Bitplane bound of the format: magnitudes stay below 2^29 because bits
# 29/30 are the reference's sig/ref coding flags (encode.c:115-128).
PMAX = 29
# Segment alignment of the scan-order layout (hilbert.padded_layout);
# 8 x compact.SUBA, so every unit starts on a whole row of packed elements.
ALIGN = 8192

_I32 = torch.int32


def _ilog2(x: torch.Tensor) -> torch.Tensor:
    """Floor log2 for x > 0 as int32 (garbage for x <= 0: mask at the call
    sites).  Exact: an integer below 2^53 converts to float64 exactly, and
    the exponent field of the float is its floor log2."""
    return ((x.to(torch.float64).view(torch.int64) >> 52) - 1023).to(_I32)


def _excl_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive cumsum that keeps int32 (torch's int32 cumsum is int64)."""
    return (torch.cumsum(x, dim=dim) - x).to(x.dtype)


class _Segs:
    """Static lane-aligned level-chunk segmentation of the detail axis.

    All segment starts and sizes are multiples of ALIGN; pad elements
    (valid False) never enter any mask.  Chunks of at most compact.E
    elements never cross a segment boundary: they are the units of the
    compaction kernels and the granularity of the per-chunk histograms.
    """

    def __init__(self, pyr: Pyramid, device):
        E = compact.E
        _, valid, sizes_p = padded_layout(pyr, ALIGN)
        self.L = pyr.levels
        self.root_pad = sizes_p[0]
        self.sizes = sizes_p[1:]
        self.real = tuple(pyr.pixels[l + 1] - pyr.pixels[l]
                          for l in range(self.L))
        self.starts = tuple(int(s) for s in np.cumsum((0,) + self.sizes[:-1]))
        self.n = sum(self.sizes)
        self.valid_np = valid[self.root_pad:]
        self.device = torch.device(device)
        self.valid_t = torch.as_tensor(self.valid_np, device=self.device)
        self.idx_local = torch.as_tensor(
            np.concatenate([np.arange(s, dtype=np.int32) for s in self.sizes]),
            device=self.device)
        ch_start, ch_len, lv_base, lv_cnt = [], [], [], []
        for st, sz in zip(self.starts, self.sizes):
            lv_base.append(len(ch_start))
            o = 0
            while o < sz:
                ln = min(E, sz - o)
                ch_start.append(st + o)
                ch_len.append(ln)
                o += ln
            lv_cnt.append(len(ch_start) - lv_base[-1])
        self.nchunk = len(ch_start)
        self.ch_start = tuple(ch_start)
        self.ch_len = tuple(ch_len)
        self.level_chunk_base = tuple(lv_base)
        self.level_nchunk = tuple(lv_cnt)
        self.ch_valid = tuple(
            int(self.valid_np[s : s + ln].sum())
            for s, ln in zip(ch_start, ch_len))
        # 512-element block -> chunk id (stage-1 hierarchical chunk sums).
        self.block_chunk = torch.as_tensor(
            np.repeat(np.arange(self.nchunk), [ln // 512 for ln in ch_len]),
            device=self.device)

    def sizes_t(self) -> torch.Tensor:
        return torch.as_tensor(self.sizes, device=self.device)

    def bcast(self, small: torch.Tensor) -> torch.Tensor:
        """(C, L) per-segment values -> (C, n) per-element."""
        return torch.repeat_interleave(small, self.sizes_t(), dim=1)

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """(C, n) -> (C, L) per-segment int32 sums."""
        return torch.stack(
            [x[:, s : s + z].sum(dim=1, dtype=_I32)
             for s, z in zip(self.starts, self.sizes)], dim=1)

    def reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(
            [x[:, s : s + z].amax(dim=1)
             for s, z in zip(self.starts, self.sizes)], dim=1)

    def chunk_sum(self, mask: torch.Tensor) -> torch.Tensor:
        """(C, n) bool -> (C, nchunk) int32 per-chunk counts."""
        b512 = mask.reshape(mask.shape[0], -1, 512).sum(-1, dtype=_I32)
        out = torch.zeros((mask.shape[0], self.nchunk), dtype=_I32,
                          device=mask.device)
        return out.index_add_(1, self.block_chunk, b512)

    def level_sum(self, x_ck: torch.Tensor) -> torch.Tensor:
        """(C, nchunk) -> (C, L) by summing each level's chunk span."""
        return torch.stack(
            [x_ck[:, b : b + c].sum(dim=1, dtype=_I32)
             for b, c in zip(self.level_chunk_base, self.level_nchunk)],
            dim=1)

    def level_excl_cumsum(self, x_ck: torch.Tensor) -> torch.Tensor:
        """Exclusive cumsum over the chunk axis (dim 1), restarting per
        level.  Works on (C, nchunk) or (C, nchunk, P)."""
        return torch.cat(
            [_excl_cumsum(x_ck[:, b : b + c], dim=1)
             for b, c in zip(self.level_chunk_base, self.level_nchunk)],
            dim=1)


@functools.lru_cache(maxsize=16)
def segs_for(pyr: Pyramid, device) -> _Segs:
    """The cached segmentation of ``pyr`` on ``device``."""
    return _Segs(pyr, device)


def _detail_q(lin, segs: _Segs):
    """(C, n) significance plane of each padded detail element (-1 = zero
    or pad), and the (1, n) validity mask."""
    det = lin[:, segs.root_pad :]
    valid = segs.valid_t[None, :]
    mag = det.abs()
    return torch.where((mag > 0) & valid, _ilog2(mag), -1), valid


def _plane_stats(q, valid, segs: _Segs, C: int, L: int, planes_max):
    """(C, L, PMAX) / (C, nchunk, PMAX) per-plane token statistics in
    three fused one-hot passes: per-512-block plane histograms,
    last-significant positions and boundary-prefix zero counts.

    trailZ(c, l, p) — zeros after the level's last newly significant
    element (rle.h run threading) — decomposes because level-local indices
    are monotone across a level's chunks: the level's lastS lies in one
    chunk k*, so z_upto = sum_{k<k*} nZ_ck[k] + (chunk-local zeros at
    idx <= lastS).  Values at p >= planes_max differ from
    :func:`_plane_stats_loop`'s zeros only in slots every consumer masks.
    """
    del valid, planes_max  # pads are -1 in q already; every plane is made
    dev = q.device
    nb = q.shape[1] // 512
    qb = q.reshape(C, nb, 512)
    validb = segs.valid_t.reshape(1, nb, 512)
    idxb = segs.idx_local.reshape(1, nb, 512)
    p_all = torch.arange(PMAX, dtype=_I32, device=dev)
    ids = segs.block_chunk

    z0_b = ((qb == -1) & validb).sum(dim=2, dtype=_I32)  # (C, nb)
    hist_p, last_p = [], []
    GP = 8  # planes per fused pass: bounds every temporary
    for g0 in range(0, PMAX, GP):
        oh = qb[..., None] == p_all[g0 : g0 + GP]
        hist_p.append(oh.sum(dim=2, dtype=_I32))
        last_p.append(torch.where(oh, idxb[..., None], -1).amax(dim=2))
    hist_b = torch.cat(hist_p, dim=-1)  # (C, nb, PMAX)
    lastS_b = torch.cat(last_p, dim=-1)

    def zeros_ckp():
        return torch.zeros((C, segs.nchunk, PMAX), dtype=_I32, device=dev)

    nS_ck = zeros_ckp().index_add_(1, ids, hist_b)
    lastS_ck = torch.full((C, segs.nchunk, PMAX), -1, dtype=_I32,
                          device=dev).scatter_reduce_(
        1, ids[None, :, None].expand(C, nb, PMAX), lastS_b, "amax")
    z0_ck = torch.zeros((C, segs.nchunk), dtype=_I32,
                        device=dev).index_add_(1, ids, z0_b)
    nZ_ck = z0_ck[..., None] + _excl_cumsum(nS_ck, dim=2)

    # Chunk-local boundary-prefix zeros: zeros at idx <= the chunk's own
    # last-significant position, per plane.
    lastS_bc = lastS_ck[:, ids]  # (C, nb, PMAX)
    qzb = torch.where(validb, qb, 2**30)
    zup_p = []
    for g0 in range(0, PMAX, GP):
        m = ((qzb[..., None] < p_all[g0 : g0 + GP])
             & (idxb[..., None] <= lastS_bc[:, :, None, g0 : g0 + GP]))
        zup_p.append(m.sum(dim=2, dtype=_I32))
    zup_ck = zeros_ckp().index_add_(1, ids, torch.cat(zup_p, dim=-1))

    def lvl(x, red):
        return torch.stack(
            [red(x[:, b : b + c]) for b, c in
             zip(segs.level_chunk_base, segs.level_nchunk)], dim=1)

    nS = lvl(nS_ck, lambda s: s.sum(dim=1, dtype=_I32))
    nZ = lvl(nZ_ck, lambda s: s.sum(dim=1, dtype=_I32))
    lastS = lvl(lastS_ck, lambda s: s.amax(dim=1))  # (C, L, PMAX)
    lastS_cc = torch.repeat_interleave(
        lastS, torch.as_tensor(segs.level_nchunk, device=dev), dim=1)
    zcar = segs.level_excl_cumsum(nZ_ck)
    is_k = (lastS_ck == lastS_cc) & (lastS_ck >= 0)
    z_upto = lvl(torch.where(is_k, zcar + zup_ck, 0),
                 lambda s: s.sum(dim=1, dtype=_I32))
    return nS, nZ, nZ - z_upto, nS_ck, nZ_ck


def _plane_stats_loop(q, valid, segs: _Segs, C: int, L: int, planes_max):
    """Per-plane reference formulation of :func:`_plane_stats` (zeros at
    p >= planes_max); the tests hold the fused passes against it."""
    dev = q.device
    idx = segs.idx_local[None, :].expand(q.shape)
    zc = torch.zeros((C, L, PMAX), dtype=_I32, device=dev)
    zk = torch.zeros((C, segs.nchunk, PMAX), dtype=_I32, device=dev)
    nS, nZ, trailZ, nS_ck, nZ_ck = zc, zc.clone(), zc.clone(), zk, zk.clone()
    for p in range(min(int(planes_max), PMAX)):
        maskS = (q == p) & valid
        maskZ = (q < p) & valid
        s_ck = segs.chunk_sum(maskS)
        z_ck = segs.chunk_sum(maskZ)
        z_cnt = segs.level_sum(z_ck)
        lastS = segs.reduce_max(torch.where(maskS, idx, -1))
        z_upto = segs.reduce_sum(
            (maskZ & (idx <= segs.bcast(lastS))).to(_I32))
        nS[:, :, p] = segs.level_sum(s_ck)
        nZ[:, :, p] = z_cnt
        trailZ[:, :, p] = z_cnt - z_upto
        nS_ck[:, :, p] = s_ck
        nZ_ck[:, :, p] = z_ck
    return nS, nZ, trailZ, nS_ck, nZ_ck


def _transform_and_stats(img, pyr: Pyramid, channels: int, gray: bool, src):
    """(H, W, C) image -> (lin, stats).  ``src``: the gather's source index
    (see :func:`gather_source`)."""
    data = img.to(_I32)
    if not gray:
        data = rgb_to_ycocg(data)
    coeff = dwt2d_fwd(data, pyr)
    return _stats_from_lin(_linearize(coeff, src, pyr, channels), pyr,
                           channels)


def gather_source(pyr: Pyramid) -> np.ndarray:
    """(nlin,) int32 gather source of every slot of
    ``padded_layout(pyr, ALIGN)``: the flat pixel index, or -1 for pads and
    the root band (which the gather leaves 0)."""
    perm, valid, sizes = padded_layout(pyr, ALIGN)
    src = np.where(valid, perm, -1).astype(np.int32)
    src[: sizes[0]] = -1
    return src


def _linearize(coeff, src, pyr: Pyramid, channels: int):
    """(H, W, C) coefficients -> (C, nlin) padded scan-order layout: the
    gather kernel places the detail bands (pads stay 0), then the root
    band is written as a dense raster crop."""
    lin = hilbert_gather(coeff.contiguous(), src)
    h0, w0 = pyr.heights[0], pyr.widths[0]
    lin[:, : h0 * w0] = coeff[:h0, :w0, :].reshape(h0 * w0, channels).T
    return lin


def _carry_chain(carry0: int, valid_s, nS_s, nZ_s, trailZ_s, nRef_s):
    """Zero-run carry chain over the schedule steps (rle.h cnt threading),
    on the host: the chain has C * L * PMAX steps, a few hundred to a few
    thousand, and is sequential."""
    S = valid_s.shape[0]
    carry_in = np.zeros(S, np.int32)
    refrun_val = np.zeros(S, np.int32)
    refrun_ok = np.zeros(S, bool)
    carry = carry0
    for i in range(S):
        v, s_cnt, z_cnt = bool(valid_s[i]), int(nS_s[i]), int(nZ_s[i])
        t_z, r_cnt = int(trailZ_s[i]), int(nRef_s[i])
        rv = t_z if s_cnt > 0 else carry + z_cnt
        carry_in[i] = carry
        refrun_val[i] = rv
        refrun_ok[i] = v and r_cnt > 0 and rv > 0
        if v:
            carry = 0 if r_cnt > 0 else rv
    return carry_in, refrun_val, refrun_ok, carry


def _stats_from_lin(lin, pyr: Pyramid, channels: int):
    """Stage-1 statistics from the linearized coefficients."""
    dev = lin.device
    pix0 = pyr.pixels[0]
    L, C = pyr.levels, channels
    segs = segs_for(pyr, dev)

    root = lin[:, :pix0]
    q, valid = _detail_q(lin, segs)

    planes = (1 + q.amax(dim=1)).to(_I32)  # (C,)
    planes_max = planes.max()

    nS, nZ, trailZ, nS_ck, nZ_ck = _plane_stats(q, valid, segs, C, L,
                                                planes_max)
    nums = torch.as_tensor(segs.real, dtype=_I32, device=dev)
    p_ix = torch.arange(PMAX, dtype=_I32, device=dev)[None, None, :]
    nRef = torch.where(p_ix < planes_max, nums[None, :, None] - nZ - nS, 0)

    # --- schedule order over the (C, L, PMAX) step grid -------------------
    c_ix = torch.arange(C, dtype=_I32, device=dev)[:, None, None]
    l_ix = torch.arange(L, dtype=_I32, device=dev)[None, :, None]
    sec = (c_ix > 0).to(_I32)
    layers = torch.where(sec == 0, planes_max - 2 - p_ix + l_ix,
                         planes_max - 1 - p_ix + l_ix)
    valid = (p_ix < planes[:, None, None]).expand(C, L, PMAX)
    key = ((layers + 1) << 16) | (sec << 12) | (l_ix << 6) | c_ix
    key = torch.where(valid, key, 2**30).reshape(-1)
    order = torch.argsort(key, stable=True)  # schedule order of flat steps

    nS_s = nS.reshape(-1)[order]
    nZ_s = nZ.reshape(-1)[order]
    trailZ_s = trailZ.reshape(-1)[order]
    nRef_s = nRef.reshape(-1)[order]
    valid_s = valid.reshape(-1)[order]

    # When planes_max == 0 the degenerate pre-step (plane index -1,
    # encode.c:190-194) contributes chunk 0's positions as pure zeros.
    pm = int(planes_max)
    host = [t.cpu().numpy() for t in (valid_s, nS_s, nZ_s, trailZ_s, nRef_s)]
    cin, rrv, rro, carry_end = _carry_chain(
        segs.real[0] if pm == 0 else 0, *host)
    carry_in_s = torch.as_tensor(cin, device=dev)
    refrun_val_s = torch.as_tensor(rrv, device=dev)
    refrun_ok_s = torch.as_tensor(rro, device=dev)

    # --- token counts / bases ---------------------------------------------
    root_max = root.abs().amax(dim=1)
    root_cnt = torch.where(root_max > 0,
                           1 + _ilog2(root_max.clamp(min=1)), 0).to(_I32)
    nnz_root = (root != 0).sum(dim=1, dtype=_I32)
    root_tokens = (1 + torch.where(root_cnt > 0, pix0 + nnz_root, 0)).to(_I32)
    root_base = _excl_cumsum(root_tokens)
    planes_base = root_tokens.sum(dtype=_I32)
    steps_base0 = planes_base + C

    # Refinement bits are not tokens: they are raw bits at closed-form
    # positions, packed straight into the stream words.  Each step's base
    # is padded to an even slot (the extra slot is a 0-bit raw token), as
    # kernel A and the token finisher work in pair space.  (The JAX
    # package pads to its TPU pack kernel's blocks instead; the CUDA pack
    # kernel has no blocks, and this is the JAX package's layout on the
    # CPU, so every intermediate still compares one to one.)
    cnt_s = torch.where(valid_s, 2 * nS_s + refrun_ok_s.to(_I32), 0)
    cnt_al = (cnt_s + 1) // 2 * 2
    steps_base0_al = (steps_base0 + 1) // 2 * 2
    base_s = (steps_base0_al + _excl_cumsum(cnt_al)).to(_I32)
    T = (steps_base0_al + cnt_al.sum(dtype=_I32) + 1).to(_I32)  # + flush
    # Refinement-bit injection site of a step: the next step's base.
    inj_pos_s = torch.cat([base_s[1:], (T - 1)[None]]).to(_I32)
    nref_v = torch.where(valid_s, nRef_s, 0)
    refpfx_s = _excl_cumsum(nref_v).to(_I32)

    S = C * L * PMAX

    def unsort(x):
        out = torch.zeros(S, dtype=x.dtype, device=dev)
        out[order] = x
        return out.reshape(C, L, PMAX)

    return lin, dict(
        planes=planes, planes_max=planes_max,
        nS=nS, nRef=nRef, root_cnt=root_cnt, root_base=root_base,
        planes_base=planes_base,
        step_base=unsort(base_s),
        step_end=unsort((base_s + cnt_s).to(_I32)),
        inj_pos=unsort(inj_pos_s),
        refpfx=unsort(refpfx_s),
        carry_in=unsort(carry_in_s),
        refrun_val=unsort(refrun_val_s),
        refrun_ok=unsort(refrun_ok_s),
        valid=valid.contiguous(),
        carry_end=torch.tensor(carry_end, dtype=_I32, device=dev),
        T=T,
        order=order.to(_I32),
        nS_ck=nS_ck,
        nZ_ck=nZ_ck,
        # Schedule-ordered (S,) step views for the token finisher and the
        # kernel metadata.
        base_sched=base_s,
        nS_sched=torch.where(valid_s, nS_s, 0),
        cin_sched=carry_in_s,
        valid_sched=valid_s,
    )
