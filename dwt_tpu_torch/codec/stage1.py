"""Encoder stage 1: transform, linearization and plane statistics.

Port of the stage-1 half of ``dwt_tpu/codec/encoder.py`` (``_Segs``,
``_plane_stats``, ``_linearize``, ``_stats_from_lin``,
``_transform_and_stats``).  Every function takes a leading frame axis:
N same-geometry frames go through one pipeline (the JAX package's
functions under ``jax.vmap``), and one stream is the case N = 1.  Every
``stats`` key keeps the JAX package's name, dtype and value (as the JAX
package computes them on the CPU), with a leading N.

Token ranks, not state machines: at plane p a coefficient with
significance plane q (MSB index of |coeff|) is a zero-run member when
q < p, newly significant (run-flush token + sign bit) when q == p and a
refinement bit when q > p, so every token's position in the stream is a
function of per-chunk plane histograms and one carry chain over the
(channel, level, plane) schedule.

Two kernels serve this stage besides the gather: the colour transform and
the lifting (``ops/lifting.py:forward_transform``, a launch a level), and
the per-chunk plane statistics (``ops/plane_stats.py:plane_stats``, two
launches); the rest of the statistics and the schedule are small eager
tensor work and one carry chain on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..geometry import Pyramid
from ..hilbert import padded_layout
from ..ops import compact
from ..ops.hilbert_gather import hilbert_gather
from ..ops.lifting import forward_transform
from ..ops.plane_stats import (PMAX, UNIT, _excl_cumsum, _ilog2, detail_q,
                               plane_stats, plane_tables_plain)

# Adaptive VLI order states (vli.h:67-84): enough for run lengths < 2^28.
NSTATE = 31
# Segment alignment of the scan-order layout (hilbert.padded_layout);
# 8 x compact.SUBA, so every unit starts on a whole row of packed elements,
# and a whole unit of the plane statistics' kernels.
ALIGN = 8192
assert ALIGN % UNIT == 0

_I32 = torch.int32


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
        # The plane statistics' kernels: each UNIT-element unit's chunk,
        # and each chunk's level start (a level-local index is a position
        # less it).
        self.unit_chunk_t = torch.as_tensor(
            np.repeat(np.arange(self.nchunk), [ln // UNIT for ln in ch_len]),
            dtype=_I32, device=self.device)
        self.chunk_base_t = torch.as_tensor(
            np.repeat(self.starts, lv_cnt), dtype=_I32, device=self.device)
        # The tables above as int32 tensors on the device, made once (a
        # host-to-device copy a call otherwise).
        t = functools.partial(torch.as_tensor, dtype=_I32, device=self.device)
        self.sizes_t = t(self.sizes)
        self.real_t = t(self.real)
        self.level_nchunk_t = t(self.level_nchunk)
        self.level_chunk_base_t = t(self.level_chunk_base)
        self.ch_start_t = t(self.ch_start)
        self.ch_len_t = t(self.ch_len)
        self.ch_valid_t = t(self.ch_valid)
        self.chunk_level_t = t(np.repeat(np.arange(self.L), lv_cnt))

    def bcast(self, small: torch.Tensor) -> torch.Tensor:
        """(C, L) per-segment values -> (C, n) per-element."""
        return torch.repeat_interleave(small, self.sizes_t, dim=1)

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
        """Exclusive cumsum over the chunk axis, restarting per level, of
        (..., nchunk, P)."""
        return torch.cat(
            [_excl_cumsum(x_ck[..., b : b + c, :], dim=-2)
             for b, c in zip(self.level_chunk_base, self.level_nchunk)],
            dim=-2)


@functools.lru_cache(maxsize=16)
def segs_for(pyr: Pyramid, device) -> _Segs:
    """The cached segmentation of ``pyr`` on ``device``."""
    return _Segs(pyr, device)


def _detail_q(lin, segs: _Segs):
    """(..., C, n) significance plane of each padded detail element of
    (..., C, nlin) ``lin`` (-1 = zero or pad), and the (1, n) validity
    mask."""
    return (detail_q(lin[..., segs.root_pad :], segs.valid_t),
            segs.valid_t[None, :])


def _plane_stats(q, valid, segs: _Segs, C: int, L: int, planes_max):
    """(C, L, PMAX) / (C, nchunk, PMAX) per-plane token statistics of the
    C rows of ``q`` (the frames' channels, flattened): the chunk tables of
    ``plane_tables_plain``, then :func:`_level_stats`.  Values at p >=
    planes_max differ from :func:`_plane_stats_loop`'s zeros only in slots
    every consumer masks."""
    del valid, planes_max, C, L  # pads are -1 in q already
    return _level_stats(*plane_tables_plain(
        q, segs.valid_t, segs.idx_local, segs.block_chunk, segs.nchunk),
        segs)


def _level_stats(nS_ck, lastS_ck, z0_ck, zup_ck, segs: _Segs):
    """(nS, nZ, trailZ, nS_ck, nZ_ck) from the chunk tables of
    :func:`plane_stats`.

    trailZ(c, l, p) — zeros after the level's last newly significant
    element (rle.h run threading) — decomposes because level-local indices
    are monotone across a level's chunks: the level's lastS lies in one
    chunk k*, so z_upto = sum_{k<k*} nZ_ck[k] + (chunk-local zeros at
    idx <= lastS)."""
    nZ_ck = z0_ck[..., None] + _excl_cumsum(nS_ck, dim=2)

    def lvl(x, red):
        return torch.stack(
            [red(x[:, b : b + c]) for b, c in
             zip(segs.level_chunk_base, segs.level_nchunk)], dim=1)

    nS = lvl(nS_ck, lambda s: s.sum(dim=1, dtype=_I32))
    nZ = lvl(nZ_ck, lambda s: s.sum(dim=1, dtype=_I32))
    lastS = lvl(lastS_ck, lambda s: s.amax(dim=1))  # (C, L, PMAX)
    lastS_cc = lastS[:, segs.chunk_level_t]  # (C, nchunk, PMAX)
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


def _check_planes(planes_max: int) -> int:
    """Magnitudes must stay below 2^29 (bits 29/30 are the sig/ref flags,
    encode.c:115-128): more planes cannot be coded by the format."""
    if planes_max > PMAX:
        raise ValueError(
            f"coefficient magnitude needs {planes_max} bitplanes; the format "
            f"supports at most {PMAX} (magnitudes < 2^29, reference "
            "encode.c:115-128)")
    return planes_max


def _transform_and_stats(imgs, pyr: Pyramid, channels: int, gray: bool,
                         src):
    """(N, H, W, C) frames (uint8, or any dtype that converts to int32) ->
    (lin, stats).  ``src``: the gather's source index (see
    :func:`gather_source`)."""
    coeff = forward_transform(imgs, pyr, not gray)
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
    """(N, H, W, C) coefficients -> (N, C, nlin) padded scan-order layout:
    the gather kernel places every frame's detail bands in one launch (pads
    stay 0), then the root bands are written as dense raster crops."""
    lin = hilbert_gather(coeff.contiguous(), src)
    n, h0, w0 = coeff.shape[0], pyr.heights[0], pyr.widths[0]
    lin[:, :, : h0 * w0] = coeff[:, :h0, :w0, :].reshape(
        n, h0 * w0, channels).transpose(1, 2)
    return lin


def _carry_chain(carry0, valid_s, nS_s, nZ_s, trailZ_s, nRef_s):
    """Zero-run carry chain over the schedule steps (rle.h cnt threading)
    of N frames, on the host: ``carry0`` (N,), the rest (N, S) in schedule
    order.  The chain has C * L * PMAX steps a frame, a few hundred to a
    few thousand, and is sequential.  Returns (N, 3, S) int32 carry_in,
    refrun_val and refrun_ok (0/1), and the (N,) carry at the end."""
    N, S = valid_s.shape
    out = np.zeros((N, 3, S), np.int32)
    ends = np.zeros(N, np.int32)
    for f in range(N):
        cin, rrv, rro = [], [], []
        carry = int(carry0[f])
        for v, s_cnt, z_cnt, t_z, r_cnt in zip(
                *(a[f].tolist() for a in (valid_s, nS_s, nZ_s, trailZ_s,
                                          nRef_s))):
            rv = t_z if s_cnt > 0 else carry + z_cnt
            cin.append(carry)
            rrv.append(rv)
            rro.append(v and r_cnt > 0 and rv > 0)
            if v:
                carry = 0 if r_cnt > 0 else rv
        out[f] = cin, rrv, rro
        ends[f] = carry
    return out, ends


def _stats_from_lin(lin, pyr: Pyramid, channels: int):
    """Stage-1 statistics of N frames from their (N, C, nlin) linearized
    coefficients: every leaf with a leading frame axis.  One
    device-to-host copy (the carry chain's inputs and each frame's
    planes_max, checked here by :func:`_check_planes`) and one
    host-to-device copy (the chain's results) for the N frames."""
    dev = lin.device
    N = lin.shape[0]
    pix0 = pyr.pixels[0]
    L, C = pyr.levels, channels
    S = C * L * PMAX
    segs = segs_for(pyr, dev)

    root = lin[:, :, :pix0]
    planes, *tables = plane_stats(
        lin.reshape(N * C, -1), segs.valid_t, segs.idx_local,
        segs.block_chunk, segs.unit_chunk_t, segs.chunk_base_t)
    planes = planes.reshape(N, C)
    planes_max = planes.amax(dim=1)  # (N,)

    nS, nZ, trailZ, nS_ck, nZ_ck = (
        x.reshape(N, C, *x.shape[1:]) for x in _level_stats(*tables, segs))
    pm = planes_max[:, None, None, None]
    p_ix = torch.arange(PMAX, dtype=_I32, device=dev)[None, None, None, :]
    nRef = torch.where(p_ix < pm, segs.real_t[None, None, :, None] - nZ - nS,
                       0)

    # --- schedule order over each frame's (C, L, PMAX) step grid ----------
    c_ix = torch.arange(C, dtype=_I32, device=dev)[None, :, None, None]
    l_ix = torch.arange(L, dtype=_I32, device=dev)[None, None, :, None]
    sec = (c_ix > 0).to(_I32)
    layers = torch.where(sec == 0, pm - 2 - p_ix + l_ix,
                         pm - 1 - p_ix + l_ix)
    valid = (p_ix < planes[:, :, None, None]).expand(N, C, L, PMAX)
    key = ((layers + 1) << 16) | (sec << 12) | (l_ix << 6) | c_ix
    key = torch.where(valid, key, 2**30).reshape(N, S)
    order = torch.argsort(key, dim=1, stable=True)  # schedule order of steps

    def sched(x):
        return x.reshape(N, S).gather(1, order)

    nS_s, nZ_s, trailZ_s, nRef_s = map(sched, (nS, nZ, trailZ, nRef))
    valid_s = sched(valid)

    # When planes_max == 0 the degenerate pre-step (plane index -1,
    # encode.c:190-194) contributes chunk 0's positions as pure zeros.
    host = torch.cat([x.to(_I32) for x in (
        valid_s, nS_s, nZ_s, trailZ_s, nRef_s, planes_max[:, None])],
        dim=1).cpu().numpy()
    pm_host = host[:, 5 * S]
    _check_planes(int(pm_host.max()))
    chain, carry_end = _carry_chain(
        np.where(pm_host == 0, segs.real[0], 0),
        *(host[:, k * S:(k + 1) * S] for k in range(5)))
    back = torch.as_tensor(np.concatenate(
        [chain.reshape(N, 3 * S), carry_end[:, None]], axis=1), device=dev)
    carry_in_s, refrun_val_s = back[:, :S], back[:, S:2 * S]
    refrun_ok_s = back[:, 2 * S:3 * S] != 0

    # --- token counts / bases ---------------------------------------------
    root_max = root.abs().amax(dim=2)
    root_cnt = torch.where(root_max > 0,
                           1 + _ilog2(root_max.clamp(min=1)), 0).to(_I32)
    nnz_root = (root != 0).sum(dim=2, dtype=_I32)
    root_tokens = (1 + torch.where(root_cnt > 0, pix0 + nnz_root, 0)).to(_I32)
    root_base = _excl_cumsum(root_tokens)
    planes_base = root_tokens.sum(dim=1, dtype=_I32)  # (N,)
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
    base_s = (steps_base0_al[:, None] + _excl_cumsum(cnt_al)).to(_I32)
    T = (steps_base0_al + cnt_al.sum(dim=1, dtype=_I32) + 1).to(_I32)  # flush
    # Refinement-bit injection site of a step: the next step's base.
    inj_pos_s = torch.cat([base_s[:, 1:], (T - 1)[:, None]], dim=1).to(_I32)
    nref_v = torch.where(valid_s, nRef_s, 0)
    refpfx_s = _excl_cumsum(nref_v).to(_I32)

    def unsort(x):
        out = torch.zeros((N, S), dtype=x.dtype, device=dev)
        return out.scatter_(1, order, x).reshape(N, C, L, PMAX)

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
        carry_end=back[:, 3 * S].contiguous(),
        T=T,
        order=order.to(_I32),
        nS_ck=nS_ck,
        nZ_ck=nZ_ck,
        # Schedule-ordered (N, S) step views for the token finisher and the
        # kernel metadata.
        base_sched=base_s,
        nS_sched=torch.where(valid_s, nS_s, 0),
        cin_sched=carry_in_s,
        valid_sched=valid_s,
    )


def frame(tree: dict, i: int) -> dict:
    """Frame ``i`` of batched stats (tensors or their numpy host copies):
    every leaf indexed on its leading axis (views)."""
    return {k: v[i] for k, v in tree.items()}


def one_frame(tree: dict) -> dict:
    """Single-frame stats as a batch of one (views)."""
    return {k: v[None] for k, v in tree.items()}
