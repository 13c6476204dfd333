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

Three kernels serve this stage besides the gather: the colour transform
and the lifting (``ops/lifting.py:forward_transform``, a launch a large
level and one for the coarse tail), the per-chunk plane statistics
(``ops/plane_stats.py:plane_stats``, one launch), and the level sums,
schedule order, carry chain and token bases (``ops/schedule.py:schedule``,
kernel 14, one launch of a cluster of blocks a frame).  Stage 1 then copies each frame's
planes_max and T to the host, in one copy, and makes no copy to the card.
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
from ..ops.schedule import OUT_KEYS, level_sums_plain, schedule

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
        # The level-exclusive scan of ch_valid over each level's chunks,
        # in wrapping int32 (kernel 17's closed-form refinement carry).
        self.vcar = tuple(
            (int(v) + 2**31) % 2**32 - 2**31
            for b, c in zip(lv_base, lv_cnt)
            for v in np.cumsum((0,) + self.ch_valid[b:b + c])[:-1])
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
        self.vcar_t = t(self.vcar)

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
    :func:`plane_stats`: the level sums of kernel 14's plain version
    (``ops/schedule.py:level_sums_plain``), which the tests hold to the
    JAX package's ``_plane_stats``."""
    nS, nZ, trailZ, nZ_ck, _, _ = level_sums_plain(
        nS_ck, lastS_ck, z0_ck, zup_ck, segs.level_chunk_base,
        segs.level_nchunk)
    return nS, nZ, trailZ, nS_ck, nZ_ck


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


def _stats_from_lin(lin, pyr: Pyramid, channels: int):
    """Stage-1 statistics of N frames from their (N, C, nlin) linearized
    coefficients: every leaf with a leading frame axis.  The plane
    statistics' kernel, then kernel 14 (:func:`schedule`), which writes
    every leaf on the device; then one device-to-host copy, each frame's
    planes_max and T (``T_host``, the token bucket's input), checked here
    by :func:`_check_planes`.  No host-to-device copy."""
    N = lin.shape[0]
    C = channels
    segs = segs_for(pyr, lin.device)
    planes, *tables = plane_stats(
        lin.reshape(N * C, -1), segs.valid_t, segs.idx_local,
        segs.block_chunk, segs.unit_chunk_t, segs.chunk_base_t)
    stats = dict(zip(OUT_KEYS, schedule(
        planes.reshape(N, C), *(t.reshape(N, C, *t.shape[1:]) for t in tables),
        lin[:, :, :pyr.pixels[0]], segs.real_t, segs.level_chunk_base_t,
        segs.level_nchunk_t)))
    host = stats.pop("head").cpu().numpy()
    _check_planes(int(host[0].max()))
    stats["T_host"] = host[1]
    return lin, stats


def frame(tree: dict, i: int) -> dict:
    """Frame ``i`` of batched stats (tensors or their numpy host copies):
    every leaf indexed on its leading axis (views)."""
    return {k: v[i] for k, v in tree.items()}


def one_frame(tree: dict) -> dict:
    """Single-frame stats as a batch of one (views)."""
    return {k: v[None] for k, v in tree.items()}
