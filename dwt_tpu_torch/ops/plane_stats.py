"""The encoder's per-chunk plane statistics (kernels ``csrc/plane_stats.cu``).

No TPU kernel to port: the JAX package computes them as XLA
(``dwt_tpu/codec/encoder.py:_plane_stats``, one-hot passes over the
planes).  :func:`plane_stats` takes R rows of linearized coefficients
(R, nlin) int32, whose last n elements are the detail axis, with the
detail axis' tables (``codec/stage1.py:_Segs``): the (n,) pad mask, each
element's level-local index and 512-element block's chunk, each
``UNIT``-element unit's chunk and each chunk's level start.  A valid
element's plane q is the top set bit of its magnitude, -1 for a zero.  It
returns, per row and chunk: ``planes`` (R,) one more than the row's
largest q (0 for zeros only); ``nS_ck`` (R, nchunk, PMAX) the elements at
plane p; ``lastS_ck`` the largest level-local index at plane p (-1:
none); ``z0_ck`` (R, nchunk) the zeros; ``zup_ck`` (R, nchunk, PMAX) the
elements with q < p at an index up to ``lastS_ck`` of the same plane.

On the card one launch a call (``plane_stats_kernel``: a block a chunk
and row, the chunk's planes as bytes and each 512-element block's
cumulative plane counts in shared memory, then a warp a plane for the
chunk's tables; the blocks of a chunk are adjacent, so its other rows
find the mask in L2).  On the CPU: :func:`plane_stats_plain`, the
one-hot passes.
"""

from __future__ import annotations

import torch

from ..runtime import build
from . import compact
from ._launch import need, on_card

# Bitplane bound of the format: magnitudes stay below 2^29 because bits
# 29/30 are the reference's sig/ref coding flags (encode.c:115-128).
PMAX = 29
UNIT = 8192   # detail elements a unit of the chunk tables (stage1.py:ALIGN)
CHUNK_UNITS = 8  # units a chunk at most in the kernel's shared memory
GP = 8        # planes a one-hot pass of the plain version: bounds temporaries

_I32 = torch.int32


def _ilog2(x: torch.Tensor) -> torch.Tensor:
    """Floor log2 for x > 0 as int32 (garbage for x <= 0: mask at the call
    sites).  Exact: an integer below 2^53 converts to float64 exactly, and
    the exponent field of the float is its floor log2."""
    return ((x.to(torch.float64).view(torch.int64) >> 52) - 1023).to(_I32)


def detail_q(det: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., n) significance plane of each detail element (MSB index of
    |x|; -1 for a zero or a pad)."""
    mag = det.abs()
    return torch.where((mag > 0) & valid, _ilog2(mag), -1)


def _excl_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive cumsum that keeps int32 (torch's int32 cumsum is int64)."""
    return (torch.cumsum(x, dim=dim) - x).to(x.dtype)


def plane_tables_plain(q, valid, idx_local, block_chunk, nchunk: int):
    """(nS_ck, lastS_ck, z0_ck, zup_ck) of the (R, n) planes ``q`` in three
    fused one-hot passes: per-512-block plane histograms, last-significant
    positions and boundary-prefix zero counts, added into their chunks."""
    R, dev = q.shape[0], q.device
    nb = q.shape[1] // 512
    qb = q.reshape(R, nb, 512)
    validb = valid.reshape(1, nb, 512)
    idxb = idx_local.reshape(1, nb, 512)
    p_all = torch.arange(PMAX, dtype=_I32, device=dev)
    ids = block_chunk

    z0_b = ((qb == -1) & validb).sum(dim=2, dtype=_I32)  # (R, nb)
    hist_p, last_p = [], []
    for g0 in range(0, PMAX, GP):
        oh = qb[..., None] == p_all[g0 : g0 + GP]
        hist_p.append(oh.sum(dim=2, dtype=_I32))
        last_p.append(torch.where(oh, idxb[..., None], -1).amax(dim=2))
    hist_b = torch.cat(hist_p, dim=-1)  # (R, nb, PMAX)
    lastS_b = torch.cat(last_p, dim=-1)

    def zeros_ckp():
        return torch.zeros((R, nchunk, PMAX), dtype=_I32, device=dev)

    nS_ck = zeros_ckp().index_add_(1, ids, hist_b)
    lastS_ck = torch.full((R, nchunk, PMAX), -1, dtype=_I32,
                          device=dev).scatter_reduce_(
        1, ids[None, :, None].expand(R, nb, PMAX), lastS_b, "amax")
    z0_ck = torch.zeros((R, nchunk), dtype=_I32,
                        device=dev).index_add_(1, ids, z0_b)

    # Chunk-local boundary-prefix zeros: zeros at idx <= the chunk's own
    # last-significant position, per plane.
    lastS_bc = lastS_ck[:, ids]  # (R, nb, PMAX)
    qzb = torch.where(validb, qb, 2**30)
    zup_p = []
    for g0 in range(0, PMAX, GP):
        m = ((qzb[..., None] < p_all[g0 : g0 + GP])
             & (idxb[..., None] <= lastS_bc[:, :, None, g0 : g0 + GP]))
        zup_p.append(m.sum(dim=2, dtype=_I32))
    zup_ck = zeros_ckp().index_add_(1, ids, torch.cat(zup_p, dim=-1))
    return nS_ck, lastS_ck, z0_ck, zup_ck


def _check(lin, valid, idx_local, block_chunk):
    need("plane_stats lin", lin, _I32, 2)
    need("plane_stats valid", valid, torch.bool, 1)
    n = valid.numel()
    if (n % 512 or lin.shape[1] < n or idx_local.numel() != n
            or block_chunk.numel() != n // 512):
        raise ValueError(
            f"plane_stats: a detail axis of {n} elements (a multiple of 512) "
            f"in rows of {lin.shape[1]}, with {idx_local.numel()} indices "
            f"and {block_chunk.numel()} blocks, does not fit")


def _check_units(lin, valid, unit_chunk, chunk_base):
    """The kernel's tables: every chunk a whole number of units (as the
    scan-order layout's ALIGN gives them), at most ``CHUNK_UNITS`` of them
    (``compact.E`` elements, as ``stage1._Segs`` cuts them), 16-byte
    rows."""
    need("plane_stats unit_chunk", unit_chunk, _I32, 1)
    need("plane_stats chunk_base", chunk_base, _I32, 1)
    n, nchunk = valid.numel(), chunk_base.numel()
    if compact.E > CHUNK_UNITS * UNIT:
        raise ValueError(
            f"plane_stats: chunks of up to compact.E = {compact.E} elements "
            f"exceed the kernel's {CHUNK_UNITS} units of {UNIT}")
    if (n % UNIT or lin.shape[1] % 4 or unit_chunk.numel() != n // UNIT
            or not nchunk <= n // UNIT <= CHUNK_UNITS * nchunk):
        raise ValueError(
            f"plane_stats: the kernel takes chunks of 1 to {CHUNK_UNITS} "
            f"whole {UNIT}-element units; a detail axis of {n} elements in "
            f"rows of {lin.shape[1]} has {unit_chunk.numel()} units for "
            f"{nchunk} chunks")
    if lin.data_ptr() % 16 or valid.data_ptr() % 16:
        raise ValueError("plane_stats: the kernel reads lin and valid in "
                         "16-byte words: their storage must start on one")


def plane_stats_plain(lin, valid, idx_local, block_chunk, unit_chunk,
                      chunk_base) -> tuple:
    """Plain PyTorch version of :func:`plane_stats` (it reads neither
    ``unit_chunk`` nor ``chunk_base`` but their count)."""
    _check(lin, valid, idx_local, block_chunk)
    q = detail_q(lin[:, lin.shape[1] - valid.numel():], valid)
    planes = (1 + q.amax(dim=1)).to(_I32)
    return (planes, *plane_tables_plain(q, valid, idx_local, block_chunk,
                                        chunk_base.numel()))


def plane_stats(lin, valid, idx_local, block_chunk, unit_chunk,
                chunk_base) -> tuple:
    """(R, nlin) int32 linearized coefficients -> (planes, nS_ck, lastS_ck,
    z0_ck, zup_ck), int32.  On the card one launch (``launches`` grows by
    1); the kernel computes the level-local index from ``chunk_base`` and
    reads neither ``idx_local`` nor ``block_chunk``."""
    _check(lin, valid, idx_local, block_chunk)
    if not on_card("plane_stats", lin, valid, unit_chunk, chunk_base):
        return plane_stats_plain(lin, valid, idx_local, block_chunk,
                                 unit_chunk, chunk_base)
    _check_units(lin, valid, unit_chunk, chunk_base)
    R, nlin = lin.shape
    n, nchunk = valid.numel(), chunk_base.numel()
    # One zeroed buffer for every table: nS, lastS, zup, z0, planes (the
    # kernel writes every slot but the planes' atomic maxima).
    tk = R * nchunk * PMAX
    tab = torch.zeros(3 * tk + R * nchunk + R, dtype=_I32, device=lin.device)
    nS, lastS, zup = (tab[i * tk:(i + 1) * tk].view(R, nchunk, PMAX)
                      for i in range(3))
    z0 = tab[3 * tk:3 * tk + R * nchunk].view(R, nchunk)
    planes = tab[3 * tk + R * nchunk:]
    lib = build.library()
    build.check(lib.dwt_plane_stats(
        lin.data_ptr(), valid.data_ptr(), unit_chunk.data_ptr(),
        chunk_base.data_ptr(), nS.data_ptr(), lastS.data_ptr(),
        z0.data_ptr(), zup.data_ptr(), planes.data_ptr(), R, nlin, n,
        nchunk, build.stream_of(lin)),
        "plane_stats")
    plane_stats.launches += 1
    return planes, nS, lastS, z0, zup


plane_stats.launches = 0
