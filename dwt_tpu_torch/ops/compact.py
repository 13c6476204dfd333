"""Bitplane compaction kernels A and B (kernels ``csrc/compact.cu``).

Port of ``dwt_tpu/ops/pallas_compact.py``.  Both walk UNITS, one per
(schedule step, E-element chunk) row of an (U, 8) int32 metadata table:

  0: first element row of ``vmag``  1: valid elements  2: plane p
  3: window start                   4: output offset from the window start
  5: zero-run carry (A)             6: output count (0 = skip)  7: unused

``vmag`` rows hold packed elements (bits 0-29 ``|coeff|``, bit 30 sign,
-1 = padding).  At plane p an element with ``sh = |coeff| >> p`` is a zero
(sh == 0), newly significant (sh == 1) or refined (sh > 1).  A unit writes
only its first col-6 outputs; outputs outside the buffer are dropped.

* Kernel A (:func:`compact_tokens`): the j-th newly significant element
  of a unit gets the pair value ``(zero-prefix << 1) | sign`` at pair slot
  ``col3 + col4 + j`` (zero-prefix = col5 + zeros before it in the unit).
  The CUDA version is chunk-major: a (G, P) unit table (:func:`unit_table`,
  or the encoder's from ``ops/units.py``, kernel 15) groups the units that
  share a chunk of elements, slot q holding the meta row of plane q (-1:
  none), and two launches over G chunks x SUBLEN-element sub-ranges count
  and then place, reading each element once a launch for all its planes.
* Kernel B (:func:`scatter_refbits`): the j-th refined element adds its
  plane bit ``sh & 1`` at stream bit ``32 * col3 + col4 + j``.  The CUDA
  version is chunk-major over the same table: an element of key b is
  refined at the planes below b - 1, so its rank is a count of earlier
  keys above p + 1 from the same histograms (the encoder passes kernel
  A's), and one launch reads each element once for all its planes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import build
from ._launch import need, on_card

# Equal to dwt_tpu.ops.pallas_compact's, so the unit metadata compares
# one to one with the JAX package's (tests shrink them together).
E = 65536        # elements per unit chunk
SUBA = 1024      # row width of the packed elements (kernel A)
SUBB = 1024      # the same rows, read by kernel B
WTOK_BIG = E + 256        # pair-buffer slack past the last pair
WREF = E // 32 + 256      # word-window size bounding kernel B's windows
MAGMASK = (1 << 30) - 1
SUBLEN = 4096    # elements of a sub-range of kernel A (csrc/compact.cu)
HROWS = 9        # its histogram rows: the sub-range's, one a warp
PLANES = 30      # planes that can hold a newly significant element
NBIN = 32        # key bins of kernel A's histograms

_UNITS = 256  # units per batch of the plain versions (bounds their memory)


def _unit_elements(vmag, meta, sub):
    """Plain-version helper: for each batch of units that have outputs,
    yields (their int64 meta rows, their elements as (units, width) with
    -1 past each unit's valid length)."""
    flat = vmag.reshape(-1)
    live = torch.nonzero(meta[:, 6] > 0).reshape(-1)
    for i in range(0, live.numel(), _UNITS):
        m = meta[live[i:i + _UNITS]].long()
        ln = m[:, 1:2].clamp(0, E)
        ar = torch.arange(int(ln.max()), device=vmag.device)[None, :]
        idx = (m[:, :1] * sub + ar).clamp(0, flat.numel() - 1)
        yield m, torch.where(ar < ln, flat[idx], -1)


def _excl(mask):
    c = torch.cumsum(mask.long(), dim=1)
    return c - mask.long()


def compact_tokens_plain(vmag: torch.Tensor, meta: torch.Tensor,
                         npairs: int, table=None, hist=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`compact_tokens` (``table`` and
    ``hist`` are accepted for the same signature and not needed)."""
    out = torch.zeros(npairs, dtype=torch.int32, device=vmag.device)
    for m, v in _unit_elements(vmag, meta, SUBA):
        sh = (v & MAGMASK) >> m[:, 2:3]
        mS = (v >= 0) & (sh == 1)
        mZ = (v >= 0) & (sh == 0)
        rank = _excl(mS)
        zpfx = m[:, 5:6] + _excl(mZ)
        slot = m[:, 3:4] + m[:, 4:5] + rank
        keep = mS & (rank < m[:, 6:7]) & (slot >= 0) & (slot < npairs)
        val = (zpfx << 1) | ((v >> 30) & 1)
        out[slot[keep]] = val[keep].to(torch.int32)
    return out


def unit_table(meta: torch.Tensor) -> torch.Tensor:
    """(G, PLANES) int32 unit table of the live units of ``meta`` (col 6 >
    0, a valid length > 0, a plane below PLANES): the units with one first
    row and valid length form a group, slot q holds the row of plane q,
    and a second unit of the same group and plane opens another group.
    Groups are ordered by first row.  Built on the host (one copy of
    ``meta``); the encoder builds its table on the device instead."""
    m = meta.cpu().numpy().astype(np.int64)
    ln = np.minimum(m[:, 1], E)
    rows = np.nonzero((m[:, 6] > 0) & (ln > 0) & (m[:, 2] < PLANES))[0]
    if (m[rows, 2] < 0).any():
        raise ValueError("compact_tokens: a live unit has a negative plane")
    k0, k1, p = m[rows, 0], ln[rows], m[rows, 2]
    o = np.lexsort((rows, p, k1, k0))
    rows, k0, k1, p = rows[o], k0[o], k1[o], p[o]
    n = rows.shape[0]
    new = np.ones(n, bool)
    new[1:] = (k0[1:] != k0[:-1]) | (k1[1:] != k1[:-1]) | (p[1:] != p[:-1])
    dup = np.arange(n) - np.maximum.accumulate(np.where(new, np.arange(n), 0))
    keys, gid = np.unique(np.stack([k0, k1, dup], 1), axis=0,
                          return_inverse=True)
    table = np.full((keys.shape[0], PLANES), -1, np.int32)
    table[gid.reshape(-1), p] = rows
    return torch.as_tensor(table, device=meta.device)


def _hist_shape(table):
    return (table.shape[0], -(-E // SUBLEN), HROWS, NBIN)


def hist_for(table: torch.Tensor) -> torch.Tensor:
    """Scratch for the histograms of the count launch (kernels A and B)."""
    return torch.empty(_hist_shape(table), dtype=torch.int32,
                       device=table.device)


def count(vmag, meta, table, hist) -> None:
    """The count launch of kernels A and B: each sub-range's key
    histograms into ``hist`` (:func:`hist_for`), for the groups of
    ``table`` that have a live unit in ``meta``."""
    lib = build.library()
    build.check(lib.dwt_compact_count(
        vmag.data_ptr(), meta.data_ptr(), table.data_ptr(), hist.data_ptr(),
        table.shape[0], table.shape[1], meta.shape[0], vmag.shape[1], E,
        hist.shape[1], build.stream_of(vmag)), "compact (count)")


def place(vmag, meta, table, hist, out) -> None:
    """Kernel A's place launch: every pair into ``out`` (zeroed)."""
    lib = build.library()
    build.check(lib.dwt_compact_place(
        vmag.data_ptr(), meta.data_ptr(), table.data_ptr(), hist.data_ptr(),
        out.data_ptr(), table.shape[0], table.shape[1], meta.shape[0], SUBA,
        E, hist.shape[1], out.shape[0], build.stream_of(vmag)),
        "compact_tokens (place)")


def _check_table(name, table, hist):
    if table is not None:
        need(f"{name} table", table, torch.int32, 2)
        if table.shape[1] > PLANES:
            raise ValueError(f"{name}: the table has more than {PLANES} "
                             "planes")
    if hist is not None:
        if table is None:
            raise ValueError(f"{name}: hist needs the table it was made for")
        need(f"{name} hist", hist, torch.int32, 4)
        if hist.shape != _hist_shape(table):
            raise ValueError(f"{name}: hist does not fit the table")
    return tuple(t for t in (table, hist) if t is not None)


def compact_tokens(vmag: torch.Tensor, meta: torch.Tensor, npairs: int,
                   table: torch.Tensor | None = None,
                   hist: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel A: significance-token pair values into a new (npairs,)
    int32 buffer (zero where no pair lands).  ``vmag``: (NR, SUBA) int32
    packed rows with at least E elements past every unit's start; ``meta``:
    (U, 8) int32; ``table``: the (G, P <= PLANES) int32 unit table of the
    CUDA kernel, whose groups' live units share a first row and valid
    length, slot q of plane q (built by :func:`unit_table` when not
    given).  The table does not change the function.  ``hist``: the count
    launch's scratch (:func:`hist_for` of ``table``), given to keep the
    histograms for kernel B; on CPU tensors it is left as it is."""
    need("compact_tokens vmag", vmag, torch.int32, 2)
    need("compact_tokens meta", meta, torch.int32, 2)
    if vmag.shape[1] != SUBA or meta.shape[1] != 8:
        raise ValueError("compact_tokens: vmag must be (NR, SUBA), meta (U, 8)")
    extra = _check_table("compact_tokens", table, hist)
    if not on_card("compact_tokens", vmag, meta, *extra):
        return compact_tokens_plain(vmag, meta, npairs)
    if table is None:
        table = unit_table(meta)
    out = torch.zeros(npairs, dtype=torch.int32, device=vmag.device)
    if hist is None:
        hist = hist_for(table)
    count(vmag, meta, table, hist)
    place(vmag, meta, table, hist, out)
    compact_tokens.launches += 1
    return out


compact_tokens.launches = 0


def scatter_refbits_plain(vmag: torch.Tensor, meta: torch.Tensor,
                          words: torch.Tensor, table=None,
                          hist=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_refbits` (in place;
    ``table`` and ``hist`` are accepted for the same signature and not
    needed)."""
    nwords = words.shape[0]
    acc = words.long() & 0xFFFFFFFF
    for m, v in _unit_elements(vmag, meta, SUBB):
        sh = (v & MAGMASK) >> m[:, 2:3]
        mR = (v >= 0) & (sh > 1)
        rank = _excl(mR)
        bit = 32 * m[:, 3:4] + m[:, 4:5] + rank
        w = bit >> 5
        keep = mR & (rank < m[:, 6:7]) & ((sh & 1) == 1) & (w >= 0) \
            & (w < nwords)
        acc.index_add_(0, w[keep], 1 << (bit[keep] & 31))
    acc &= 0xFFFFFFFF
    words.copy_(torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32))
    return words


def scatter(vmag, meta, table, hist, words) -> None:
    """Kernel B's scatter launch: every refinement bit into ``words``, with
    the key histograms of :func:`count` in ``hist``."""
    lib = build.library()
    build.check(lib.dwt_refbits_scatter(
        vmag.data_ptr(), meta.data_ptr(), table.data_ptr(), hist.data_ptr(),
        words.data_ptr(), table.shape[0], table.shape[1], meta.shape[0],
        SUBB, E, hist.shape[1], words.shape[0], build.stream_of(vmag)),
        "scatter_refbits")


def scatter_refbits(vmag: torch.Tensor, meta: torch.Tensor,
                    words: torch.Tensor, table: torch.Tensor | None = None,
                    hist: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel B: add every refinement bit into ``words`` in place and
    return it.  ``words``: (nwords,) int32 holding uint32 bit patterns.
    ``table`` as in :func:`compact_tokens` (built by :func:`unit_table`
    when not given; it does not change the function).  ``hist``: key
    histograms of ``vmag`` counted over ``table`` for every group with a
    live unit in ``meta`` (the encoder passes those of kernel A's count
    launch, which counted every such group); without it the wrapper runs
    the count launch first.  The CUDA kernel adds the words strictly
    inside a unit's bit range with plain stores, so the live units' bit
    ranges must be disjoint, as the encoder's are."""
    need("scatter_refbits vmag", vmag, torch.int32, 2)
    need("scatter_refbits meta", meta, torch.int32, 2)
    need("scatter_refbits words", words, torch.int32, 1)
    if vmag.shape[1] != SUBB or meta.shape[1] != 8:
        raise ValueError("scatter_refbits: vmag must be (NR, SUBB), meta (U, 8)")
    extra = _check_table("scatter_refbits", table, hist)
    if not on_card("scatter_refbits", vmag, meta, words, *extra):
        return scatter_refbits_plain(vmag, meta, words)
    if table is None:
        table = unit_table(meta)
    if hist is None:
        hist = hist_for(table)
        count(vmag, meta, table, hist)
    scatter(vmag, meta, table, hist, words)
    scatter_refbits.launches += 1
    return words


scatter_refbits.launches = 0
