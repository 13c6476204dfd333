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
* Kernel B (:func:`scatter_refbits`): the j-th refined element adds its
  plane bit ``sh & 1`` at stream bit ``32 * col3 + col4 + j``.
"""

from __future__ import annotations

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
                         npairs: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`compact_tokens`."""
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


def compact_tokens(vmag: torch.Tensor, meta: torch.Tensor,
                   npairs: int) -> torch.Tensor:
    """Kernel A: significance-token pair values into a new (npairs,)
    int32 buffer (zero where no pair lands).  ``vmag``: (NR, SUBA) int32
    packed rows with at least E elements past every unit's start; ``meta``:
    (U, 8) int32."""
    need("compact_tokens vmag", vmag, torch.int32, 2)
    need("compact_tokens meta", meta, torch.int32, 2)
    if vmag.shape[1] != SUBA or meta.shape[1] != 8:
        raise ValueError("compact_tokens: vmag must be (NR, SUBA), meta (U, 8)")
    if not on_card("compact_tokens", vmag, meta):
        return compact_tokens_plain(vmag, meta, npairs)
    out = torch.zeros(npairs, dtype=torch.int32, device=vmag.device)
    lib = build.library()
    build.check(lib.dwt_compact_tokens(vmag.data_ptr(), meta.data_ptr(),
                                       out.data_ptr(), meta.shape[0], SUBA,
                                       E, npairs, build.stream_of(vmag)),
                "compact_tokens")
    compact_tokens.launches += 1
    return out


compact_tokens.launches = 0


def scatter_refbits_plain(vmag: torch.Tensor, meta: torch.Tensor,
                          words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_refbits` (in place)."""
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


def scatter_refbits(vmag: torch.Tensor, meta: torch.Tensor,
                    words: torch.Tensor) -> torch.Tensor:
    """Kernel B: add every refinement bit into ``words`` in place and
    return it.  ``words``: (nwords,) int32 holding uint32 bit patterns."""
    need("scatter_refbits vmag", vmag, torch.int32, 2)
    need("scatter_refbits meta", meta, torch.int32, 2)
    need("scatter_refbits words", words, torch.int32, 1)
    if vmag.shape[1] != SUBB or meta.shape[1] != 8:
        raise ValueError("scatter_refbits: vmag must be (NR, SUBB), meta (U, 8)")
    if not on_card("scatter_refbits", vmag, meta, words):
        return scatter_refbits_plain(vmag, meta, words)
    lib = build.library()
    build.check(lib.dwt_scatter_refbits(vmag.data_ptr(), meta.data_ptr(),
                                        words.data_ptr(), meta.shape[0],
                                        SUBB, E, words.shape[0],
                                        build.stream_of(vmag)),
                "scatter_refbits")
    scatter_refbits.launches += 1
    return words


scatter_refbits.launches = 0
