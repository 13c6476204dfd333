"""Codeword packing (kernel ``csrc/pack.cu``).

Port of ``dwt_tpu/ops/pallas_pack.py:pack_words_pallas``: adds each
token's <= 3 uint32 codeword pieces c0, c1, c2 into stream words widx,
widx + 1, widx + 2 (mod 2^32).  Words and pieces are int32 tensors that
hold uint32 bit patterns: ``torch.uint32`` has no add or scatter.  widx
must be nondecreasing, as the TPU kernel requires: the CUDA kernel sums
the pieces of a warp's run of equal words before its atomics.
"""

from __future__ import annotations

import torch

from ..runtime import build
from ._launch import need, on_card

# Equal to dwt_tpu.ops.pallas_pack's: the token buckets and step bases
# are padded to BLOCKN, and the stream buffer keeps the TPU kernel's
# window slack, so every intermediate compares one to one with the JAX
# package's (tests shrink BLOCKN in both).
BLOCKN = 2048
KGRP = 4


def _win() -> int:
    return KGRP * 2 * BLOCKN + 256


def _win1() -> int:
    return 2 * BLOCKN + 256


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.long() & 0xFFFFFFFF


def pack_words_plain(widx, c0, c1, c2, nwords: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pack_words`."""
    acc = torch.zeros(nwords + 2, dtype=torch.int64, device=widx.device)
    w = widx.long()
    ok = (w >= 0) & (w < nwords)
    for k, c in enumerate((c0, c1, c2)):
        acc.index_add_(0, torch.where(ok, w + k, nwords + 1),
                       torch.where(ok, _u32(c), 0))
    acc = acc[:nwords] & 0xFFFFFFFF
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


def pack_words(widx: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor,
               c2: torch.Tensor, nwords: int) -> torch.Tensor:
    """(nwords,) int32 stream words from (n,) int32 word indices and
    pieces.  Pieces whose word falls outside [0, nwords) are dropped.
    ``widx`` must be nondecreasing (checked on every device: one pass over
    widx and a host sync)."""
    for name, t in (("widx", widx), ("c0", c0), ("c1", c1), ("c2", c2)):
        need(f"pack_words {name}", t, torch.int32, 1)
        if t.shape != widx.shape:
            raise ValueError("pack_words: widx, c0, c1, c2 differ in shape")
    card = on_card("pack_words", widx, c0, c1, c2)
    if widx.numel() > 1 and bool((widx[1:] < widx[:-1]).any()):
        raise ValueError("pack_words: widx must be nondecreasing")
    if not card:
        return pack_words_plain(widx, c0, c1, c2, nwords)
    words = torch.zeros(nwords, dtype=torch.int32, device=widx.device)
    lib = build.library()
    build.check(lib.dwt_pack_words(widx.data_ptr(), c0.data_ptr(),
                                   c1.data_ptr(), c2.data_ptr(),
                                   words.data_ptr(), widx.shape[0], nwords,
                                   build.stream_of(widx)),
                "pack_words")
    pack_words.launches += 1
    return words


pack_words.launches = 0
