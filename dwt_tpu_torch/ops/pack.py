"""Codeword packing (kernel ``csrc/pack.cu``).

Port of ``dwt_tpu/ops/pallas_pack.py:pack_words_pallas``: adds each
token's <= 3 uint32 codeword pieces c0, c1, c2 into stream words widx,
widx + 1, widx + 2 (mod 2^32).  Words and pieces are int32 tensors that
hold uint32 bit patterns: ``torch.uint32`` has no add or scatter.  widx
must be nondecreasing, as the TPU kernel requires: the CUDA kernel gives
each tile of tokens the words between its edges to store alone.  The
kernel checks the order itself and sets a device flag, which the wrapper
reads, or leaves to a caller that copies it to the host with other data
(``order_flag``, :func:`check_order`).
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


def check_order(flag) -> None:
    """Raise unless the order flag of :func:`pack_words` (a tensor or its
    host copy) is 0."""
    if int(flag.reshape(-1)[0]):
        raise ValueError("pack_words: widx must be nondecreasing")


def launch(widx, c0, c1, c2, words, flag) -> None:
    """The kernel alone: adds the pieces into ``words`` (zeroed by the
    caller) and sets ``flag`` to 1 if widx decreases anywhere."""
    lib = build.library()
    build.check(lib.dwt_pack_words(widx.data_ptr(), c0.data_ptr(),
                                   c1.data_ptr(), c2.data_ptr(),
                                   words.data_ptr(), flag.data_ptr(),
                                   widx.shape[0], words.shape[0],
                                   build.stream_of(widx)),
                "pack_words")


def pack_words(widx: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor,
               c2: torch.Tensor, nwords: int,
               order_flag: torch.Tensor | None = None) -> torch.Tensor:
    """(nwords,) int32 stream words from (n,) int32 word indices and
    pieces.  Pieces whose word falls outside [0, nwords) are dropped.
    ``widx`` must be nondecreasing.  Without ``order_flag`` the wrapper
    raises otherwise (on the card after reading the kernel's flag: one
    host sync).  With it (a (1,) int32 tensor on widx's device), a
    decrease sets it to 1 and nothing is read: the caller passes it to
    :func:`check_order` later."""
    for name, t in (("widx", widx), ("c0", c0), ("c1", c1), ("c2", c2)):
        need(f"pack_words {name}", t, torch.int32, 1)
        if t.shape != widx.shape:
            raise ValueError("pack_words: widx, c0, c1, c2 differ in shape")
    flags = () if order_flag is None else (order_flag,)
    for t in flags:
        need("pack_words order_flag", t, torch.int32, 1)
    if not on_card("pack_words", widx, c0, c1, c2, *flags):
        if widx.numel() > 1 and bool((widx[1:] < widx[:-1]).any()):
            if order_flag is None:
                raise ValueError("pack_words: widx must be nondecreasing")
            order_flag.fill_(1)
        return pack_words_plain(widx, c0, c1, c2, nwords)
    words = torch.zeros(nwords, dtype=torch.int32, device=widx.device)
    flag = order_flag
    if flag is None:
        flag = torch.zeros(1, dtype=torch.int32, device=widx.device)
    launch(widx, c0, c1, c2, words, flag)
    if order_flag is None:
        check_order(flag)
    pack_words.launches += 1
    return words


pack_words.launches = 0
