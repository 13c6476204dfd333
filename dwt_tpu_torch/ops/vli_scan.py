"""The encoder's adaptive-VLI order scan (kernels ``csrc/vli_scan.cu``).

No TPU kernel to port: the JAX package runs the scan as XLA
(``dwt_tpu/codec/encoder.py:_vli_orders``, a ``lax.scan`` and an
``associative_scan``).  :func:`vli_orders` takes the transposed
transition parameters of ``codec/tokens.py:_vli_orders``, (TB, R) int32
with R = N * nblk block columns of TB tokens (frame f's blocks are
columns f * nblk .. f * nblk + nblk - 1), and returns each token's order
before its own transition, (TB, R) int8.  A token with x == 0 is a no-op;
otherwise a = (x - 1) & 31, b = ((x - 1) >> 5) & 31 and the order s
becomes clamp(max(s, a + (s >= b)) - 2, 0, 30) (vli.h:67-84).  Each
frame's first block enters in order 0.

On the card: three launches a call, whatever N and nblk are (the
blocks' transition maps with each segment's aggregate; the segments'
entry orders, a walk a frame; the replay).  On the CPU:
:func:`vli_orders_plain`, the same three passes as eager loops.
"""

from __future__ import annotations

import torch

from ..runtime import build
from ._launch import need, on_card

NSTATE = 31  # orders 0..30 (codec/stage1.py:NSTATE)
SEG = 256    # block columns a segment (csrc/vli_scan.cu: SEG)
MAP = 32     # bytes a block's map on the card: 31 orders and a spare


def _check(x: torch.Tensor, nblk: int) -> None:
    need("vli_orders x", x, torch.int32, 2)
    if nblk <= 0 or x.shape[1] % nblk:
        raise ValueError(f"vli_orders: {x.shape[1]} block columns are no "
                         f"whole number of frames of {nblk} blocks")


def vli_orders_plain(x: torch.Tensor, nblk: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`vli_orders`.

    Pass A runs each block column over all NSTATE entry orders at once (TB
    sequential steps, every block of every frame in parallel), giving its
    transition map; pass B composes each frame's maps with a log-depth
    inclusive scan (map composition is a gather), segmented by frame: a
    frame's first block enters in order 0 and no map composes across
    frames; pass C replays each block from its true entry order and
    records every token's order before its own transition."""
    _check(x, nblk)
    TB, R = x.shape
    N = R // nblk
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

    # Pass A: per-block transition map for every entry order.
    maps = torch.arange(NSTATE, dtype=torch.int8,
                        device=x.device)[None, :].repeat(R, 1)
    for t in range(TB):
        maps = apply1(maps, t)

    # Pass B: minc[f, i] maps the order entering frame f's block 0 to the
    # order leaving its block i (Hillis-Steele: apply the earlier map
    # first).
    minc = maps.long().reshape(N, nblk, NSTATE)
    d = 1
    while d < nblk:
        nxt = minc.clone()
        nxt[:, d:] = torch.gather(minc[:, d:], 2, minc[:, :-d])
        minc = nxt
        d *= 2
    entry = torch.cat([torch.zeros((N, 1), dtype=torch.int8,
                                   device=x.device),
                       minc[:, :-1, 0].to(torch.int8)], dim=1).reshape(-1)

    # Pass C: replay from the true entry orders.
    orders = torch.empty((TB, R), dtype=torch.int8, device=x.device)
    s = entry
    for t in range(TB):
        orders[t] = s
        s = apply1(s, t)
    return orders


def vli_orders(x: torch.Tensor, nblk: int) -> torch.Tensor:
    """(TB, N * nblk) int32 transition parameters -> (TB, N * nblk) int8
    orders.  On the card three launches (``launches`` grows by 3)."""
    _check(x, nblk)
    if not on_card("vli_orders", x):
        return vli_orders_plain(x, nblk)
    TB, R = x.shape
    out = torch.empty((TB, R), dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return out
    N = R // nblk
    nagg = N * -(-nblk // SEG)
    maps = torch.empty((R, MAP), dtype=torch.uint8, device=x.device)
    agg = torch.empty((nagg, MAP), dtype=torch.uint8, device=x.device)
    seg_in = torch.empty(nagg, dtype=torch.uint8, device=x.device)
    lib, stream = build.library(), build.stream_of(x)
    build.check(lib.dwt_vli_maps(x.data_ptr(), maps.data_ptr(),
                                 agg.data_ptr(), TB, R, nblk, stream),
                "vli_orders maps")
    vli_orders.launches += 1
    build.check(lib.dwt_vli_entry(agg.data_ptr(), seg_in.data_ptr(), N,
                                  nblk, stream), "vli_orders entry")
    vli_orders.launches += 1
    build.check(lib.dwt_vli_replay(x.data_ptr(), maps.data_ptr(),
                                   seg_in.data_ptr(), out.data_ptr(), TB, R,
                                   nblk, stream), "vli_orders replay")
    vli_orders.launches += 1
    return out


vli_orders.launches = 0
