"""The encoder's adaptive-VLI order scan (kernel ``csrc/vli_scan.cu``).

No TPU kernel to port: the JAX package runs the whole of
``dwt_tpu/codec/encoder.py:_vli_orders`` as XLA (``_vli_ab``, a
``lax.scan`` and an ``associative_scan``).  :func:`vli_orders` is its
counterpart: the (N, T) int32 token values and bool VLI flags of
``codec/tokens.py:_finish_tokens``, read in place (rows of unit stride at
any row stride), in; each token's order before its own transition,
(N, T) int32, out.  A VLI token of value v has A = ilog2(v) and
B = ceil_log2(2^(A+1) - v) and takes order s to
clamp(max(s, A + (s >= B)) - 2, 0, 30); another token leaves it
(vli.h:67-84).  Each frame starts in order 0; no order carries from one
frame to the next.

On the card: one launch a call, whatever N and T are.  The kernel keeps
a ticket and a status word a tile in a scratch of :data:`MAX_TILES` tiles
(4.7 MB) a device and stream, zeroed once when it is made (its one fill)
and left zeroed by each call's last block.  On the CPU:
:func:`vli_orders_plain`, the parent algorithm as eager passes.
"""

from __future__ import annotations

import torch

from ..runtime import build
from ._launch import need

NSTATE = 31     # orders 0..30 (codec/stage1.py:NSTATE)
THREADS = 128   # threads a tile (csrc/vli_scan.cu: THREADS)
SPAN = 128      # tokens a thread's row (csrc/vli_scan.cu: SPAN)
TILE = THREADS * SPAN
# Tiles the scratch holds at first: every call that stays within the
# encoder's int32 token slots (2^31 a sub-batch) fits.
MAX_TILES = 2**31 // TILE

_scratch: dict = {}  # (device index, stream) -> zeroed uint8 scratch


def _check(tok_val: torch.Tensor, tok_vli: torch.Tensor) -> bool:
    """True when both tensors lie on one CUDA device, False when both lie
    on the CPU; raises on anything the kernel does not take."""
    need("vli_orders tok_val", tok_val, torch.int32, 2)
    need("vli_orders tok_vli", tok_vli, torch.bool, 2)
    if tok_val.shape != tok_vli.shape:
        raise ValueError(f"vli_orders: values {tuple(tok_val.shape)} and "
                         f"flags {tuple(tok_vli.shape)} differ in shape")
    n, T = tok_val.shape
    for t in (tok_val, tok_vli):
        if (T > 1 and t.stride(1) != 1) or (n > 1 and t.stride(0) < T):
            raise ValueError("vli_orders: rows must be of unit stride and "
                             "must not overlap")
    if tok_val.device != tok_vli.device:
        raise ValueError(f"vli_orders: tensors on several devices "
                         f"{tok_val.device}, {tok_vli.device}")
    if tok_val.device.type not in ("cuda", "cpu"):
        raise ValueError(f"vli_orders: unsupported device {tok_val.device}")
    return tok_val.device.type == "cuda"


def _scan_plain(x: torch.Tensor, nblk: int) -> torch.Tensor:
    """The plain version's scan over (TB, N * nblk) int32 transition
    parameters: frame f's blocks of TB tokens are columns f * nblk ...,
    each token's +1-biased (a | b << 5), 0 for a token that is no VLI
    value (a = (x - 1) & 31, b = ((x - 1) >> 5) & 31).  Returns the
    (TB, N * nblk) int8 orders.

    Pass A runs each block column over all NSTATE entry orders at once (TB
    sequential steps, every block of every frame in parallel), giving its
    transition map; pass B composes each frame's maps with a log-depth
    inclusive scan (map composition is a gather), segmented by frame: a
    frame's first block enters in order 0 and no map composes across
    frames; pass C replays each block from its true entry order and
    records every token's order before its own transition."""
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


def vli_orders_plain(tok_val: torch.Tensor,
                     tok_vli: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`vli_orders`: ``tokens._vli_ab``,
    blocks of ``tokens.VLI_BLOCK`` tokens (halved until they divide T)
    laid side by side as the columns of one transposed array,
    :func:`_scan_plain`, and the orders transposed back as int32."""
    from ..codec.tokens import VLI_BLOCK, _vli_ab

    _check(tok_val, tok_vli)
    N, T = tok_val.shape
    if N * T == 0:
        return torch.zeros((N, T), dtype=torch.int32, device=tok_val.device)
    TB = VLI_BLOCK
    while T % TB:
        TB //= 2
    nblk = T // TB
    x = _vli_ab(tok_val, tok_vli).reshape(N * nblk, TB).T.contiguous()
    return _scan_plain(x, nblk).T.contiguous().reshape(N, T).to(torch.int32)


def _scratch_for(x: torch.Tensor, stream: int, tiles: int) -> tuple:
    """(scratch, tiles it holds) of ``x``'s device and ``stream``: made
    zeroed at first use, and again, larger, only for a call of more tiles
    than :data:`MAX_TILES`."""
    key = (x.device.index, stream)
    buf, cap = _scratch.get(key, (None, 0))
    if cap < tiles:
        cap = max(tiles, MAX_TILES)
        # two counters (16 bytes), a 32-byte map and a 4-byte status a tile
        buf = torch.zeros(16 + 36 * cap, dtype=torch.uint8, device=x.device)
        _scratch[key] = buf, cap
    return buf, cap


def vli_orders(tok_val: torch.Tensor, tok_vli: torch.Tensor) -> torch.Tensor:
    """(N, T) int32 values and bool VLI flags -> (N, T) int32 orders.  On
    the card one launch (``launches`` grows by 1)."""
    if not _check(tok_val, tok_vli):
        return vli_orders_plain(tok_val, tok_vli)
    N, T = tok_val.shape
    out = torch.empty((N, T), dtype=torch.int32, device=tok_val.device)
    if N * T == 0:
        return out
    rows = [(t.data_ptr(), t.stride(0) if N > 1 else T)
            for t in (tok_val, tok_vli)]
    # 16-byte stores where T % 4 == 0, and loads where also every row of
    # both inputs is 16-byte aligned
    whole = T % 4 == 0
    aligned = whole and all(p % 16 == 0 and s % 4 == 0 for p, s in rows)
    vec = int(aligned) | 2 * int(whole)
    lib, stream = build.library(), build.stream_of(tok_val)
    tiles = N * -(-T // TILE)
    scratch, cap = _scratch_for(tok_val, stream, tiles)
    build.check(lib.dwt_vli_orders(
        tok_val.data_ptr(), rows[0][1], tok_vli.data_ptr(), rows[1][1],
        out.data_ptr(), N, T, scratch.data_ptr(), cap, vec, stream),
        "vli_orders")
    vli_orders.launches += 1
    return out


vli_orders.launches = 0
