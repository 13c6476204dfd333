"""The encoder's codeword pieces (kernel ``csrc/codeword.cu``).

No TPU kernel to port: the JAX package runs
``dwt_tpu/codec/encoder.py:_codeword_contribs`` as XLA in uint32.
:func:`codeword_pieces` is the (N, T) part of it, for the N frames of a
sub-batch: each token's codeword bit length, its final-stream bit offset
after one inclusive int32 scan of the lengths and the refinement bits
injected between steps, its word index and its <= 3 uint32 word pieces.
For frame f and slot t, with s = ``orders``, v = ``tok_val``:

* k = max(0, ilog2(v + 2^s) - s) for a VLI token, else 0;
* nbits = 2k + s + 1 for a VLI token, else ``tok_raw``;
* (lo, hi): the VLI codeword (k zeros, a 1, s + k payload bits) as two
  uint32 halves, or (v, 0) for a raw token;
* inject[t]: the sum of ``nref_step[f, j]`` over the steps whose
  ``inj_site[f, j]``, clamped to [0, T], is t (site T is dropped);
* off = incl - nbits, incl the inclusive int32 scan (wrapping) of
  nbits + inject along the row;
* widx = (off >> 5) + f * nwords, the frame's words laid end to end;
* c0 = lo << sh, c1 = lo >> (32 - sh) | hi << sh, c2 = hi >> (32 - sh)
  with sh = off & 31 (the shifts by 32 - sh taken as >> 1 >> (31 - sh),
  which gives 0 for sh = 0), each stored as an int32 bit pattern;
* the per-2048-slot chunk sums of nbits, the first level of the JAX
  package's ``_bit_partials``.

Returns (off, widx, c0, c1, c2, chunks): five (N, T) int32 tensors and an
(N, ceil(T / 2048)) int32 one.

On the card: one launch a call, of as many persistent blocks as the card
holds at once (:func:`launch_plan`: its SMs times the blocks an SM takes
at the call's shared memory, read once a device and step count), each
taking tiles of :data:`TILE` slots by ticket: the next tile's rows are in
flight (TMA bulk copies into shared memory) while the current one scans,
looks back and stores, and its status is published while the current
one looks back.  The kernel reads the token arrays in place (rows of unit
stride at any row stride, each copy kept inside its tensor's storage)
and keeps a ticket and a status word a tile in a scratch of
:data:`MAX_TILES` tiles (8 MB) a device and stream, zeroed once when it is
made and left zeroed by each call's last block.  On the CPU:
:func:`codeword_pieces_plain`, the eager passes the encoder ran before, in
int64.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import build
from ._launch import need
from .plane_stats import _ilog2

THREADS = 256   # threads a block (csrc/codeword.cu: THREADS)
TILE = 2048     # slots a tile (csrc/codeword.cu: TILE)
CHUNK = 2048    # slots a chunk sum (the JAX package's _bit_partials)
MIN_BLOCKS = 3  # blocks an SM the kernel is compiled for (<= 80 registers)
# Bytes of a block's shared memory (csrc/codeword.cu: WROW, FROW, STAGE,
# INJ): two stages of the val, raw and ord rows' 16-byte windows and the
# flag row's, and the injections, a word a slot.
WROW = 4 * TILE + 32
FROW = TILE + 48
STAGE = 3 * WROW + FROW
INJ = 4 * TILE
# Tiles the scratch holds at first: every call within the encoder's int32
# token slots (2^31 a sub-batch) fits.
MAX_TILES = 2**31 // TILE
_I32 = torch.int32
_M32 = 0xFFFFFFFF

_scratch: dict = {}  # (device index, stream) -> zeroed uint8 scratch
_plans: dict = {}    # (device index, S) -> (SMs, blocks an SM, smem bytes)


def _check(tok_val, tok_raw, tok_vli, orders, inj_site, nref_step,
           nwords: int) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on anything the kernel does not take."""
    name = "codeword_pieces"
    for arg, t, dt in (("tok_val", tok_val, _I32), ("tok_raw", tok_raw, _I32),
                       ("tok_vli", tok_vli, torch.bool),
                       ("orders", orders, _I32),
                       ("inj_site", inj_site, _I32),
                       ("nref_step", nref_step, _I32)):
        need(f"{name} {arg}", t, dt, 2)
    n, T = tok_val.shape
    for t in (tok_raw, tok_vli, orders):
        if t.shape != tok_val.shape:
            raise ValueError(f"{name}: token arrays differ in shape: "
                             f"{tuple(tok_val.shape)}, {tuple(t.shape)}")
    if inj_site.shape != nref_step.shape or inj_site.shape[0] != n:
        raise ValueError(f"{name}: step tables {tuple(inj_site.shape)}, "
                         f"{tuple(nref_step.shape)} for {n} frames")
    for t in (tok_val, tok_raw, tok_vli, orders):
        if (T > 1 and t.stride(1) != 1) or (n > 1 and t.stride(0) < T):
            raise ValueError(f"{name}: token rows must be of unit stride and "
                             "must not overlap")
    for t in (inj_site, nref_step):
        if not t.is_contiguous():
            raise ValueError(f"{name}: step tables must be contiguous")
    if not (0 <= nwords and n * nwords < 2**31):
        raise ValueError(f"{name}: {n} frames of {nwords} words pass the "
                         "int32 word indices")
    devs = {t.device for t in (tok_val, tok_raw, tok_vli, orders, inj_site,
                               nref_step)}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def codeword_pieces_plain(tok_val, tok_raw, tok_vli, orders, inj_site,
                          nref_step, nwords: int) -> tuple:
    """Plain PyTorch version of :func:`codeword_pieces`: eager passes over
    the (N, T) arrays, the codeword arithmetic in int64 on values below
    2^32, the injections by ``scatter_add_`` and one ``cumsum``."""
    _check(tok_val, tok_raw, tok_vli, orders, inj_site, nref_step, nwords)
    N, T = tok_val.shape
    dev = tok_val.device
    v, s = tok_val.long(), orders.long()
    one = torch.ones_like(s)
    k = torch.where(tok_vli, torch.clamp(_ilog2(v + (one << s)) - s, min=0),
                    0)
    nbits = torch.where(tok_vli, 2 * k + s + 1, tok_raw.long())
    # A VLI codeword is k prefix zeros, a 1, then s + k payload bits:
    # 2k + s + 1 <= 61 bits with s + k <= 30, split into (lo, hi) words.
    payload = v - ((one << (s + k)) - (one << s))
    lo = torch.where(tok_vli, ((one << k) | (payload << (k + 1))) & _M32,
                     v & _M32)
    hi = torch.where(tok_vli, (payload & _M32) >> (31 - k), 0)

    site = inj_site.clamp(0, T).long()
    inject = torch.zeros((N, T + 1), dtype=torch.int64,
                         device=dev).scatter_add_(1, site, nref_step.long())
    incl = torch.cumsum(nbits + inject[:, :T], dim=1).to(_I32)
    off = incl - nbits.to(_I32)
    widx = (off >> 5) + torch.arange(N, dtype=_I32, device=dev)[:, None] \
        * nwords
    sh = (off & 31).long()
    shc = 31 - sh  # >> (32 - sh) as >> 1 >> (31 - sh): valid for sh == 0
    c0 = (lo << sh) & _M32
    c1 = (((lo >> 1) >> shc) | (hi << sh)) & _M32
    c2 = (hi >> 1) >> shc
    r = (-T) % CHUNK
    chunks = torch.cat([nbits, nbits.new_zeros((N, r))], dim=1).reshape(
        N, (T + r) // CHUNK, CHUNK).sum(dim=2).to(_I32)
    return (off, widx, *(torch.where(c >= 2**31, c - 2**32, c).to(_I32)
                         for c in (c0, c1, c2)), chunks)


def _scratch_for(x: torch.Tensor, stream: int, tiles: int) -> tuple:
    """(scratch, tiles it holds) of ``x``'s device and ``stream``: made
    zeroed at first use, and again, larger, only for a call of more tiles
    than :data:`MAX_TILES`."""
    key = (x.device.index, stream)
    buf, cap = _scratch.get(key, (None, 0))
    if cap < tiles:
        cap = max(tiles, MAX_TILES)
        # two counters (16 bytes) and an 8-byte status a tile
        buf = torch.zeros(16 + 8 * cap, dtype=torch.uint8, device=x.device)
        _scratch[key] = buf, cap
    return buf, cap


def table_row(S: int) -> int:
    """Bytes of one staged step-table row of ``S`` int32 entries: their
    16-byte window (a head and a tail of up to 12 bytes each)."""
    return (4 * S + 24 + 15) & ~15


def smem_bytes(S: int) -> int:
    """A block's dynamic shared memory at ``S`` steps a frame: two stages,
    the injections, the frame's sites and refinement-bit counts."""
    return 2 * STAGE + INJ + 2 * table_row(S)


def launch_plan(n: int, T: int, sms: int, per_sm: int) -> tuple:
    """(tiles, persistent blocks) of a call on ``n`` frames of ``T`` slots
    on a card of ``sms`` SMs that holds ``per_sm`` blocks an SM at once: a
    tile a ``TILE`` slots of a frame, and no more blocks than tiles."""
    tiles = n * -(-T // TILE)
    if per_sm < 1:
        raise ValueError(f"codeword_pieces: no block of {THREADS} threads "
                         f"fits an SM")
    return tiles, min(tiles, sms * per_sm)


def _plan_for(x: torch.Tensor, S: int) -> tuple:
    """(SMs, blocks an SM, a block's shared memory) on ``x``'s device at
    ``S`` steps a frame: from the CUDA runtime, once a device and S."""
    key = (x.device.index, S)
    if key not in _plans:
        sms, per_sm, smem = (ctypes.c_int() for _ in range(3))
        build.check(build.library().dwt_codeword_plan(
            S, ctypes.byref(sms), ctypes.byref(per_sm), ctypes.byref(smem)),
            "codeword_pieces")
        if smem.value != smem_bytes(S):
            raise RuntimeError(f"codeword_pieces: the kernel's shared memory "
                               f"{smem.value} B is not {smem_bytes(S)} B")
        _plans[key] = sms.value, per_sm.value, smem.value
    return _plans[key]


def _bounds(*tensors) -> ctypes.Array:
    """The first and past-the-last byte of each tensor's storage, as 2k
    int64 for the kernel (its copies stay inside them)."""
    out = []
    for t in tensors:
        st = t.untyped_storage()
        out += [st.data_ptr(), st.data_ptr() + st.nbytes()]
    return (ctypes.c_int64 * len(out))(*out)


def codeword_pieces(tok_val: torch.Tensor, tok_raw: torch.Tensor,
                    tok_vli: torch.Tensor, orders: torch.Tensor,
                    inj_site: torch.Tensor, nref_step: torch.Tensor,
                    nwords: int) -> tuple:
    """(N, T) int32 token values and raw lengths, bool VLI flags and int32
    orders, and (N, S) int32 injection sites and refinement-bit counts ->
    (off, widx, c0, c1, c2, chunks).  On the card one launch
    (``launches`` grows by 1)."""
    if not _check(tok_val, tok_raw, tok_vli, orders, inj_site, nref_step,
                  nwords):
        return codeword_pieces_plain(tok_val, tok_raw, tok_vli, orders,
                                     inj_site, nref_step, nwords)
    N, T = tok_val.shape
    S = inj_site.shape[1]
    dev = tok_val.device
    outs = [torch.empty((N, T), dtype=_I32, device=dev) for _ in range(5)]
    chunks = torch.empty((N, -(-T // CHUNK)), dtype=_I32, device=dev)
    if N * T == 0:
        return (*outs, chunks)
    rows = [t.stride(0) if N > 1 else T
            for t in (tok_val, tok_raw, tok_vli, orders)]
    lib, stream = build.library(), build.stream_of(tok_val)
    tiles, grid = launch_plan(N, T, *_plan_for(tok_val, S)[:2])
    scratch, cap = _scratch_for(tok_val, stream, tiles)
    bounds = _bounds(tok_val, tok_raw, orders, tok_vli, inj_site, nref_step)
    build.check(lib.dwt_codeword_pieces(
        tok_val.data_ptr(), rows[0], tok_raw.data_ptr(), rows[1],
        tok_vli.data_ptr(), rows[2], orders.data_ptr(), rows[3],
        inj_site.data_ptr(), nref_step.data_ptr(), S,
        *(o.data_ptr() for o in outs), chunks.data_ptr(), N, T, nwords,
        ctypes.addressof(bounds), grid, scratch.data_ptr(), cap, stream),
        "codeword_pieces")
    codeword_pieces.launches += 1
    return (*outs, chunks)


codeword_pieces.launches = 0
