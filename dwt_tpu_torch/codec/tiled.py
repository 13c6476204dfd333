"""Batched and tiled encoding: throughput mode and the ``.dwtt`` container.

Port of ``dwt_tpu/codec/tiled.py``.  Two capabilities beyond the
reference's single-stream format:

* **Batch throughput mode** (:class:`BatchEncoder`): many same-geometry
  frames or tiles.  A sub-batch of frames (at most
  ``MAX_PIXELS_PER_DISPATCH`` pixels) goes through one device pipeline
  with a leading frame axis, at the sub-batch's shared token bucket, as
  the JAX package's vmapped program does: each encode kernel launches
  once a sub-batch, and the host copies once a sub-batch, not once a
  frame (BASELINE config 4, "batch-of-64 1080p").

* **Tiled container** (:func:`encode_tiled` / :func:`decode_tiled`): an
  image split into independently coded tiles with a per-tile length
  table.  Every tile stream is a standard headerless ``.dwt`` payload, so
  any prefix of any tile stays decodable.  A global byte budget is
  allocated across tiles by quality layer (``parallel.tiled.
  allocate_budget``), so all tiles degrade together.

Container layout (little-endian):
    0   'W' 'T'            magic
    2   u8  version = 1
    3   u8  flags: bit0 = grayscale
    4   u32 image width        8   u32 image height
    12  u16 tile width         14  u16 tile height
    16  u32 x (ntx * nty) per-tile stream byte lengths
    ..  concatenated tile streams
"""

from __future__ import annotations

import functools
import struct

import numpy as np

from ..parallel.tiled import allocate_budget
from . import decoder as _decoder
from . import encoder as _enc
from .emit import LMAX

MAGIC = b"WT"
VERSION = 1


class BatchEncoder:
    """Encodes batches of same-size images on one device (``device``
    defaults to the CUDA card), one pipeline a sub-batch."""

    # Pixels a sub-batch: bounds the buffers held on the device at once
    # (equal to the JAX package's bound on one vmapped dispatch).
    MAX_PIXELS_PER_DISPATCH = 16_000_000

    def __init__(self, width: int, height: int, channels: int, device=None):
        self.enc = _enc.get_encoder(width, height, channels, device)
        self.pyr = self.enc.pyr
        self.channels = channels
        # Frames a sub-batch can hold within stage 2's int32 indices at the
        # largest token bucket a frame of this geometry can reach.
        self.max_frames = _enc.max_batch(
            self.enc._src.numel(), self.pyr, channels,
            _enc._bucket(_enc.max_tokens(self.pyr, channels)))

    def header(self) -> bytes:
        return self.enc.header()

    def _chunks(self, imgs: np.ndarray):
        """Sub-batches of ``imgs``: at most ``MAX_PIXELS_PER_DISPATCH``
        pixels and ``max_frames`` frames each (the bytes do not depend on
        the grouping)."""
        chunk = max(1, min(self.MAX_PIXELS_PER_DISPATCH // self.pyr.total,
                           self.max_frames))
        return (imgs[s:s + chunk] for s in range(0, imgs.shape[0], chunk))

    def stage1_batches(self, imgs: np.ndarray) -> list:
        """(N, H, W, C) uint8 -> list of sub-batches (MAX_PIXELS_PER_DISPATCH
        pixels at most), each one (lin, stats) with a leading frame
        axis."""
        return [self.enc.stage1_frames(b) for b in self._chunks(
            np.asarray(imgs))]

    def emit_batch(self, batch: tuple, padded_T: int = 0) -> tuple:
        """Stage 2 of one sub-batch (lin, stats) at a shared token bucket
        (that of its largest T, unless ``padded_T`` gives one) ->
        (payloads, (n, LMAX) int64 layer bit ends)."""
        lin, stats = batch
        padded_T = padded_T or _enc._bucket(int(stats["T_host"].max()))
        payloads, _, ends = self.enc.emit_frames(lin, stats, padded_T)
        return payloads, ends

    def encode_raw(self, imgs: np.ndarray) -> tuple:
        """(N, H, W, C) uint8 -> (payloads list[bytes], layer_ends (N, LMAX)
        byte offsets).  Payloads exclude the 6-byte header.  Each
        sub-batch's stage 2 follows its stage 1, so one sub-batch's
        buffers are held at a time."""
        payloads, layer_list = [], []
        for b in self._chunks(np.asarray(imgs)):
            pls, ends = self.emit_batch(self.enc.stage1_frames(b))
            payloads.extend(pls)
            layer_list.append((ends + 7) // 8)
        return payloads, np.concatenate(layer_list, axis=0)

    def encode_batch(self, imgs: np.ndarray) -> list:
        """Full ``.dwt`` streams (with headers) for a batch of frames."""
        payloads, _ = self.encode_raw(imgs)
        hdr = self.header()
        return [hdr + p for p in payloads]


@functools.lru_cache(maxsize=16)
def get_batch_encoder(width: int, height: int, channels: int,
                      device=None) -> BatchEncoder:
    return BatchEncoder(width, height, channels, device)


def _tile_spans(extent: int, t: int) -> list:
    """Tile (start, size) spans; a trailing remainder below the codec's
    8-pixel minimum is absorbed into the final tile."""
    spans = []
    o = 0
    while o < extent:
        size = min(t, extent - o)
        if 0 < extent - (o + size) < 8:
            size = extent - o
        spans.append((o, size))
        o += size
    return spans


def _tile_grid(W: int, H: int, tw: int, th: int) -> tuple:
    return len(_tile_spans(W, tw)), len(_tile_spans(H, th))


def _head_bytes(n_tiles: int) -> int:
    # The budget reserves 20 + 4n bytes, 4 more than the real 16 + 4n
    # header: the JAX package's figure, kept so the containers are equal.
    return 20 + 4 * n_tiles


def budget_cuts(layer_bytes: list, budget: int) -> np.ndarray:
    """(n_tiles,) byte lengths of the tiles under a container ``budget``:
    :func:`allocate_budget` over the tiles' (LMAX,) cumulative layer byte
    ends, in tile order, after the header's reserve."""
    lb = np.stack(layer_bytes)
    return allocate_budget(np.diff(lb, axis=1, prepend=0),
                           max(budget - _head_bytes(len(layer_bytes)), 0))


def _reemit(enc: BatchEncoder, lin, stats) -> bytes:
    """One tile's payload emitted again without the layer mask (``lin``
    and ``stats``: that frame's, as ``Encoder.stage1`` gives them)."""
    return enc.enc.emit(lin, stats, _enc._bucket(int(stats["T_host"])))[0]


def _budget_work(groups: dict, C: int, budget: int, n_tiles: int,
                 device) -> tuple:
    """Budget-bounded work (bytes.h:75-78 as the reference's early stop,
    generalized across tiles): stage 1 runs for every tile; per-layer
    lower-bound byte costs give a conservative global waterline layer
    ``keep``; every tile's schedule is masked beyond it before stage 2
    (frame by frame, on its sub-batch's stats).  Lower bounds make the
    true allocation stop inside layer ``keep`` at the latest, and a masked
    stream equals the lossless one through the end of that layer, so the
    cuts equal the lossless ones.  Past that end a masked stream holds a
    few bits of its own: a tile whose cut's last byte holds any of them is
    emitted again unmasked (:func:`_reemit`, one frame), so every cut is
    the lossless stream's prefix.  Returns (payloads, layer byte ends), in
    tile order."""
    work, lb_rows = [], []
    for (hh, ww), items in groups.items():
        enc = get_batch_encoder(ww, hh, C, device)
        ids = [i for i, _ in items]
        for lin, stats in enc.stage1_batches(np.stack([t for _, t in items])):
            n = lin.shape[0]
            host = _enc.host_stats(stats)
            hosts = [_enc.frame(host, j) for j in range(n)]
            work.append((enc, lin, stats, hosts, ids[:n]))
            ids = ids[n:]
            lb_rows.extend(_enc._layer_lb_bytes_host(h, enc.pyr, C, LMAX)
                           for h in hosts)
    cum = np.stack(lb_rows).sum(axis=0).cumsum()
    # First layer the lower-bound total cannot fully afford: the true cut
    # reaches at most into it, so later layers never survive.
    keep = int((cum <= max(budget - _head_bytes(n_tiles), 0)).sum())
    payloads, bit_ends, unmasked = [None] * n_tiles, [None] * n_tiles, {}
    for enc, lin, stats, hosts, ids in work:
        upds = {}
        for j, (h, i) in enumerate(zip(hosts, ids)):
            upd = _enc._truncate_schedule_to_layer(h, keep, enc.pyr, C)
            if upd is not None:
                unmasked[i] = (enc, lin[j], _enc.frame(stats, j))
                upds[j] = upd
        pls, ends = enc.emit_batch((lin, _enc.patch_frames(stats, upds)))
        for i, p, e in zip(ids, pls, ends):
            payloads[i], bit_ends[i] = p, e
    layer_bytes = [(e + 7) // 8 for e in bit_ends]
    for i, n in enumerate(budget_cuts(layer_bytes, budget)):
        # A masked tile has steps past layer ``keep``, so keep < LMAX.
        if i in unmasked and 8 * int(n) > bit_ends[i][keep]:
            payloads[i] = _reemit(*unmasked[i])
    return payloads, layer_bytes


def group_tiles(img: np.ndarray, tile: tuple) -> tuple:
    """The tiles of an (H, W, C) image grouped by their true (edge tiles:
    smaller) shape: ({(hh, ww): [(tile index, (hh, ww, C) view)]}, number
    of tiles), tile indices in row-major grid order."""
    th, tw = tile
    groups: dict = {}
    n_tiles = 0
    for y0, hh in _tile_spans(img.shape[0], th):
        for x0, ww in _tile_spans(img.shape[1], tw):
            groups.setdefault((hh, ww), []).append(
                (n_tiles, img[y0:y0 + hh, x0:x0 + ww]))
            n_tiles += 1
    return groups, n_tiles


def write_container(shape: tuple, tile: tuple, payloads: list,
                    layer_bytes: list, budget: int) -> bytes:
    """The ``.dwtt`` bytes of an (H, W, C) image from its tiles' payloads
    and (LMAX,) cumulative layer byte ends, in tile order, cut to
    ``budget`` bytes by :func:`allocate_budget` when it is > 0."""
    H, W, C = shape
    th, tw = tile
    if budget > 0:
        payloads = [p[:int(n)] for p, n in
                    zip(payloads, budget_cuts(layer_bytes, budget))]
    head = MAGIC + struct.pack("<BBIIHH", VERSION, 0 if C == 3 else 1,
                               W, H, tw, th)
    table = np.array([len(p) for p in payloads], "<u4").tobytes()
    return head + table + b"".join(payloads)


def encode_tiled(img: np.ndarray, tile: tuple = (512, 512), budget: int = 0,
                 device=None) -> bytes:
    """Encode into the tiled container, with an optional global byte
    budget.  Edge tiles keep their true (smaller) size and are encoded
    with their own geometry; same-shape tiles share a batch encoder."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    C = img.shape[2]
    groups, n_tiles = group_tiles(img, tile)
    if budget > 0:
        payloads, layer_bytes = _budget_work(groups, C, budget, n_tiles,
                                             device)
    else:
        payloads, layer_bytes = [None] * n_tiles, [None] * n_tiles
        for (hh, ww), items in groups.items():
            enc = get_batch_encoder(ww, hh, C, device)
            pls, lbs = enc.encode_raw(np.stack([t for _, t in items]))
            for (i, _), p, lb in zip(items, pls, lbs):
                payloads[i], layer_bytes[i] = p, lb
    return write_container(img.shape, tile, payloads, layer_bytes, budget)


def decode_tiled(data: bytes, nthreads: int = 0, pixels_max: int = 0,
                 device=None) -> tuple:
    """Decode a ``.dwtt`` container; returns (img uint8 (H, W, C), gray).

    The tiles of each geometry go through one :func:`decoder.decode_batch`
    (the parser's thread pool, then batched tails).  ``pixels_max`` caps
    the per-tile decode resolution; reduced tiles are upsampled back to
    full size by pixel replication, and a tile cut inside its root band
    stays zero."""
    if data[:2] != MAGIC:
        raise ValueError("not a dwtt container")
    ver, flags, W, H, tw, th = struct.unpack("<BBIIHH", data[2:16])
    if ver != VERSION:
        raise ValueError(f"unsupported container version {ver}")
    gray = bool(flags & 1)
    C = 1 if gray else 3
    ntx, nty = _tile_grid(W, H, tw, th)
    n = ntx * nty
    table = np.frombuffer(data[16:16 + 4 * n], "<u4")
    off = 16 + 4 * n

    # Tiles grouped by their true geometry (edge tiles differ).
    groups: dict = {}
    spans = []
    for y0, hh in _tile_spans(H, th):
        for x0, ww in _tile_spans(W, tw):
            i = len(spans)
            groups.setdefault((hh, ww), []).append(
                (i, data[off:off + int(table[i])]))
            off += int(table[i])
            spans.append((y0, x0))

    out = np.zeros((H, W, C), np.uint8)
    for (hh, ww), items in groups.items():
        imgs = _decoder.decode_batch([s for _, s in items], ww, hh, gray,
                                     pixels_max=pixels_max,
                                     nthreads=nthreads, device=device)
        for (i, _), timg in zip(items, imgs):
            if timg is None:
                continue  # cut inside its root band: left as zeros
            y0, x0 = spans[i]
            oh, ow = timg.shape[:2]
            if (oh, ow) != (hh, ww):
                ry = (hh + oh - 1) // oh
                rx = (ww + ow - 1) // ow
                timg = np.repeat(np.repeat(timg, ry, 0), rx, 1)[:hh, :ww]
            out[y0:y0 + hh, x0:x0 + ww] = timg
    return out, gray
