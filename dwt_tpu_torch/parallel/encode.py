"""Multi-GPU encode and decode: the sharded counterparts of the
single-stream encoder, decoder and tiled container, built from the same
stage functions, so the bytes and pixels equal the single-device paths'.

Port of ``dwt_tpu/parallel/encode.py`` onto ``torch.distributed``: one
process a rank (``parallel/hosts.py``); every rank calls the same entry
point with the same arguments and gets the same result back.

* **Sequence parallelism over image rows** (:class:`ShardedEncoder`,
  :class:`ShardedDecoder`): the global multi-level DWT runs row-sharded
  with one halo row exchanged with each neighbour a level
  (``parallel/tiled.py``).  The encoder all-gathers the fine blocks, writes
  the coarse tail onto its dyadic grid and linearizes with one gather
  (kernel 1, ``ops/hilbert_gather``) through a source index composed on
  the host (halo layout, then scan order); the entropy stage then runs on
  every rank on the same ``lin``.  The decoder parses on every rank, puts
  the coefficients in pyramid order with the decoder tail's scatter
  (kernel 5), inverts the coarse tail, and runs the sharded inverse.

* **Data parallelism over tiles** (:func:`encode_tiled_sharded`): each rank
  encodes its share of every tile group; the tiles' layer byte ends and
  payloads are all-gathered, and every rank cuts the same global budget
  (``parallel/tiled.allocate_budget``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..codec import decoder
from ..codec.encoder import _bucket, get_encoder
from ..codec.stage1 import ALIGN, _stats_from_lin
from ..codec.tiled import get_batch_encoder, group_tiles, write_container
from ..geometry import Pyramid, compute_pyramid
from ..hilbert import padded_layout
from ..ops.hilbert_gather import hilbert_gather
from ..ops.lifting import dwt2d_inv
from . import hosts
from .tiled import (_halo_plan, halo_dwt2d_fwd, halo_dwt2d_inv, halo_perm,
                    rank_rows)


@functools.lru_cache(maxsize=16)
def _composed_perm(pyr: Pyramid, n_dev: int) -> np.ndarray:
    """(nlin,) int32 source index of kernel 1 into the flattened (h_pad, W)
    fine buffer, for each slot of ``padded_layout(pyr, ALIGN)``: the halo
    map composed with the scan order, root band included; -1 for pads
    (which the kernel leaves 0, as the single-stream ``lin`` has them)."""
    perm, valid, _ = padded_layout(pyr, ALIGN)
    return np.where(valid, halo_perm(pyr, n_dev)[perm], -1).astype(np.int32)


def _coarse_grid(pyr: Pyramid, n_dev: int) -> tuple:
    """(S, hc, wc): the coarse tail's stride on the fine buffer, and its
    height and width."""
    n_halo, _ = _halo_plan(pyr, n_dev)
    L = pyr.levels
    return 1 << n_halo, pyr.heights[L - n_halo], pyr.widths[L - n_halo]


def sharded_lin(img, mesh: hosts.Mesh, pyr: Pyramid, gray: bool,
                src: torch.Tensor) -> torch.Tensor:
    """Row-sharded colour transform and halo DWT, then the linearization.

    ``img``: the whole (H, W, C) image (every rank passes it; each copies
    only its rows to its device, as they are: the halo DWT's first level
    reads them with the colour applied as they load and the pad rows as
    zeros).  ``src``: :func:`_composed_perm` on the mesh's device.
    Returns the (C, nlin) linearized coefficients, equal to the
    single-stream stage-1 ``lin``, on every rank."""
    fine, coarse = halo_dwt2d_fwd(rank_rows(img, mesh, pyr), mesh, pyr,
                                  colour=not gray)
    # The whole (h_pad, W, C) buffer on every rank, the coarse pyramid on
    # its dyadic grid, then one gather.
    fine = hosts.all_gather(mesh, fine)
    S, hc, wc = _coarse_grid(pyr, mesh.size)
    fine[0:hc * S:S, 0:wc * S:S] = coarse
    return hilbert_gather(fine, src)


class ShardedEncoder:
    """Single-stream encoder whose transform runs row-sharded over the
    ranks of ``mesh`` (``hosts.global_mesh()`` when None: on the card
    unless the caller asks for the CPU).  Its bytes equal ``Encoder``'s,
    on every rank."""

    def __init__(self, width: int, height: int, channels: int,
                 mesh: hosts.Mesh | None = None):
        self.mesh = mesh if mesh is not None else hosts.global_mesh()
        self.pyr = compute_pyramid(width, height)
        self.channels = channels
        self.gray = channels == 1
        # The single-stream encoder of the geometry emits the stream.
        self._enc = get_encoder(width, height, channels, self.mesh.device)
        self._src = torch.as_tensor(
            _composed_perm(self.pyr, self.mesh.size), device=self.mesh.device)

    def encode(self, img: np.ndarray, capacity: int = 0) -> bytes:
        pyr = self.pyr
        shape = (pyr.height, pyr.width, self.channels)
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape != shape:
            raise ValueError(f"image shape {img.shape} does not match the "
                             f"encoder's {shape}")
        lin, stats = _stats_from_lin(
            sharded_lin(img, self.mesh, pyr, self.gray, self._src)[None],
            pyr, self.channels)
        payloads, _, _ = self._enc.emit_frames(
            lin, stats, _bucket(int(stats["T_host"][0])))
        stream = self._enc.header() + payloads[0]
        return stream[:capacity] if capacity > 0 else stream


class ShardedDecoder:
    """Decoder whose inverse transform runs row-sharded over the ranks of
    ``mesh`` (``hosts.global_mesh()`` when None), the mirror of
    :class:`ShardedEncoder`.  A stream that decodes fewer levels gives the
    smaller image of the single-stream decode, as in the JAX package."""

    def __init__(self, width: int, height: int, channels: int,
                 mesh: hosts.Mesh | None = None):
        self.mesh = mesh if mesh is not None else hosts.global_mesh()
        self.pyr = pyr = compute_pyramid(width, height)
        self.channels = channels
        self.gray = channels == 1
        n_halo, self.h_pad = _halo_plan(pyr, self.mesh.size)
        S, hc, wc = _coarse_grid(pyr, self.mesh.size)
        # n_halo == levels: the coarse region is the root band itself (it
        # may be below the 8x8 geometry minimum), with no tail transform.
        self._sub_pyr = (compute_pyramid(wc, hc) if n_halo < pyr.levels
                         else None)
        self._hp = torch.as_tensor(halo_perm(pyr, self.mesh.size),
                                   device=self.mesh.device)

    def decode(self, stream: bytes) -> np.ndarray:
        """One ``.dwt`` stream -> (H', W', C) uint8, the same on every
        rank."""
        pyr, C, mesh = self.pyr, self.channels, self.mesh
        dev = mesh.device
        W, H, gray = decoder.parse_header(stream)
        if (W, H, gray) != (pyr.width, pyr.height, self.gray):
            raise ValueError(f"a {W}x{H} {'gray' if gray else 'RGB'} stream "
                             f"for a {pyr.width}x{pyr.height} decoder with "
                             f"{C} channels")
        *_, coeffs, missing, levels = decoder._parse(stream, 0, dev)
        tail = decoder._tail(W, H, levels, C, gray, dev)
        coeffs = coeffs.to(dev, non_blocking=True)
        if levels < pyr.levels:
            return tail(coeffs, missing).cpu().numpy()  # reduced size
        pyr2d = tail.pyramid(coeffs[None], missing[None])[0]
        S, hc, wc = _coarse_grid(pyr, mesh.size)
        coarse = pyr2d[:hc, :wc]
        if self._sub_pyr is not None:
            coarse = dwt2d_inv(coarse, self._sub_pyr)
        # Scatter into the interleaved halo layout, the coarse tail onto
        # its dyadic grid, then this rank's block through the inverse.
        fine = torch.zeros((self.h_pad * W, C), dtype=torch.int32,
                           device=dev)
        fine[self._hp] = pyr2d.reshape(-1, C)
        fine = fine.reshape(self.h_pad, W, C)
        fine[0:hc * S:S, 0:wc * S:S] = coarse
        # The finest level stores the pixels: the inverse colour (RGB), the
        # clamps and the cast in its launch; the ranks gather bytes.
        rb = self.h_pad // mesh.size
        px = halo_dwt2d_inv(fine[mesh.rank * rb:(mesh.rank + 1) * rb], mesh,
                            pyr, to_bytes=True)
        return hosts.all_gather(mesh, px)[:H].cpu().numpy()


def _gather_payloads(mesh: hosts.Mesh, payloads: list) -> list:
    """Every rank's list of payloads (the same count on each), in rank
    order, on every rank: their lengths, then their bytes as one uint8
    tensor a rank, padded to the longest rank's."""
    dev = mesh.device
    lengths = hosts.all_gather(mesh, torch.tensor(
        [len(p) for p in payloads], dtype=torch.int64, device=dev)).cpu()
    per_rank = lengths.reshape(mesh.size, -1).sum(dim=1)
    width = int(per_rank.max())
    mine = np.zeros(width, np.uint8)
    joined = b"".join(payloads)
    mine[:len(joined)] = np.frombuffer(joined, np.uint8)
    blob = hosts.all_gather(mesh, torch.as_tensor(mine, device=dev))
    blob = blob.cpu().numpy().reshape(mesh.size, width)
    out = []
    for r, lens in enumerate(lengths.reshape(mesh.size, -1).tolist()):
        offs = np.cumsum([0] + lens)
        out.extend(blob[r, a:b].tobytes() for a, b in zip(offs, offs[1:]))
    return out


def encode_tiled_sharded(img: np.ndarray, mesh: hosts.Mesh | None = None,
                         tile: tuple = (512, 512), budget: int = 0) -> bytes:
    """Data-parallel tiled encode with a collective truncation allocation.

    Equal to ``codec.tiled.encode_tiled(img, tile, budget)``, on every rank
    of ``mesh`` (``hosts.global_mesh()`` when None).  Each group of
    same-shape tiles, in row-major order, is padded with zero tiles to a
    multiple of the ranks; rank r encodes the r-th contiguous block of it
    through the batched pipeline (``BatchEncoder``'s sub-batches: stage 1,
    then stage 2 at the bucket of the largest T over the ranks), as the
    JAX package's shard_map over its vmapped tile groups.
    The tiles' layer byte ends and payloads are all-gathered, and every
    rank cuts the same waterline, keeping the JAX package's 20 + 4n header
    reserve."""
    mesh = mesh if mesh is not None else hosts.global_mesh()
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    C = img.shape[2]
    groups, n_tiles = group_tiles(img, tile)
    payloads = [None] * n_tiles
    layer_bytes = [None] * n_tiles
    for (hh, ww), items in groups.items():
        tiles = np.stack([t for _, t in items])
        per = -(-len(items) // mesh.size)  # tiles a rank, dummies included
        mine = np.zeros((per, hh, ww, C), tiles.dtype)
        real = tiles[mesh.rank * per:(mesh.rank + 1) * per]
        mine[:len(real)] = real
        enc = get_batch_encoder(ww, hh, C, mesh.device)
        batches = enc.stage1_batches(mine)
        top = hosts.all_reduce_max(mesh, torch.stack(
            [st["T"].max() for _, st in batches]).max().to(torch.int64)
            .reshape(1))
        pls, ends = [], []
        for batch in batches:
            p, e = enc.emit_batch(batch, _bucket(int(top[0])))
            pls.extend(p)
            ends.append(e)
        # The JAX package's collective: the (per, LMAX) layer byte ends of
        # every rank, (n_pad, LMAX) on every rank; then the payloads.
        ends = hosts.all_gather(mesh, torch.as_tensor(
            (np.concatenate(ends) + 7) // 8, device=mesh.device)).cpu().numpy()
        pls = _gather_payloads(mesh, pls)
        for j, (i, _) in enumerate(items):
            payloads[i], layer_bytes[i] = pls[j], ends[j]
    return write_container(img.shape, tile, payloads, layer_bytes, budget)
