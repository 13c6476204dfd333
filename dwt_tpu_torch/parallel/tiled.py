"""Multi-GPU scaling: the row-sharded global DWT with halo exchange, and the
global truncation allocation across the tiles of a ``.dwtt`` container.

Port of ``dwt_tpu/parallel/tiled.py`` onto ``torch.distributed``: one
process a rank (``parallel/hosts.py``), each holding its own block of rows.

* **Row-sharded global transform** (:func:`halo_dwt2d_fwd`,
  :func:`halo_dwt2d_inv`): the full-image DWT, equal to the single-device
  transform, computed with the image split over the ranks by rows.  Every
  level stays in the interleaved (in-place) layout: the active samples of
  level t live on the dyadic grid (row = 0 mod 2^t), which stays evenly
  spread over the ranks, so no level is redistributed.  Each level's column
  lifting exchanges one boundary row in each direction with the
  neighbouring ranks (``hosts.shift``).  Once the stride no longer divides a
  rank's block, the small remaining grid is all-gathered and finished on
  every rank (the replicated coarse tail).  The JAX package's ``shard_map``
  body becomes a function of this rank's ``(Rb, W, C)`` block and the mesh.

* **Global truncation allocation** (:func:`allocate_budget`): the byte
  budget of the reference's CAPACITY mechanism across many tiles.

The lifting and the exchanges are plain PyTorch and ``torch.distributed``,
as they are plain array code in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..geometry import Pyramid, compute_pyramid
from ..ops.lifting import dwt2d_fwd
from . import hosts


def _tdiv(a: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(a, d, rounding_mode="trunc")


def _lift_fwd_strided(x: torch.Tensor, axis: int, stride: int,
                      n_active: int) -> torch.Tensor:
    """In-place (interleaved) forward lifting of ``x`` along ``axis`` on the
    dyadic grid with ``stride``: positions i*stride for i < n_active
    participate.  Equal to ``cdf53_fwd`` on the gathered active samples,
    with the results left at their positions: evens keep their spots, odds
    hold the high-pass values.  Writes into ``x`` (a view is fine) and
    returns it."""
    xm = x.movedim(axis, 0)
    ev, od = xm[::2 * stride], xm[stride::2 * stride]
    ne, no = ev.shape[0], od.shape[0]
    right = ev[1:] if ne > no else torch.cat([ev[1:], ev[-1:]])
    d = od - _tdiv(ev[:no] + right, 2)
    upd = _tdiv(torch.cat([d[:1], d[:-1]]) + d, 4)
    nupd = ne if n_active % 2 == 0 else ne - 1
    s = torch.cat([ev[:nupd] + upd[:nupd], ev[nupd:]])
    xm[::2 * stride] = s
    xm[stride::2 * stride] = d
    return x


def _lift_inv_strided(x: torch.Tensor, axis: int, stride: int,
                      n_active: int) -> torch.Tensor:
    """Inverse of :func:`_lift_fwd_strided`, in place: un-update the evens,
    then un-predict the odds, on the dyadic grid (cdf53.h:36-61 order and
    signs)."""
    xm = x.movedim(axis, 0)
    ev, d = xm[::2 * stride], xm[stride::2 * stride]
    ne, no = ev.shape[0], d.shape[0]
    upd = _tdiv(torch.cat([d[:1], d[:-1]]) + d, 4)
    nupd = ne if n_active % 2 == 0 else ne - 1
    s = torch.cat([ev[:nupd] - upd[:nupd], ev[nupd:]])
    right = s[1:] if ne > no else torch.cat([s[1:], s[-1:]])
    od = d + _tdiv(s[:no] + right, 2)
    xm[::2 * stride] = s
    xm[stride::2 * stride] = od
    return x


def _deinterleave_map(pyr: Pyramid, n_levels: int) -> np.ndarray:
    """(H * W,) int64: for each position of the deinterleaved layout of the
    ``n_levels`` finest levels, the flat (H, W) index of the interleaved
    layout that holds its value."""
    H, W, L = pyr.height, pyr.width, pyr.levels
    src = np.arange(H * W, dtype=np.int64).reshape(H, W)
    for l in range(L, L - n_levels, -1):
        h, w = pyr.heights[l], pyr.widths[l]
        sub = src[:h, :w]
        # Deinterleave rows then columns of this level's region: evens first.
        sub = np.concatenate([sub[:, 0::2], sub[:, 1::2]], axis=1)
        src[:h, :w] = np.concatenate([sub[0::2], sub[1::2]], axis=0)
    return src.reshape(-1)


def interleaved_to_pyramid_perm(pyr: Pyramid) -> np.ndarray:
    """(H * W,) int32 gather indices from the in-place (interleaved)
    transform layout to the deinterleaved pyramid layout, flat over (H, W).
    After L in-place levels the level-t low band lives on the dyadic grid
    (row, col = 0 mod 2^t); the pyramid puts the level-l image in the
    top-left (heights[l], widths[l]) corner."""
    return _deinterleave_map(pyr, pyr.levels).astype(np.int32)


@functools.lru_cache(maxsize=32)
def _halo_plan(pyr: Pyramid, n_dev: int) -> tuple:
    """(n_halo, h_pad): how many transform levels run with halo exchange,
    and the padded row count of the sharded buffer.

    Level t lifts the dyadic grid of stride 2^t, so the halo path needs
    every rank's active row count h_pad / n_dev / 2^t to be whole and even:
    h_pad divisible by n_dev * 2^(t+1).  Rows are padded to a multiple of
    n_dev * 2^k for the deepest k whose padding stays below about 8 % of the
    rows (the replicated tail beyond level k is about 1/4^k of the work).
    Pad rows carry garbage that never reaches a real row: the edge masks of
    the column pass apply the reference's rules at the true image edge."""
    H = pyr.height
    best = (0, -(-H // n_dev) * n_dev)
    for k in range(pyr.levels, -1, -1):
        q = n_dev << k
        h_pad = -(-H // q) * q
        if h_pad - H <= max(H // 12, n_dev * 2 - 1):
            best = (k, h_pad)
            break
    return best


def pad_rows(x: torch.Tensor, pyr: Pyramid, n_dev: int) -> torch.Tensor:
    """(H, W, C) padded with zero rows to the halo plan's (h_pad, W, C)."""
    _, h_pad = _halo_plan(pyr, n_dev)
    if x.shape[0] == h_pad:
        return x
    return torch.cat([x, x.new_zeros((h_pad - x.shape[0],) + x.shape[1:])])


def rank_rows(img, mesh: hosts.Mesh, pyr: Pyramid) -> torch.Tensor:
    """This rank's (h_pad / n, W, C) int32 block of ``pad_rows(img)`` on its
    device, from an (H, W, C) numpy array or tensor: only these rows are
    copied to the device, in their own dtype (widened there)."""
    _, h_pad = _halo_plan(pyr, mesh.size)
    rb = h_pad // mesh.size
    rows = torch.as_tensor(img[mesh.rank * rb:(mesh.rank + 1) * rb])
    rows = rows.to(mesh.device).to(torch.int32)
    return torch.cat([rows, rows.new_zeros((rb - rows.shape[0],)
                                           + rows.shape[1:])])


def _level_rules(pyr: Pyramid, t: int) -> tuple:
    """(stride, active width, even rows, updated evens) of level t's grid:
    the reference's even-N last-odd clamp and odd-N last-even no-update
    (cdf53.h:12-23) apply at these true-edge counts."""
    L = pyr.levels
    h_act, w_act = pyr.heights[L - t], pyr.widths[L - t]
    n_even = h_act - h_act // 2
    return 1 << t, w_act, n_even, n_even if h_act % 2 == 0 else n_even - 1


def halo_dwt2d_fwd(xb: torch.Tensor, mesh: hosts.Mesh, pyr: Pyramid) -> tuple:
    """Forward multi-level 2-D DWT of a row-sharded image.

    ``xb``: this rank's (h_pad / n, W, C) int32 block of the padded image
    (:func:`pad_rows`, :func:`rank_rows`).  Returns (fine, coarse): ``fine``
    is this rank's block of the interleaved buffer holding every halo
    level's results; ``coarse`` is the deinterleaved transform of the
    remaining levels' LL image, the same on every rank.  Reassemble with
    :func:`assemble_pyramid`.

    On arbitrary heights: the active grid of level t has exactly
    heights[L - t] real rows, all inside the image; per-row masks apply the
    reference's edge rules at the true boundary, so pad rows only ever
    receive garbage and never feed a real row."""
    n_halo, h_pad = _halo_plan(pyr, mesh.size)
    L = pyr.levels
    if tuple(xb.shape[:2]) != (h_pad // mesh.size, pyr.width):
        raise ValueError(f"halo_dwt2d_fwd: a block of {tuple(xb.shape)} is "
                         f"not one of {mesh.size} blocks of ({h_pad}, "
                         f"{pyr.width}, C)")
    out = xb.clone()
    for t in range(n_halo):
        s, w_act, n_even, n_upd = _level_rules(pyr, t)
        # Row pass: local, on the active rows (pad rows too: harmless).
        _lift_fwd_strided(out[::s], 1, s, w_act)
        # Column pass on the active grid, with one row from each neighbour.
        ev, od = out[::2 * s, ::s], out[s::2 * s, ::s]
        ne = ev.shape[0]
        jg = mesh.rank * ne + torch.arange(ne, device=out.device)
        # Predict: odd j's right neighbour is even j + 1, the next rank's
        # first even for the last odd here; at the true edge (j + 1 >=
        # n_even) the odd clamps to its own left even (cdf53.h:15-17).
        right = torch.cat([ev[1:], hosts.shift(mesh, ev[:1], 1)])
        right = torch.where((jg + 1 >= n_even)[:, None, None], ev, right)
        d = od - _tdiv(ev + right, 2)
        # Update: even j's left neighbour is odd j - 1, the previous rank's
        # last odd for the first even here; the global first even clamps to
        # its own odd (cdf53.h:19-20); evens from n_upd keep their value.
        prev = hosts.shift(mesh, d[-1:], -1)
        left = torch.cat([d[:1] if mesh.rank == 0 else prev, d[:-1]])
        sc = ev + _tdiv(left + d, 4)
        sc = torch.where((jg < n_upd)[:, None, None], sc, ev)
        out[::2 * s, ::s] = sc
        out[s::2 * s, ::s] = d
    # Gather the coarse active grid and finish it on every rank.
    S = 1 << n_halo
    hc, wc = pyr.heights[L - n_halo], pyr.widths[L - n_halo]
    coarse = hosts.all_gather(mesh, out[::S, ::S][:, :wc])[:hc]
    if n_halo < L:
        coarse = dwt2d_fwd(coarse, compute_pyramid(wc, hc))
    return out, coarse


def halo_perm(pyr: Pyramid, n_dev: int) -> np.ndarray:
    """(H * W,) int64 gather indices from the padded fine buffer (flattened
    (h_pad, W)) to the deinterleaved pyramid layout (flattened (H, W)) for
    the halo levels; coarse positions map to themselves (the coarse result
    is written onto them first).  Row r of the (H, W) grid lies at flat
    index r * W + c in both layouts: pad rows only extend the buffer."""
    return _deinterleave_map(pyr, _halo_plan(pyr, n_dev)[0])


def assemble_pyramid(fine: torch.Tensor, coarse: torch.Tensor, pyr: Pyramid,
                     n_dev: int) -> torch.Tensor:
    """The whole (h_pad, W, C) fine buffer (every rank's block, in rank
    order) and the coarse result -> the deinterleaved pyramid (H, W, C).
    A test helper: the encoder composes this map into its linearization
    gather instead."""
    n_halo, _ = _halo_plan(pyr, n_dev)
    L, W = pyr.levels, pyr.width
    S = 1 << n_halo
    out = fine.clone()
    out[::S, ::S][:pyr.heights[L - n_halo], :pyr.widths[L - n_halo]] = coarse
    flat = out.reshape(out.shape[0] * W, -1)
    idx = torch.as_tensor(halo_perm(pyr, n_dev), device=out.device)
    return flat[idx].reshape((pyr.height, W) + tuple(out.shape[2:]))


def halo_dwt2d_inv(fb: torch.Tensor, mesh: hosts.Mesh,
                   pyr: Pyramid) -> torch.Tensor:
    """Inverse multi-level 2-D DWT of a row-sharded coefficient buffer.

    ``fb``: this rank's (h_pad / n, W, C) int32 block of the interleaved
    halo layout with every coefficient placed (the coarse tail already
    inverted and written onto its dyadic grid, as ``ShardedDecoder`` does).
    Mirrors :func:`halo_dwt2d_fwd`: level by level, coarsest first, the
    inverse column lifting with one row from each neighbour (un-update
    needs the previous rank's last odd, un-predict the next rank's first
    un-updated even), then the local inverse row lifting (decode.c:16-30
    order).  Returns this rank's block of the image (rows >= H: garbage)."""
    n_halo, h_pad = _halo_plan(pyr, mesh.size)
    if tuple(fb.shape[:2]) != (h_pad // mesh.size, pyr.width):
        raise ValueError(f"halo_dwt2d_inv: a block of {tuple(fb.shape)} is "
                         f"not one of {mesh.size} blocks of ({h_pad}, "
                         f"{pyr.width}, C)")
    out = fb.clone()
    for t in range(n_halo - 1, -1, -1):
        s, w_act, n_even, n_upd = _level_rules(pyr, t)
        ev, d = out[::2 * s, ::s], out[s::2 * s, ::s]
        ne = ev.shape[0]
        jg = mesh.rank * ne + torch.arange(ne, device=out.device)
        prev = hosts.shift(mesh, d[-1:], -1)
        left = torch.cat([d[:1] if mesh.rank == 0 else prev, d[:-1]])
        sc = ev - _tdiv(left + d, 4)
        sc = torch.where((jg < n_upd)[:, None, None], sc, ev)
        right = torch.cat([sc[1:], hosts.shift(mesh, sc[:1], 1)])
        right = torch.where((jg + 1 >= n_even)[:, None, None], sc, right)
        od = d + _tdiv(sc + right, 2)
        out[::2 * s, ::s] = sc
        out[s::2 * s, ::s] = od
        _lift_inv_strided(out[::s], 1, s, w_act)
    return out


# ---------------------------------------------------------------------------
# Global truncation allocation across tiles
# ---------------------------------------------------------------------------

def allocate_budget(layer_bytes, budget: int) -> np.ndarray:
    """Cut a fleet of tile streams to a global byte budget.

    ``layer_bytes``: (n_tiles, n_layers) integers (numpy or a CPU tensor),
    the bytes each tile adds at each quality layer of the shared
    progressive schedule (layer 0 = header and root).  Returns (n_tiles,)
    int64 byte lengths: every tile keeps its stream prefix through the
    deepest layer k such that the total over all tiles of layers <= k fits
    the budget; the remainder within layer k is handed out tile by tile
    (the reference truncates mid-layer, bytes.h:75-78, here coordinated
    across tiles).

    Sums are int64.  The JAX package sums in int32, so the two agree
    wherever its sums do not wrap (totals below 2^31 bytes)."""
    lb = np.asarray(layer_bytes, dtype=np.int64)
    cum = lb.sum(axis=0).cumsum()
    k = int((cum <= budget).sum())  # full layers afforded
    nl = lb.shape[1]
    taken = lb[:, :k].sum(axis=1)
    rem = max(budget - (int(cum[k - 1]) if k > 0 else 0), 0)
    nxt = lb[:, k] if k < nl else np.zeros(lb.shape[0], np.int64)
    pfx = np.cumsum(nxt) - nxt
    return taken + np.clip(rem - pfx, 0, nxt)
