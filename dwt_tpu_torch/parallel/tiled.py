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

The halo levels run on this rank's block as launches of a hand-written
kernel (``ops/halo.py``: kernel 18 forward, kernel 19 inverse;
:func:`launch_plan`): at world size 1 the two finest levels in one launch
and a launch a level after them (seven launches at 3840x2160), with
neighbours up to three launches a level with the two boundary rows
exchanged between them.  On a CPU mesh the same steps run the kernels'
plain versions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import Pyramid, compute_pyramid
from ..ops._launch import arena_layout, carve
from ..ops.halo import (BOT, NXT, PRV, TOP, Level, halo_forward,
                        halo_inverse, ll_shape)
from ..ops.lifting import dwt2d_fwd
from . import hosts


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
    """This rank's rows of the (H, W, C) image (a numpy array or tensor)
    on its device, as they are (uint8 for an image): the rows of its block
    of the padded image that lie in the image, none on a rank whose block
    is all pad.  Only these rows are copied; :func:`halo_dwt2d_fwd` reads
    the rows past them as zeros."""
    _, h_pad = _halo_plan(pyr, mesh.size)
    rb = h_pad // mesh.size
    return torch.as_tensor(img[mesh.rank * rb:(mesh.rank + 1) * rb]).to(
        mesh.device)


def _level_rules(pyr: Pyramid, t: int) -> tuple:
    """(stride, active width, even rows, updated evens) of level t's grid:
    the reference's even-N last-odd clamp and odd-N last-even no-update
    (cdf53.h:12-23) apply at these true-edge counts."""
    L = pyr.levels
    h_act, w_act = pyr.heights[L - t], pyr.widths[L - t]
    n_even = h_act - h_act // 2
    return 1 << t, w_act, n_even, n_even if h_act % 2 == 0 else n_even - 1


class Step(NamedTuple):
    """One step of a halo level on one rank: a launch of the level's kernel
    in ``mode`` (``ops/halo.py``), or, with ``mode`` "shift", an exchange:
    this rank sends its edge row ``send`` to rank ``rank - step`` and takes
    rank ``rank + step``'s into its edge row ``recv`` (``hosts.shift``)."""
    mode: str
    send: int = 0
    step: int = 0
    recv: int = 0


class Launch(NamedTuple):
    """A launch's halo levels of one rank (``ops/halo.py:Level``, finest
    first: one, or the pair of the two finest) and its steps in order."""
    levels: tuple
    steps: tuple


@functools.lru_cache(maxsize=256)
def launch_plan(pyr: Pyramid, n: int, rank: int,
                inverse: bool = False) -> tuple:
    """Rank ``rank``'s halo launches of ``n`` ranks (:class:`Launch`), in
    the order they run (the inverse's coarsest first).

    At world size 1 the two finest levels are one launch (the pair,
    ``ops/halo.py``) and every coarser level one more, each one "bulk".
    With neighbours a launch is one level, with the launches that run
    between its two exchanges.  Forward: the previous rank needs this
    rank's first row-lifted even row before its predict, so "head" writes
    it and the first exchange sends it; "bulk" runs the level and writes
    the last detail row, which the second exchange sends to the next rank,
    whose first even row's update ("fix") waits for it.  Inverse: the
    previous rank's last detail row is input data, so "pack" writes it and
    the first exchange sends it before any lifting; "head" un-updates the
    first even row with it, the second exchange sends that row to the
    previous rank, and "bulk" runs the level.  Every rank of several makes
    both exchanges (a rank without a neighbour on one side sends or
    receives nothing there); a rank with no previous rank has no "head"
    (nor, forward, "fix"), and, inverse, one with no next rank no
    "pack"."""
    n_halo, h_pad = _halo_plan(pyr, n)
    rb = h_pad // n
    levels = []
    for t in range(n_halo):
        s, w, n_even, n_upd = _level_rules(pyr, t)
        rows = rb // s
        levels.append(Level(s, w, rows, rank * rows // 2, n_even, n_upd,
                            rank > 0, rank < n - 1, t == n_halo - 1))
    if n == 1:
        groups = [levels[:2]] + [[lv] for lv in levels[2:]]
        plan = [Launch(tuple(g), (Step("bulk"),)) for g in groups if g]
    else:
        plan = []
        for lv in levels:
            head = (Step("head"),) if lv.prev else ()
            if inverse:
                steps = (((Step("pack"),) if lv.next else ())
                         + (Step("shift", BOT, -1, PRV),) + head
                         + (Step("shift", TOP, 1, NXT), Step("bulk")))
            else:
                steps = (head + (Step("shift", TOP, 1, NXT), Step("bulk"),
                                 Step("shift", BOT, -1, PRV))
                         + ((Step("fix"),) if lv.prev else ()))
            plan.append(Launch((lv,), steps))
    return tuple(plan[::-1] if inverse else plan)


@functools.lru_cache(maxsize=256)
def _layouts(pyr: Pyramid, n: int, rank: int, C: int, inverse: bool,
             to_bytes: bool) -> tuple:
    """The one allocation of a call's buffers (``ops/_launch.py``
    ``arena_layout``): each launch's output (the forward's compact LL
    quadrant of its last level; the inverse's grid of its first level,
    the finest uint8 where ``to_bytes``), then each launch's edge rows
    where the rank has neighbours."""
    plan = launch_plan(pyr, n, rank, inverse)
    specs = []
    for la in plan:
        lv = la.levels[0]
        if inverse:
            specs.append((torch.uint8 if to_bytes and lv.s == 1
                          else torch.int32, (lv.rows, lv.w, C)))
        else:
            specs.append((torch.int32, ll_shape(la.levels, C)))
    if n > 1:
        specs += [(torch.int32, (4, la.levels[0].w, C)) for la in plan]
    return arena_layout(specs)[:2]


def _buffers(ref: torch.Tensor, pyr: Pyramid, n: int, rank: int,
             inverse: bool, to_bytes: bool = False) -> list:
    """[(output, edge rows or None)] of each launch of the plan: views of
    one new allocation on ``ref``'s device."""
    plan = launch_plan(pyr, n, rank, inverse)
    nbytes, views = _layouts(pyr, n, rank, ref.shape[2], inverse, to_bytes)
    bufs = carve(nbytes, views, ref.device)
    edges = bufs[len(plan):] if n > 1 else [None] * len(plan)
    return list(zip(bufs[:len(plan)], edges))


def forward_levels(rows: torch.Tensor, pyr: Pyramid, n: int, rank: int,
                   colour: bool, fine: torch.Tensor, step=None):
    """A generator of rank ``rank``'s forward halo launches on its rows
    (see :func:`halo_dwt2d_fwd`), writing its fine block ``fine``: it
    yields (edge rows, :class:`Step`) at each exchange for the caller to
    make, and returns the coarsest level's compact LL quadrant.  ``step``:
    the launches' function (``ops/halo.py:halo_forward``, or its plain
    version; ``halo_forward`` when None)."""
    step = step or halo_forward
    src = rows
    plan = launch_plan(pyr, n, rank)
    for la, (ll, edge) in zip(plan, _buffers(fine, pyr, n, rank, False)):
        for st in la.steps:
            if st.mode == "shift":
                yield edge, st
            else:
                step(st.mode, la.levels, src,
                     colour and la.levels[0].s == 1, fine, ll, edge)
        src = ll
    return src


def inverse_levels(fb: torch.Tensor, pyr: Pyramid, n: int, rank: int,
                   to_bytes: bool, step=None):
    """A generator of rank ``rank``'s inverse halo launches on its
    coefficient block ``fb`` (see :func:`halo_dwt2d_inv`): it yields (edge
    rows, :class:`Step`) at each exchange for the caller to make, and
    returns the image block.  ``step``: ``ops/halo.py:halo_inverse``, or
    its plain version (``halo_inverse`` when None)."""
    step = step or halo_inverse
    ll = None
    plan = launch_plan(pyr, n, rank, inverse=True)
    for la, (out, edge) in zip(plan, _buffers(fb, pyr, n, rank, True,
                                              to_bytes)):
        for st in la.steps:
            if st.mode == "shift":
                yield edge, st
            else:
                step(st.mode, la.levels, fb, ll, edge, out)
        ll = out
    return ll


def run_levels(levels, mesh: hosts.Mesh):
    """Run a generator of :func:`forward_levels` or
    :func:`inverse_levels`, making its exchanges with ``hosts.shift``;
    returns its result."""
    while True:
        try:
            edge, st = next(levels)
        except StopIteration as done:
            return done.value
        hosts.shift(mesh, edge[st.send:st.send + 1], st.step,
                    edge[st.recv:st.recv + 1])


def play_ranks(levels: list) -> list:
    """Run the generators of every rank (:func:`forward_levels` or
    :func:`inverse_levels`, in rank order) in one process, in lockstep,
    making their exchanges by copying edge rows from rank to rank as
    ``hosts.shift`` moves them between processes; returns their results
    in rank order.  It checks the steps of several ranks on one device."""
    while True:
        got = []
        for g in levels:
            try:
                got.append(next(g))
            except StopIteration as done:
                got.append(done)
        if all(isinstance(x, StopIteration) for x in got):
            return [x.value for x in got]
        for r, (edge, st) in enumerate(got):
            if 0 <= r + st.step < len(got):
                edge[st.recv] = got[r + st.step][0][st.send]


def play_forward(img: torch.Tensor, pyr: Pyramid, n: int, colour: bool,
                 step=None) -> tuple:
    """The forward halo levels of the (H, W, C) image ``img`` as ``n`` ranks
    run them, played in one process (:func:`play_ranks`), ``step`` as in
    :func:`forward_levels`: (the whole (h_pad, W, C) fine buffer, the
    coarse grid every rank gathers)."""
    rb = _halo_plan(pyr, n)[1] // n
    fines = [torch.empty((rb,) + tuple(img.shape[1:]), dtype=torch.int32,
                         device=img.device) for _ in range(n)]
    grids = play_ranks([forward_levels(img[r * rb:(r + 1) * rb], pyr, n, r,
                                       colour, fines[r], step)
                        for r in range(n)])
    return torch.cat(fines), torch.cat(grids)


def play_inverse(fine: torch.Tensor, pyr: Pyramid, n: int, to_bytes: bool,
                 step=None) -> torch.Tensor:
    """The inverse halo levels of the whole (h_pad, W, C) fine buffer as
    ``n`` ranks run them, played in one process: the whole image buffer."""
    rb = fine.shape[0] // n
    return torch.cat(play_ranks([
        inverse_levels(fine[r * rb:(r + 1) * rb], pyr, n, r, to_bytes, step)
        for r in range(n)]))


def _check_block(name: str, xb: torch.Tensor, mesh: hosts.Mesh,
                 pyr: Pyramid, short: bool) -> int:
    """The rows of a rank's block; raises unless ``xb`` is (rb, W, C) (at
    most rb rows where ``short``) on the mesh's device."""
    rb = _halo_plan(pyr, mesh.size)[1] // mesh.size
    if xb.dim() != 3 or xb.shape[1] != pyr.width or xb.shape[0] > rb \
            or (xb.shape[0] < rb and not short):
        raise ValueError(f"{name}: a block of {tuple(xb.shape)} is not one "
                         f"of {mesh.size} blocks of ({rb * mesh.size}, "
                         f"{pyr.width}, C)")
    if xb.device != mesh.device:
        raise ValueError(f"{name}: a block on {xb.device} for a mesh on "
                         f"{mesh.device}")
    return rb


def halo_dwt2d_fwd(xb: torch.Tensor, mesh: hosts.Mesh, pyr: Pyramid,
                   colour: bool = False) -> tuple:
    """Forward multi-level 2-D DWT of a row-sharded image.

    ``xb``: this rank's rows of the padded image (:func:`rank_rows`), at
    most h_pad / n rows of (W, C), uint8 or int32 (other integer types are
    widened), on the mesh's device; the rows past them read as zeros, as
    :func:`pad_rows` makes them.  ``colour``: RGB rows, YCoCg-R applied as
    they load (C == 3).  Returns (fine, coarse): ``fine`` is this rank's
    (h_pad / n, W, C) int32 block of the interleaved buffer holding every
    halo level's results; ``coarse`` is the deinterleaved transform of the
    remaining levels' LL image, the same on every rank.  Reassemble with
    :func:`assemble_pyramid`.  On a card the levels are kernel 18's
    launches (:func:`launch_plan`); on a CPU mesh its plain version's.

    On arbitrary heights: the active grid of level t has exactly
    heights[L - t] real rows, all inside the image; the edge rules apply
    at the true boundary by global row index, so pad rows only ever
    receive garbage and never feed a real row."""
    rb = _check_block("halo_dwt2d_fwd", xb, mesh, pyr, short=True)
    if xb.dtype not in (torch.uint8, torch.int32):
        xb = xb.to(torch.int32)
    fine = torch.empty((rb, pyr.width, xb.shape[2]), dtype=torch.int32,
                       device=xb.device)
    ll = run_levels(forward_levels(xb.contiguous(), pyr, mesh.size,
                                   mesh.rank, colour, fine), mesh)
    # Gather the coarse active grid and finish it on every rank.
    n_halo, L = _halo_plan(pyr, mesh.size)[0], pyr.levels
    hc, wc = pyr.heights[L - n_halo], pyr.widths[L - n_halo]
    coarse = hosts.all_gather(mesh, ll)[:hc]
    if n_halo < L:
        coarse = dwt2d_fwd(coarse, compute_pyramid(wc, hc))
    return fine, coarse


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


def halo_dwt2d_inv(fb: torch.Tensor, mesh: hosts.Mesh, pyr: Pyramid,
                   to_bytes: bool = False) -> torch.Tensor:
    """Inverse multi-level 2-D DWT of a row-sharded coefficient buffer.

    ``fb``: this rank's (h_pad / n, W, C) int32 block of the interleaved
    halo layout with every coefficient placed (the coarse tail already
    inverted and written onto its dyadic grid, as ``ShardedDecoder`` does),
    on the mesh's device.  Mirrors :func:`halo_dwt2d_fwd`: level by level,
    coarsest first, the inverse column lifting with one row from each
    neighbour (un-update needs the previous rank's last odd, un-predict the
    next rank's first un-updated even), then the inverse row lifting
    (decode.c:16-30 order).  Returns this rank's int32 block of the image
    (rows >= H: garbage); with ``to_bytes`` its uint8 pixels instead: for
    RGB (C == 3) after the inverse colour and its decode-side clamps, then
    the clamp to [0, 255].  On a card the levels are kernel 19's launches
    (:func:`launch_plan`); on a CPU mesh its plain version's."""
    _check_block("halo_dwt2d_inv", fb, mesh, pyr, short=False)
    if fb.dtype != torch.int32:
        raise ValueError(f"halo_dwt2d_inv: an int32 block, not {fb.dtype}")
    return run_levels(inverse_levels(fb.contiguous(), pyr, mesh.size,
                                     mesh.rank, to_bytes), mesh)


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
