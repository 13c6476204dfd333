"""The levels of the row-sharded halo transform on one rank's block:
kernel 18, the forward level (``csrc/halo_lifting.cu``
``halo_fwd_kernel``), and kernel 19, the inverse level
(``halo_inv_kernel``), with their plain versions.

The JAX package compiles the whole sharded transform into one XLA program
inside ``shard_map`` (``dwt_tpu/parallel/tiled.py:halo_dwt2d_fwd`` and
``halo_dwt2d_inv`` with ``_lift_fwd_strided`` and ``_lift_inv_strided``,
the colour of ``dwt_tpu/parallel/encode.py:sharded_lin`` and
``ShardedDecoder``).  Here ``parallel/tiled.py`` runs the levels: each
level is one call of a wrapper below, or up to three where the rank has
neighbours, with the boundary rows exchanged between them
(``parallel/tiled.py:launch_plan``).

A level t (:class:`Level`) works on its grid: the rows and columns of the
rank's (h_pad / n, W, C) fine block at stride s = 2^t, ``rows`` by ``w``
samples of C channels.  The forward lifts each grid row (CDF 5/3,
interleaved: evens keep their places, odds hold the details), then each
grid column with the true-edge rules of the whole image applied by global
row index: the odd row whose even neighbour below lies at or past
``n_even`` clamps to its own even, and evens from ``n_upd`` on keep their
value.  Its input (``src``) is compact: the image's rows at level 0 (uint8
or int32; rows past the tensor's read as zeros, so no padded copy is
made; with ``colour`` the YCoCg-R as they load), the level before's LL
quadrant after.  It writes the detail quadrants into the fine block at
their grid places and the LL quadrant compact into ``ll``, the next
level's input (the coarsest level writes it into the fine block too, and
so does level 0, whose values there the next level overwrites: its rows
then go out in whole sectors).
The inverse mirrors it, coarsest first: columns un-updated and
un-predicted, then rows; its LL input is ``ll``, the level before's
compact output (None at the coarsest level, whose LL lies in the fine
block), and its output the compact grid, at level 0 the image block
(int32, or uint8 pixels: for RGB the inverse colour and its decode-side
clamps, then the clamp to [0, 255] and the cast).

Where a rank has neighbours a level needs rows of theirs, which lie in
``edge``, an (4, w, C) int32 tensor of one row each: ``TOP`` (the row
this rank sends to the previous rank), ``BOT`` (to the next), ``NXT``
(received from the next) and ``PRV`` (from the previous).  The modes:

* forward ``"head"``: the row-lifted first even row into ``TOP``;
  ``"bulk"``: the whole level (the first even row's column update left
  for ``"fix"`` where there is a previous rank; the last odd row's even
  neighbour from ``NXT`` where there is a next one), the last detail row
  into ``BOT``; ``"fix"``: the first even row's update with ``PRV``.
* inverse ``"pack"``: the last detail row into ``BOT``; ``"head"``: the
  first even row un-updated with ``PRV`` into ``TOP``; ``"bulk"``: the
  whole level.

On the card every call is one launch (``launches`` grows by one); on CPU
tensors the plain version runs, whole-tensor slice arithmetic on the same
buffers.  Every division truncates toward zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..runtime import build
from ._launch import cuda_or_cpu
from .color import rgb_to_ycocg, ycocg_to_rgb

TOP, BOT, NXT, PRV = range(4)  # the rows of ``edge``
FORWARD_MODES = ("head", "bulk", "fix")
INVERSE_MODES = ("pack", "head", "bulk")
# Warps a bulk launch aims for: row pairs a warp (a power of two, 16 at
# most) are halved until the launch has at least this many.
WARP_TARGET = 4096
STRIP = 28  # grid columns a warp stores (csrc STRIP: lanes 2..29)


class Level(NamedTuple):
    """One halo level of one rank's block: the grid's stride ``s`` in the
    fine block, its ``w`` columns and ``rows`` rows (even), the global
    index ``g0`` of its first even row, the true edge's ``n_even`` and
    ``n_upd`` (``parallel/tiled.py:_level_rules``), whether a previous
    and a next rank exist, and whether it is the coarsest halo level."""
    s: int
    w: int
    rows: int
    g0: int
    n_even: int
    n_upd: int
    prev: bool
    next: bool
    coarsest: bool


def _tdiv(a: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(a, d, rounding_mode="trunc")


def _grid(fine: torch.Tensor, lv: Level) -> torch.Tensor:
    """The level's (rows, w, C) grid, a strided view of the fine block."""
    return fine[::lv.s, ::lv.s]


def _lift_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row of (R, n, C) int32 lifted along itself, interleaved: the
    evens' low-pass values and the odds' details at their places."""
    n = x.shape[1]
    ev, od = x[:, 0::2], x[:, 1::2]
    ne, no = ev.shape[1], od.shape[1]
    right = ev[:, 1:] if ne > no else torch.cat([ev[:, 1:], ev[:, -1:]], 1)
    d = od - _tdiv(ev[:, :no] + right, 2)
    upd = _tdiv(torch.cat([d[:, :1], d[:, :-1]], 1) + d, 4)
    nupd = ne if n % 2 == 0 else ne - 1
    out = torch.empty_like(x)
    out[:, 0::2] = torch.cat([ev[:, :nupd] + upd[:, :nupd], ev[:, nupd:]], 1)
    out[:, 1::2] = d
    return out


def _unlift_rows(y: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_lift_rows`: evens un-updated, then odds
    un-predicted (cdf53.h:36-61 order and signs)."""
    n = y.shape[1]
    s, d = y[:, 0::2], y[:, 1::2]
    ne, no = s.shape[1], d.shape[1]
    upd = _tdiv(torch.cat([d[:, :1], d[:, :-1]], 1) + d, 4)
    nupd = ne if n % 2 == 0 else ne - 1
    ev = torch.cat([s[:, :nupd] - upd[:, :nupd], s[:, nupd:]], 1)
    right = ev[:, 1:] if ne > no else torch.cat([ev[:, 1:], ev[:, -1:]], 1)
    out = torch.empty_like(y)
    out[:, 0::2] = ev
    out[:, 1::2] = d + _tdiv(ev[:, :no] + right, 2)
    return out


def _even_index(lv: Level, device) -> torch.Tensor:
    """(rows / 2, 1, 1): the global index of each even grid row."""
    return lv.g0 + torch.arange(lv.rows // 2, device=device)[:, None, None]


def _first_even(lv: Level, fine: torch.Tensor, ll) -> torch.Tensor:
    """The (w, C) first even grid row as the level holds it: its LL
    columns from ``ll`` (the fine block where ``ll`` is None), the others
    from the fine block."""
    e = _grid(fine, lv)[0].clone()
    if ll is not None:
        e[0::2] = ll[0]
    return e


# --- kernel 18: the forward level -------------------------------------------

def _forward_head(lv, src, colour, edge) -> None:
    x = src[:1].to(torch.int32)
    if x.shape[0] == 0:
        x = x.new_zeros((1,) + tuple(x.shape[1:]))
    edge[TOP] = _lift_rows(rgb_to_ycocg(x) if colour else x)[0]


def _forward_bulk(lv, src, colour, fine, ll, edge) -> None:
    x = src.to(torch.int32)
    if colour:
        x = rgb_to_ycocg(x)
    if x.shape[0] < lv.rows:  # the rows past the image: zeros
        x = torch.cat([x, x.new_zeros((lv.rows - x.shape[0],)
                                      + tuple(x.shape[1:]))])
    x = _lift_rows(x)
    ev, od = x[0::2], x[1::2]
    jg = _even_index(lv, x.device)
    # Predict: odd j's even neighbour below is even j + 1 (the next rank's
    # first even for the last odd here); at the true edge the odd clamps
    # to its own even (cdf53.h:15-17).
    right = torch.cat([ev[1:], edge[NXT:NXT + 1] if lv.next else ev[-1:]])
    d = od - _tdiv(ev + torch.where(jg + 1 >= lv.n_even, ev, right), 2)
    # Update: even j's odd neighbour above is odd j - 1; the global first
    # even clamps to its own odd (cdf53.h:19-20); evens from n_upd keep
    # their value.  A previous rank's last odd comes in "fix".
    left = torch.cat([d[:1], d[:-1]])
    sc = torch.where(jg < lv.n_upd, ev + _tdiv(left + d, 4), ev)
    if lv.prev:
        sc[0] = ev[0]
    g = _grid(fine, lv)
    g[1::2] = d
    g[0::2, 1::2] = sc[:, 1::2]
    ll.copy_(sc[:, 0::2])
    if lv.coarsest or lv.s == 1:  # level 0: the next level overwrites it
        g[0::2, 0::2] = sc[:, 0::2]
    edge[BOT] = d[-1]


def _forward_fix(lv, fine, ll, edge) -> None:
    if lv.g0 >= lv.n_upd:  # the first even keeps its value
        return
    g = _grid(fine, lv)
    s0 = _first_even(lv, fine, ll) + _tdiv(edge[PRV] + g[1], 4)
    g[0, 1::2] = s0[1::2]
    ll[0] = s0[0::2]
    if lv.coarsest or lv.s == 1:
        g[0, 0::2] = s0[0::2]


def halo_forward_plain(mode: str, lv: Level, src: torch.Tensor,
                       colour: bool, fine: torch.Tensor, ll: torch.Tensor,
                       edge: torch.Tensor) -> tuple:
    """Plain PyTorch version of :func:`halo_forward`."""
    if mode == "head":
        _forward_head(lv, src, colour, edge)
    elif mode == "bulk":
        _forward_bulk(lv, src, colour, fine, ll, edge)
    else:
        _forward_fix(lv, fine, ll, edge)
    return fine, ll, edge


def _check(name: str, modes: tuple, mode: str, lv: Level, fine, edge,
           C: int) -> None:
    if mode not in modes:
        raise ValueError(f"{name}: mode {mode!r} is not one of {modes}")
    if fine.dim() != 3 or fine.dtype != torch.int32 or fine.shape[2] != C \
            or fine.shape[0] != lv.rows * lv.s \
            or -(-fine.shape[1] // lv.s) != lv.w:
        raise ValueError(f"{name}: a fine block of {tuple(fine.shape)} "
                         f"{fine.dtype} has no ({lv.rows}, {lv.w}, {C}) "
                         f"int32 grid at stride {lv.s}")
    if tuple(edge.shape) != (4, lv.w, C) or edge.dtype != torch.int32:
        raise ValueError(f"{name}: edge must be (4, {lv.w}, {C}) int32, not "
                         f"{tuple(edge.shape)} {edge.dtype}")
    if lv.rows < 2 or lv.rows % 2 or lv.w < 2 or C not in (1, 3):
        raise ValueError(f"{name}: a level of {lv.rows} rows, {lv.w} "
                         f"columns and {C} channels")


def _contiguous(name: str, tensors) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")


def band_pairs(lv: Level) -> int:
    """Row pairs a warp of a bulk launch: halved from 16 until the launch
    has ``WARP_TARGET`` warps."""
    strips, bp = -(-lv.w // STRIP), 16
    while bp > 1 and strips * -(-(lv.rows // 2) // bp) < WARP_TARGET:
        bp //= 2
    return bp


def _args(lv: Level, C: int, fine, edge, src=None, colour=False, ll=None,
          out=None) -> build.HaloArgs:
    """The level's struct for the C entry point: ``colour`` the forward's;
    the inverse's uint8 RGB output has it."""
    to_bytes = out is not None and out.dtype == torch.uint8
    colour = colour or (to_bytes and C == 3)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return build.HaloArgs(
        ptr(src), fine.data_ptr(), ptr(ll), edge.data_ptr(), ptr(out),
        fine.shape[1] * C, 0 if src is None else src.shape[0],
        int(src is not None and src.dtype == torch.uint8), int(colour),
        int(to_bytes), lv.s, lv.w,
        lv.rows, lv.g0, lv.n_even, lv.n_upd, int(lv.prev), int(lv.next),
        int(lv.coarsest), C, band_pairs(lv))


def halo_forward(mode: str, lv: Level, src: torch.Tensor, colour: bool,
                 fine: torch.Tensor, ll: torch.Tensor,
                 edge: torch.Tensor) -> tuple:
    """One step of forward level ``lv`` (``mode``: "head", "bulk" or
    "fix", the module docstring), in place.  ``src``: the level's input,
    (r <= rows, w, C) uint8 or int32 (``colour``: RGB rows, C == 3);
    ``fine``: the rank's (rows * s, W, C) int32 block; ``ll``: (rows / 2,
    ceil(w / 2), C) int32; ``edge``: (4, w, C) int32.  Returns (fine, ll,
    edge).  On the card one launch."""
    C = fine.shape[-1] if fine.dim() == 3 else 0
    _check("halo_forward", FORWARD_MODES, mode, lv, fine, edge, C)
    if src.dim() != 3 or src.shape[0] > lv.rows \
            or tuple(src.shape[1:]) != (lv.w, C) \
            or src.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"halo_forward: input rows of {tuple(src.shape)} "
                         f"{src.dtype} are not at most {lv.rows} uint8 or "
                         f"int32 rows of ({lv.w}, {C})")
    if colour and C != 3:
        raise ValueError("halo_forward: the colour transform needs 3 "
                         "channels")
    if tuple(ll.shape) != (lv.rows // 2, (lv.w + 1) // 2, C) \
            or ll.dtype != torch.int32:
        raise ValueError(f"halo_forward: ll must be ({lv.rows // 2}, "
                         f"{(lv.w + 1) // 2}, {C}) int32, not "
                         f"{tuple(ll.shape)} {ll.dtype}")
    if not cuda_or_cpu("halo_forward", (src, fine, ll, edge)):
        return halo_forward_plain(mode, lv, src, colour, fine, ll, edge)
    _contiguous("halo_forward", (src, fine, ll, edge))
    build.check(build.library().dwt_halo_forward(
        _args(lv, C, fine, edge, src, colour, ll),
        FORWARD_MODES.index(mode), build.stream_of(fine)), "halo_forward")
    halo_forward.launches += 1
    return fine, ll, edge


halo_forward.launches = 0


# --- kernel 19: the inverse level -------------------------------------------

def _inverse_bulk(lv, fine, ll, edge, out) -> None:
    g = _grid(fine, lv)
    e = g[0::2].clone()
    e[:, 0::2] = g[0::2, 0::2] if ll is None else ll
    d = g[1::2]
    jg = _even_index(lv, e.device)
    left = torch.cat([edge[PRV:PRV + 1] if lv.prev else d[:1], d[:-1]])
    sc = torch.where(jg < lv.n_upd, e - _tdiv(left + d, 4), e)
    right = torch.cat([sc[1:], edge[NXT:NXT + 1] if lv.next else sc[-1:]])
    od = d + _tdiv(sc + torch.where(jg + 1 >= lv.n_even, sc, right), 2)
    y = _unlift_rows(torch.stack([sc, od], 1).reshape(out.shape))
    if out.dtype == torch.uint8:
        y = (ycocg_to_rgb(y) if y.shape[2] == 3 else y).clamp(0, 255)
    out.copy_(y)


def _inverse_head(lv, fine, ll, edge) -> None:
    e = _first_even(lv, fine, ll)
    edge[TOP] = (e - _tdiv(edge[PRV] + _grid(fine, lv)[1], 4)
                 if lv.g0 < lv.n_upd else e)


def halo_inverse_plain(mode: str, lv: Level, fine: torch.Tensor, ll,
                       edge: torch.Tensor, out: torch.Tensor) -> tuple:
    """Plain PyTorch version of :func:`halo_inverse`."""
    if mode == "pack":
        edge[BOT] = _grid(fine, lv)[-1]
    elif mode == "head":
        _inverse_head(lv, fine, ll, edge)
    else:
        _inverse_bulk(lv, fine, ll, edge, out)
    return out, edge


def halo_inverse(mode: str, lv: Level, fine: torch.Tensor, ll,
                 edge: torch.Tensor, out: torch.Tensor) -> tuple:
    """One step of inverse level ``lv`` (``mode``: "pack", "head" or
    "bulk", the module docstring).  ``fine``: the rank's (rows * s, W, C)
    int32 coefficient block (read only); ``ll``: the level's LL quadrant,
    (rows / 2, ceil(w / 2), C) int32, or None where it lies in ``fine``;
    ``edge``: (4, w, C) int32 (its rows written in place); ``out``: the
    level's (rows, w, C) output, int32, or uint8 pixels (for RGB, C == 3,
    the inverse colour and its decode-side clamps, then the clamp to [0,
    255] and the cast).  Returns (out, edge).  On the card one launch."""
    C = fine.shape[-1] if fine.dim() == 3 else 0
    _check("halo_inverse", INVERSE_MODES, mode, lv, fine, edge, C)
    if ll is not None and (tuple(ll.shape) != (lv.rows // 2,
                                               (lv.w + 1) // 2, C)
                           or ll.dtype != torch.int32):
        raise ValueError(f"halo_inverse: ll must be ({lv.rows // 2}, "
                         f"{(lv.w + 1) // 2}, {C}) int32, not "
                         f"{tuple(ll.shape)} {ll.dtype}")
    if tuple(out.shape) != (lv.rows, lv.w, C) \
            or out.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"halo_inverse: out must be ({lv.rows}, {lv.w}, "
                         f"{C}) int32 or uint8, not {tuple(out.shape)} "
                         f"{out.dtype}")
    given = [t for t in (fine, ll, edge, out) if t is not None]
    if not cuda_or_cpu("halo_inverse", given):
        return halo_inverse_plain(mode, lv, fine, ll, edge, out)
    _contiguous("halo_inverse", given)
    build.check(build.library().dwt_halo_inverse(
        _args(lv, C, fine, edge, ll=ll, out=out),
        INVERSE_MODES.index(mode), build.stream_of(fine)), "halo_inverse")
    halo_inverse.launches += 1
    return out, edge


halo_inverse.launches = 0
