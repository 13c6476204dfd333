"""The levels of the row-sharded halo transform on one rank's block:
kernel 18, the forward (``csrc/halo_lifting.cu`` ``halo_fwd_kernel``),
and kernel 19, the inverse (``halo_inv_kernel``), with their plain
versions.

The JAX package compiles the whole sharded transform into one XLA program
inside ``shard_map`` (``dwt_tpu/parallel/tiled.py:halo_dwt2d_fwd`` and
``halo_dwt2d_inv`` with ``_lift_fwd_strided`` and ``_lift_inv_strided``,
the colour of ``dwt_tpu/parallel/encode.py:sharded_lin`` and
``ShardedDecoder``).  Here ``parallel/tiled.py`` runs the levels
(``parallel/tiled.py:launch_plan``): a launch takes one level, or, on a
rank without neighbours, the pair of the two finest levels (the inverse:
level 1 then level 0); where the rank has neighbours a level is up to
three calls of a wrapper below with the boundary rows exchanged between
them.

A level t (:class:`Level`) works on its grid: the rows and columns of the
rank's (h_pad / n, W, C) fine block at stride s = 2^t, ``rows`` by ``w``
samples of C channels.  The forward lifts each grid row (CDF 5/3,
interleaved: evens keep their places, odds hold the details), then each
grid column with the true-edge rules of the whole image applied by global
row index: the odd row whose even neighbour below lies at or past
``n_even`` clamps to its own even, and evens from ``n_upd`` on keep their
value.  A launch's input (``src``) is compact: the image's rows at level
0 (uint8 or int32; rows past the tensor's read as zeros, so no padded
copy is made; with ``colour`` the YCoCg-R as they load), the launch
before's LL quadrant after.  A level writes the detail quadrants into the
fine block at their grid places, and its LL positions too where it is
level 0, the coarsest or the pair's second (the next level overwrites
them; level 0's and the pair's fine rows then go out whole); a launch
writes its last level's LL quadrant compact into ``ll``, the next
launch's input.  The inverse mirrors it, coarsest first: columns
un-updated and un-predicted, then rows; its LL input is ``ll``, the
launch before's compact output (None at the coarsest level, whose LL lies
in the fine block), and its output ``out`` its first level's compact
grid, at level 0 the image block (int32, or uint8 pixels: for RGB the
inverse colour and its decode-side clamps, then the clamp to [0, 255]
and the cast).

Where a rank has neighbours a level needs rows of theirs, which lie in
``edge``, an (4, w, C) int32 tensor of one row each: ``TOP`` (the row
this rank sends to the previous rank), ``BOT`` (to the next), ``NXT``
(received from the next) and ``PRV`` (from the previous).  The modes of a
one-level launch:

* forward ``"head"``: the row-lifted first even row into ``TOP``;
  ``"bulk"``: the whole level (the first even row's column update left
  for ``"fix"`` where there is a previous rank; the last odd row's even
  neighbour from ``NXT`` where there is a next one), the last detail row
  into ``BOT`` where there is a next rank; ``"fix"``: the first even
  row's update with ``PRV``.
* inverse ``"pack"``: the last detail row into ``BOT``; ``"head"``: the
  first even row un-updated with ``PRV`` into ``TOP``; ``"bulk"``: the
  whole level.

The pair is ``"bulk"`` alone.  On the card every call is one launch
(``launches`` grows by one); on CPU tensors the plain version runs,
whole-tensor slice arithmetic level by level on the same buffers.  Every
division truncates toward zero.

The kernels are bound by bytes: at 3840x2160 RGB the pair moves about
140 MB (the image in, the int32 fine block and level 1's LL quadrant out,
or the reverse to pixels), 0.04 ms at the card's 3.35 TB/s, and each
later level a sixteenth of that.  A one-level launch gives a warp a strip
of 28 columns and a band of row pairs, the rows lifted by shuffles; the
pair gives a block a tile of 504 columns, its input rows staged into
shared memory ahead of the lifting by 16-byte asynchronous copies, and
keeps level 0's LL quadrant on the chip, so that each fine row leaves
once, whole, and only level 1's LL quadrant goes out.  Each design runs
where it was the faster on an H100 (``csrc/halo_lifting.cu``'s note).
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
# Warps a one-level bulk launch aims for: row pairs a warp (a power of
# two, 16 at most) are halved until the launch has at least this many.
WARP_TARGET = 4096
STRIP = 28  # grid columns a warp stores (csrc strip::STRIP: lanes 2..29)


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


# --- kernel 18: the forward -------------------------------------------------

def _forward_head(lv, src, colour, edge) -> None:
    x = src[:1].to(torch.int32)
    if x.shape[0] == 0:
        x = x.new_zeros((1,) + tuple(x.shape[1:]))
    edge[TOP] = _lift_rows(rgb_to_ycocg(x) if colour else x)[0]


def _forward_level(lv, x, fine, edge, whole) -> torch.Tensor:
    """Level ``lv`` of its int32 input rows ``x`` (the rows past them
    zeros): its detail quadrants into the fine block, its LL positions too
    where ``whole``; the last detail row into ``BOT`` where there is a
    next rank; returns its compact LL quadrant."""
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
    if whole:
        g[0::2] = sc
    else:
        g[0::2, 1::2] = sc[:, 1::2]
    if lv.next:
        edge[BOT] = d[-1]
    return sc[:, 0::2]


def _whole(levels: tuple, lv: Level) -> bool:
    """Whether level ``lv`` of a launch writes its LL positions into the
    fine block: level 0, the coarsest, the pair's second."""
    return lv.s == 1 or lv.coarsest or len(levels) == 2


def _forward_fix(lv, fine, ll, edge) -> None:
    if lv.g0 >= lv.n_upd:  # the first even keeps its value
        return
    g = _grid(fine, lv)
    s0 = _first_even(lv, fine, ll) + _tdiv(edge[PRV] + g[1], 4)
    g[0, 1::2] = s0[1::2]
    ll[0] = s0[0::2]
    if _whole((lv,), lv):
        g[0, 0::2] = s0[0::2]


def halo_forward_plain(mode: str, levels: tuple, src: torch.Tensor,
                       colour: bool, fine: torch.Tensor, ll: torch.Tensor,
                       edge) -> tuple:
    """Plain PyTorch version of :func:`halo_forward`."""
    if mode == "head":
        _forward_head(levels[0], src, colour, edge)
    elif mode == "fix":
        _forward_fix(levels[0], fine, ll, edge)
    else:
        x = src.to(torch.int32)
        if colour:
            x = rgb_to_ycocg(x)
        for lv in levels:
            x = _forward_level(lv, x, fine, edge, _whole(levels, lv))
        ll.copy_(x)
    return fine, ll, edge


def _check(name: str, modes: tuple, mode: str, levels: tuple, fine, edge,
           C: int) -> None:
    if mode not in modes:
        raise ValueError(f"{name}: mode {mode!r} is not one of {modes}")
    if len(levels) not in (1, 2) or (mode != "bulk" and len(levels) != 1):
        raise ValueError(f"{name}: {len(levels)} levels for mode {mode!r}")
    if len(levels) == 2:
        a, b = levels
        if a.s != 1 or (b.s, b.w, b.rows, b.g0) != (
                2, -(-a.w // 2), a.rows // 2, a.g0 // 2):
            raise ValueError(f"{name}: levels {a} and {b} are not the two "
                             f"finest")
        if any(lv.prev or lv.next for lv in levels):
            raise ValueError(f"{name}: a pair of levels on a rank with "
                             f"neighbours")
    lv = levels[0]
    if fine.dim() != 3 or fine.dtype != torch.int32 or fine.shape[2] != C \
            or fine.shape[0] != lv.rows * lv.s \
            or -(-fine.shape[1] // lv.s) != lv.w:
        raise ValueError(f"{name}: a fine block of {tuple(fine.shape)} "
                         f"{fine.dtype} has no ({lv.rows}, {lv.w}, {C}) "
                         f"int32 grid at stride {lv.s}")
    sided = lv.prev or lv.next or mode != "bulk"
    if (edge is None and sided) or (edge is not None and (
            tuple(edge.shape) != (4, lv.w, C) or edge.dtype != torch.int32)):
        raise ValueError(f"{name}: edge must be (4, {lv.w}, {C}) int32"
                         + ("" if sided else " or None") + ", not "
                         + ("None" if edge is None else
                            f"{tuple(edge.shape)} {edge.dtype}"))
    if any(v.rows < 2 or v.rows % 2 or v.w < 2 for v in levels) \
            or C not in (1, 3):
        raise ValueError(f"{name}: levels of {[v.rows for v in levels]} "
                         f"rows, {[v.w for v in levels]} columns and {C} "
                         f"channels")


def ll_shape(levels: tuple, C: int) -> tuple:
    """The compact LL quadrant of a launch's last level: what the forward
    writes and the inverse reads."""
    lv = levels[-1]
    return (lv.rows // 2, (lv.w + 1) // 2, C)


def _check_ll(name: str, levels: tuple, ll, C: int) -> None:
    if tuple(ll.shape) != ll_shape(levels, C) or ll.dtype != torch.int32:
        raise ValueError(f"{name}: ll must be {ll_shape(levels, C)} int32, "
                         f"not {tuple(ll.shape)} {ll.dtype}")


def _contiguous(name: str, tensors) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")


def band_pairs(lv: Level) -> int:
    """Row pairs a warp of a one-level bulk launch: halved from 16 until
    the launch has ``WARP_TARGET`` warps."""
    strips, bp = -(-lv.w // STRIP), 16
    while bp > 1 and strips * -(-(lv.rows // 2) // bp) < WARP_TARGET:
        bp //= 2
    return bp


def _args(lv: Level, C: int, fine, edge, src=None, colour=False, ll=None,
          out=None) -> build.HaloArgs:
    """A one-level launch's struct for its C entry point: ``colour`` the
    forward's; the inverse's uint8 RGB output has it."""
    to_bytes = out is not None and out.dtype == torch.uint8
    colour = colour or (to_bytes and C == 3)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return build.HaloArgs(
        ptr(src), fine.data_ptr(), ptr(ll), ptr(edge), ptr(out),
        fine.shape[1] * C, 0 if src is None else src.shape[0],
        int(src is not None and src.dtype == torch.uint8), int(colour),
        int(to_bytes), lv.s, lv.w,
        lv.rows, lv.g0, lv.n_even, lv.n_upd, int(lv.prev), int(lv.next),
        int(lv.coarsest), C, band_pairs(lv))


def _pair_args(levels: tuple, C: int, fine, src=None, colour=False,
               ll=None, out=None) -> build.PairArgs:
    """The pair's struct for its C entry point, as :func:`_args`."""
    to_bytes = out is not None and out.dtype == torch.uint8
    colour = colour or (to_bytes and C == 3)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return build.PairArgs(
        ptr(src), fine.data_ptr(), ptr(ll), ptr(out), fine.shape[1] * C,
        0 if src is None else src.shape[0],
        int(src is not None and src.dtype == torch.uint8), int(colour),
        int(to_bytes), C, 0,
        (build.HaloLevel * 2)(*[build.HaloLevel(*map(int, lv))
                                for lv in levels]))


def _forward_call(lib, stream, mode: str, levels: tuple, C: int, src,
                  colour, fine, ll, edge) -> int:
    """A forward launch by its C entry point in ``lib`` (the built kernels)
    on ``stream``; the entry point's error code."""
    if len(levels) == 2:
        return lib.dwt_halo_forward_pair(
            _pair_args(levels, C, fine, src, colour, ll), stream)
    return lib.dwt_halo_forward(_args(levels[0], C, fine, edge, src, colour,
                                      ll), FORWARD_MODES.index(mode), stream)


def _inverse_call(lib, stream, mode: str, levels: tuple, C: int, fine, ll,
                  edge, out) -> int:
    """An inverse launch as :func:`_forward_call`."""
    if len(levels) == 2:
        return lib.dwt_halo_inverse_pair(
            _pair_args(levels, C, fine, ll=ll, out=out), stream)
    return lib.dwt_halo_inverse(_args(levels[0], C, fine, edge, ll=ll,
                                      out=out), INVERSE_MODES.index(mode),
                                stream)


def halo_forward(mode: str, levels: tuple, src: torch.Tensor, colour: bool,
                 fine: torch.Tensor, ll: torch.Tensor, edge) -> tuple:
    """One launch of the forward over ``levels`` (a tuple of one
    :class:`Level`, or of the two finest on a rank without neighbours;
    ``mode``: "head", "bulk" or "fix", the module docstring), in place.
    ``src``: the first level's input, (r <= rows, w, C) uint8 or int32
    (``colour``: RGB rows, C == 3); ``fine``: the rank's (rows * s, W, C)
    int32 block; ``ll``: the last level's compact LL quadrant
    (:func:`ll_shape`), int32; ``edge``: (4, w, C) int32, or None for a
    bulk launch on a rank without neighbours.  Returns (fine, ll, edge).
    On the card one launch."""
    C = fine.shape[-1] if fine.dim() == 3 else 0
    _check("halo_forward", FORWARD_MODES, mode, levels, fine, edge, C)
    lv = levels[0]
    if src.dim() != 3 or src.shape[0] > lv.rows \
            or tuple(src.shape[1:]) != (lv.w, C) \
            or src.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"halo_forward: input rows of {tuple(src.shape)} "
                         f"{src.dtype} are not at most {lv.rows} uint8 or "
                         f"int32 rows of ({lv.w}, {C})")
    if colour and C != 3:
        raise ValueError("halo_forward: the colour transform needs 3 "
                         "channels")
    _check_ll("halo_forward", levels, ll, C)
    given = [t for t in (src, fine, ll, edge) if t is not None]
    if not cuda_or_cpu("halo_forward", given):
        return halo_forward_plain(mode, levels, src, colour, fine, ll, edge)
    _contiguous("halo_forward", given)
    build.check(_forward_call(build.library(), build.stream_of(fine), mode,
                              levels, C, src, colour, fine, ll, edge),
                "halo_forward")
    halo_forward.launches += 1
    return fine, ll, edge


halo_forward.launches = 0


# --- kernel 19: the inverse -------------------------------------------------

def _inverse_level(lv, fine, ll, edge, out) -> None:
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


def halo_inverse_plain(mode: str, levels: tuple, fine: torch.Tensor, ll,
                       edge, out: torch.Tensor) -> tuple:
    """Plain PyTorch version of :func:`halo_inverse`."""
    lv = levels[0]
    if mode == "pack":
        edge[BOT] = _grid(fine, lv)[-1]
    elif mode == "head":
        _inverse_head(lv, fine, ll, edge)
    else:
        for lv in levels[::-1]:
            grid = out if lv is levels[0] else fine.new_empty(
                (lv.rows, lv.w, fine.shape[2]))
            _inverse_level(lv, fine, ll, edge, grid)
            ll = grid
    return out, edge


def halo_inverse(mode: str, levels: tuple, fine: torch.Tensor, ll, edge,
                 out: torch.Tensor) -> tuple:
    """One launch of the inverse over ``levels`` (a tuple of one
    :class:`Level`, or of the two finest on a rank without neighbours, run
    coarsest first; ``mode``: "pack", "head" or "bulk", the module
    docstring).  ``fine``: the rank's (rows * s, W, C) int32 coefficient
    block (read only); ``ll``: the last level's LL quadrant
    (:func:`ll_shape`) int32, or None where it lies in ``fine``; ``edge``:
    (4, w, C) int32 (its rows written in place), or None for a bulk
    launch on a rank without neighbours; ``out``: the first level's
    (rows, w, C) output, int32, or uint8 pixels (for RGB, C == 3, the
    inverse colour and its decode-side clamps, then the clamp to [0, 255]
    and the cast).  Returns (out, edge).  On the card one launch."""
    C = fine.shape[-1] if fine.dim() == 3 else 0
    _check("halo_inverse", INVERSE_MODES, mode, levels, fine, edge, C)
    if ll is not None:
        _check_ll("halo_inverse", levels, ll, C)
    lv = levels[0]
    if tuple(out.shape) != (lv.rows, lv.w, C) \
            or out.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"halo_inverse: out must be ({lv.rows}, {lv.w}, "
                         f"{C}) int32 or uint8, not {tuple(out.shape)} "
                         f"{out.dtype}")
    given = [t for t in (fine, ll, edge, out) if t is not None]
    if not cuda_or_cpu("halo_inverse", given):
        return halo_inverse_plain(mode, levels, fine, ll, edge, out)
    _contiguous("halo_inverse", given)
    build.check(_inverse_call(build.library(), build.stream_of(fine), mode,
                              levels, C, fine, ll, edge, out),
                "halo_inverse")
    halo_inverse.launches += 1
    return out, edge


halo_inverse.launches = 0
