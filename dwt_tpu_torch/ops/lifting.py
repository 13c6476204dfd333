"""Integer CDF 5/3 lifting, forward and inverse (port of
``dwt_tpu/ops/lifting.py``), the encoder's forward transform (kernel 9,
``csrc/lifting.cu``) and the decoder's inverse transform (kernel 16,
``csrc/lifting_inv.cu``).

Every division truncates toward zero (C semantics, never Python's floor);
odd-length boundary rules follow the reference's cdf53.h:11-33: clamped
neighbours, and no update on the last even sample of an odd-N signal.

:func:`forward_transform` takes N (N, H, W, C) frames to their (N, H, W,
C) int32 coefficients, the YCoCg-R colour transform first for RGB.  On the
card (:func:`launch_levels`): one ``lift_level_kernel`` launch for each
large level, finest first, then one ``lift_tail_kernel`` launch for every
level from the first whose input holds at most ``TAIL_SAMPLES`` samples a
channel (``launches`` grows by ``len(launch_levels(pyr))``).  uint8
frames are read as bytes and the colour transform is applied as the
finest level loads; each large level's detail quadrants go straight into
the coefficients and its LL quadrant into one of two ping-pong buffers,
the next launch's input.  On the CPU: :func:`forward_transform_plain`,
whole-axis slice arithmetic over all rows or columns of a level at once
(:func:`dwt2d_fwd_plain`).

:func:`inverse_transform` is its mirror: N (N, H, W, C) int32 coefficient
pyramids back to pixels, the levels of a ``chain`` of (h, w) output sizes
lifted coarsest first, then the inverse colour transform, the clamps and
the uint8 cast where asked.  On the card (:func:`unlift_plan`): one
``inverse_tail_kernel`` launch for every level whose output holds at most
``TAIL_SAMPLES`` samples a channel, then one ``inverse_level_kernel``
launch for each larger level, coarsest first, each reading the LL quadrant
the launch before wrote into one of two ping-pong buffers and writing its
output into the other, or, at the finest level, into the result with the
colour, clamps and cast applied as it stores.  On the CPU:
:func:`inverse_transform_plain`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..geometry import Pyramid
from ..runtime import build
from ._launch import cuda_or_cpu, on_card
from .color import rgb_to_ycocg, ycocg_to_rgb

# Samples a channel of the first level the forward tail kernel lifts in
# shared memory (int32: 64 KB a block).
TAIL_SAMPLES = 16384
# The inverse's tail: samples a channel of its top level at most, sides
# below TAIL_SIDE, and a block's shared memory (csrc inverse_tail_kernel);
# blocks a cluster at most, and the SMs its clusters aim to cover.  The
# cap and the cluster were chosen by tools/inverse_stamps.py --sweep on an
# H100: a larger top level makes the tail's loads latency-bound on the
# few SMs of its clusters, and a cluster of 8 beats one block.
UNLIFT_TAIL_SAMPLES = 16384
TAIL_SIDE = 1 << 15
TAIL_SMEM = 232448
CLUSTER_MAX = 8
TAIL_ROWS = 8  # rows a block of a cluster holds at least
CARD_SMS = 132  # an H100 SXM's
# Where the frames are interleaved: the tail's cap (the strided loads
# make a large tail slow: 1,024 was the fastest of 1,024, 4,096 and 16,384
# on 480 512x512 tiles), and the frames a warp of a large inverse level
# reads together (csrc F: 1 or 2; 2 was the fastest of 1, 2, 4 and 8).
INTERLEAVED_TAIL_SAMPLES = 1024
LANE_FRAMES = 2
# Warps a large level's launch aims for: row pairs a warp (a power of two,
# 16 at most) are halved until the launch has at least this many.
WARP_TARGET = 4096
STRIP_PAIRS = 30  # column pairs a warp of a large level stores (csrc PAIRS)


def _tdiv(a: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(a, d, rounding_mode="trunc")


def cdf53_fwd(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Forward reversible CDF 5/3 along ``axis``; output deinterleaved [L | H].

    Works for any N >= 2, even or odd, with any other dimensions.
    """
    N = x.shape[axis]
    pre = (slice(None),) * (axis % x.dim())
    ev, od = x[pre + (slice(0, N, 2),)], x[pre + (slice(1, N, 2),)]
    ne, no = ev.shape[axis], od.shape[axis]
    # Predict: d[i] = od[i] - (ev[i] + ev[i+1]) / 2, right neighbour
    # clamped to ev[-1] when N is even.
    if ne > no:
        right = ev.narrow(axis, 1, ne - 1)
    else:
        right = torch.cat([ev.narrow(axis, 1, ne - 1),
                           ev.narrow(axis, ne - 1, 1)], dim=axis)
    d = od - _tdiv(ev.narrow(axis, 0, no) + right, 2)
    # Update: s[i] = ev[i] + (d[i-1] + d[i]) / 4, left clamped to d[0];
    # the last even sample of an odd-N signal gets no update.
    left = torch.cat([d.narrow(axis, 0, 1), d.narrow(axis, 0, no - 1)],
                     dim=axis)
    upd = _tdiv(left + d, 4)
    nupd = ne if N % 2 == 0 else ne - 1
    s = torch.cat([ev.narrow(axis, 0, nupd) + upd.narrow(axis, 0, nupd),
                   ev.narrow(axis, nupd, ne - nupd)], dim=axis)
    return torch.cat([s, d], dim=axis)


def cdf53_inv(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse lifting: undo update, undo predict, re-interleave
    (cdf53.h:36-61).  Input deinterleaved [L | H] along ``axis``."""
    N = x.shape[axis]
    ne = (N + 1) // 2
    s, d = x.narrow(axis, 0, ne), x.narrow(axis, ne, N - ne)
    no = d.shape[axis]
    left = torch.cat([d.narrow(axis, 0, 1), d.narrow(axis, 0, no - 1)],
                     dim=axis)
    upd = _tdiv(left + d, 4)
    nupd = ne if N % 2 == 0 else ne - 1
    ev = torch.cat([s.narrow(axis, 0, nupd) - upd.narrow(axis, 0, nupd),
                    s.narrow(axis, nupd, ne - nupd)], dim=axis)
    if ne > no:
        right = ev.narrow(axis, 1, ne - 1)
    else:
        right = torch.cat([ev.narrow(axis, 1, ne - 1),
                           ev.narrow(axis, ne - 1, 1)], dim=axis)
    od = d + _tdiv(ev.narrow(axis, 0, no) + right, 2)
    # Re-interleave: stack on a fresh axis next to ``axis`` and merge (a
    # reshape, not a scatter); odd N pads the odd stream by one sample,
    # dropped after the merge.
    if ne > no:
        od = torch.cat([od, od.narrow(axis, no - 1, 1)], dim=axis)
    ax = axis % x.dim()
    shape = list(x.shape)
    shape[ax] = 2 * ne
    inter = torch.stack([ev, od], dim=ax + 1).reshape(shape)
    return inter.narrow(ax, 0, N)


def dwt2d_fwd(img: torch.Tensor, pyr: Pyramid) -> torch.Tensor:
    """Multi-level forward 2-D DWT on (..., H, W, C) int32 (encode.c:16-30):
    rows, then columns, per level; the LL quadrant recurses.  Leading axes
    are a batch.  :func:`forward_transform` without the colour step: on
    the card its kernel, on the CPU :func:`dwt2d_fwd_plain`."""
    frames = img.reshape((-1,) + tuple(img.shape[-3:])).contiguous()
    return forward_transform(frames, pyr, False).reshape(img.shape)


def dwt2d_fwd_plain(img: torch.Tensor, pyr: Pyramid) -> torch.Tensor:
    """Plain PyTorch version of :func:`dwt2d_fwd`."""
    out = img
    for l in range(pyr.levels, 0, -1):
        w, h = pyr.widths[l], pyr.heights[l]
        sub = cdf53_fwd(cdf53_fwd(out[..., :h, :w, :], axis=-2), axis=-3)
        if (h, w) == tuple(out.shape[-3:-1]):
            out = sub  # the first (full-size) level: a new tensor
        else:
            out[..., :h, :w, :] = sub  # in place: ``out`` is this function's
    return out


def forward_transform_plain(frames: torch.Tensor, pyr: Pyramid,
                            colour: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`forward_transform`."""
    data = frames.to(torch.int32)
    if colour:
        data = rgb_to_ycocg(data)
    return dwt2d_fwd_plain(data, pyr)


def launch_levels(pyr: Pyramid) -> list:
    """The levels each launch of :func:`forward_transform` lifts on the
    card, finest first: one large level a launch, then every level from
    the first whose input has at most ``TAIL_SAMPLES`` samples in one
    launch.  Its length is the launch count, ``L - t + 1`` for a tail
    from level t (``L`` when no level fits)."""
    t = tail_level(pyr)
    return ([(l,) for l in range(pyr.levels, t, -1)]
            + ([tuple(range(t, 0, -1))] if t else []))


def tail_level(pyr: Pyramid) -> int:
    """The first level, finest first, whose input has at most
    ``TAIL_SAMPLES`` samples a channel (0: none)."""
    return next((l for l in range(pyr.levels, 0, -1)
                 if pyr.heights[l] * pyr.widths[l] <= TAIL_SAMPLES), 0)


def band_pairs(n: int, h: int, w: int, F: int = 1) -> int:
    """Row pairs a warp of one large level's launch over n frames of h x
    w (the inverse's with F frames a warp and 32 / F - 2 stored pairs a
    strip): halved from 16 until the launch has ``WARP_TARGET`` warps."""
    strips = -(-((w + 1) // 2) // (STRIP_PAIRS if F == 1 else 32 // F - 2))
    bp = 16
    while bp > 1 and -(-n // F) * strips * -(-((h + 1) // 2) // bp) \
            < WARP_TARGET:
        bp //= 2
    return bp


def forward_transform(frames: torch.Tensor, pyr: Pyramid,
                      colour: bool) -> torch.Tensor:
    """(N, H, W, C) frames (uint8, or any dtype that converts to int32) ->
    (N, H, W, C) int32 coefficients of ``dwt2d_fwd(rgb_to_ycocg(frames))``
    (``colour``, C == 3) or ``dwt2d_fwd(frames)``.  The frames are left as
    they were.  On the card ``len(launch_levels(pyr))`` launches."""
    if frames.dim() != 4 or tuple(frames.shape[1:3]) != (pyr.height,
                                                         pyr.width):
        raise ValueError(f"forward_transform: frames of shape "
                         f"{tuple(frames.shape)} are not (N, {pyr.height}, "
                         f"{pyr.width}, C)")
    if colour and frames.shape[3] != 3:
        raise ValueError("forward_transform: the colour transform needs 3 "
                         "channels")
    if not on_card("forward_transform", frames):
        return forward_transform_plain(frames, pyr, colour)
    N, H, W, C = frames.shape
    if C not in (1, 3):
        raise ValueError(f"forward_transform: the kernels take 1 or 3 "
                         f"channels, not {C}")
    if frames.dtype not in (torch.uint8, torch.int32):
        frames = frames.to(torch.int32)
    dev = frames.device
    coeff = torch.empty((N, H, W, C), dtype=torch.int32, device=dev)
    L, t = pyr.levels, tail_level(pyr)
    groups = launch_levels(pyr)
    # Ping-pong LL buffers for the large levels' LL quadrants, sized for
    # the first two (each later one is smaller than its buffer); with no
    # tail the last level writes coeff's LL.
    bufs = [torch.empty(N * pyr.heights[l] * pyr.widths[l] * C,
                        dtype=torch.int32, device=dev)
            for l in (L - 1, L - 2)[:len(groups) - 1] if l >= 1]
    lib, stream = build.library(), build.stream_of(frames)
    src, u8 = frames, frames.dtype == torch.uint8
    s_frame, s_row = H * W * C, W * C
    for step, levels in enumerate(groups):
        l = levels[0]
        h, w = pyr.heights[l], pyr.widths[l]
        first = int(colour and l == L)
        if l <= t:
            build.check(lib.dwt_lift_tail(
                src.data_ptr(), int(u8), first, s_frame, s_row,
                coeff.data_ptr(), H * W * C, W * C, N, h, w, C, len(levels),
                stream), "forward_transform")
        else:
            hl, wl = pyr.heights[l - 1], pyr.widths[l - 1]
            if l == 1:
                ll, ll_frame, ll_row = coeff, H * W * C, W * C
            else:
                ll, ll_frame, ll_row = bufs[step % 2], hl * wl * C, wl * C
            build.check(lib.dwt_lift_level(
                src.data_ptr(), int(u8), first, s_frame, s_row,
                coeff.data_ptr(), H * W * C, W * C, ll.data_ptr(), ll_frame,
                ll_row, N, h, w, C, band_pairs(N, h, w), stream),
                "forward_transform")
            src, u8, s_frame, s_row = ll, False, ll_frame, ll_row
        forward_transform.launches += 1
    return coeff


forward_transform.launches = 0


def pyramid_chain(pyr: Pyramid) -> tuple:
    """The (h, w) output sizes of a whole inverse of ``pyr``, coarsest
    first: level l's, l = 1..L."""
    return tuple((pyr.heights[l], pyr.widths[l])
                 for l in range(1, pyr.levels + 1))


class Launch(NamedTuple):
    """One launch of :func:`inverse_transform` on the card: the levels it
    lifts (l = 1..len(chain), ``chain[l - 1]`` level l's output) and its
    shape.  The tail: ``cb`` channels a cluster of ``K`` blocks of ``Y``
    warps, ``R`` rows of ``pitch`` samples a block in shared memory; a
    larger level: ``bp`` row pairs and ``F`` frames a warp (F = 2 on
    interleaved frames, adjacent warps on adjacent frame groups)."""
    levels: tuple
    cb: int = 0
    K: int = 0
    R: int = 0
    pitch: int = 0
    Y: int = 0
    bp: int = 0
    F: int = 0


def skew(x: int) -> int:
    """The tail's shared-memory column of grid column x (csrc skew)."""
    return x + (x >> 5)


def tail_block(h: int, w: int, tasks: int, cb: int,
               sms: int = CARD_SMS) -> tuple:
    """(K, R, pitch, shared bytes) of a tail whose top level is h x w, over
    ``tasks`` clusters of ``cb`` channels: K doubled from 1 (to
    ``CLUSTER_MAX``, and while a block keeps ``TAIL_ROWS`` rows) until the
    blocks cover the card's ``sms``."""
    K = 1
    while K < CLUSTER_MAX and tasks * K < sms and h >= 2 * K * TAIL_ROWS:
        K *= 2
    R, pitch = -(-h // K), skew(w - 1) + 1
    return K, R, pitch, 4 * (cb * R * pitch + w + R
                             + cb * (build.CHAIN_LEVELS + 1))


def unlift_plan(chain, n: int = 1, c: int = 3, image: bool = True,
                interleaved: bool = False, sms: int = CARD_SMS) -> list:
    """The launches of :func:`inverse_transform` on the card for n frames
    of c channels (``image``: the last launch stores the colour or bytes;
    ``interleaved``: the detail view's frames lie between its columns),
    coarsest first: the tail, every level up to the largest whose output
    has at most ``TAIL_SAMPLES`` samples a channel and whose band fits a
    block's shared memory (a block holds c channels where it stores the
    image or reads interleaved frames), then one launch a larger level."""
    L, plan = len(chain), []
    for t in range(L, 0, -1):
        h, w = chain[t - 1]
        cap = INTERLEAVED_TAIL_SAMPLES if interleaved else UNLIFT_TAIL_SAMPLES
        if h * w > cap or max(h, w) >= TAIL_SIDE:
            continue
        cb = c if (t == L and image) or interleaved else 1
        K, R, pitch, smem = tail_block(h, w, n * (c // cb), cb, sms)
        if smem <= TAIL_SMEM:
            s = cb * R * w
            Y = 32 if s > 4096 else (8 if s > 1024 else 4)
            plan.append(Launch(tuple(range(1, t + 1)), cb, K, R, pitch, Y))
            break
    F = min(LANE_FRAMES, 1 << (n - 1).bit_length()) if interleaved else 1
    for l in range(len(plan[0].levels) + 1 if plan else 1, L + 1):
        h, w = chain[l - 1]
        plan.append(Launch((l,), bp=band_pairs(n, h, w, F), F=F))
    return plan


@functools.lru_cache(maxsize=256)
def _plan(*args) -> tuple:
    """:func:`unlift_plan`, once for each set of arguments (a tool that
    changes the plan's constants clears it)."""
    return tuple(unlift_plan(*args))


def plan_of(coeff: torch.Tensor, chain, colour: bool,
            to_bytes: bool) -> tuple:
    """:func:`unlift_plan` of one :func:`inverse_transform` call's
    arguments (on the card, its card's SM count), made once a shape."""
    N, _, _, C = coeff.shape
    sms = (_card_sms(coeff.device.index or 0) if coeff.is_cuda
           else CARD_SMS)
    return _plan(tuple(chain), N, C, bool(colour or to_bytes),
                 N > 1 and coeff.stride(0) < coeff.stride(2), sms)


@functools.lru_cache(maxsize=None)
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_chain(chain, h: int, w: int) -> tuple:
    """``chain`` as a tuple of int pairs; raises unless it ends at (h, w),
    each size is the ceil-half of the next and every side is at least 2."""
    chain = tuple((int(a), int(b)) for a, b in chain)
    ok = (0 < len(chain) <= build.CHAIN_LEVELS and chain[-1] == (h, w)
          and all(a >= 2 and b >= 2 for a, b in chain)
          and all(chain[k] == ((a + 1) // 2, (b + 1) // 2)
                  for k, (a, b) in enumerate(chain[1:])))
    if not ok:
        raise ValueError(f"inverse_transform: {chain} is not a chain of "
                         f"ceil-halved sizes of at least 2 ending at "
                         f"{(h, w)}")
    return chain


def _unlift_plain(coeff: torch.Tensor, chain) -> torch.Tensor:
    """The levels of ``chain`` undone on (..., H, W, C) coefficients, coarsest
    first: columns, then rows (decode.c:16-30).  The input is left as it
    was."""
    out = coeff
    for h, w in chain:
        sub = cdf53_inv(cdf53_inv(out[..., :h, :w, :], axis=-3), axis=-2)
        if (h, w) == tuple(out.shape[-3:-1]):
            out = sub
        else:
            if out is coeff:
                out = coeff.clone()  # the caller's tensor stays as it was
            out[..., :h, :w, :] = sub
    return out


def bias_plain(x: torch.Tensor, chain, bias: torch.Tensor) -> torch.Tensor:
    """The midpoint bias (decode.c:50-58) on (N, H, W, C) coefficients x,
    in place: each nonzero detail coefficient of chain level k + 1 (its
    output ``chain[k]`` less the LL quadrant) pushed away from zero by
    ``bias[n, c, k]``.  Returns x."""
    for k, (h, w) in enumerate(chain):
        b = bias[:, :, k][:, None, None, :]
        for quad in (x[:, (h + 1) // 2:h, :w], x[:, :(h + 1) // 2,
                                                 (w + 1) // 2:w]):
            quad += torch.sign(quad) * b
    return x


def inverse_transform_plain(coeff: torch.Tensor, chain, colour: bool,
                            to_bytes: bool, bias: torch.Tensor | None = None,
                            root: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`inverse_transform`."""
    x = coeff
    if bias is not None or root is not None:
        x = coeff.clone(memory_format=torch.contiguous_format)
        if root is not None:
            x[:, :root.shape[1], :root.shape[2]] = root
        if bias is not None:
            bias_plain(x, chain, bias)
    x = _unlift_plain(x, chain)
    if colour:
        x = ycocg_to_rgb(x)
    return x.clamp(0, 255).to(torch.uint8) if to_bytes else x


def inverse_transform(coeff: torch.Tensor, chain, colour: bool,
                      to_bytes: bool, bias: torch.Tensor | None = None,
                      root: torch.Tensor | None = None) -> torch.Tensor:
    """(N, H, W, C) int32 coefficients -> the levels of ``chain`` (their
    (h, w) output sizes, coarsest first, the last (H, W):
    :func:`pyramid_chain` for a whole pyramid, the one size (H, W) for the
    decoder's root-only pass) undone, then, with ``colour`` (C == 3), the
    inverse YCoCg-R with its decode-side clamps (image.h:41-43), and with
    ``to_bytes`` the clamp to [0, 255] and the uint8 cast; int32
    otherwise.

    ``coeff`` is read in place at any frame, row and column strides (the
    decoder hands over the scatter's (H, W, N, C) output as an (N, H, W,
    C) view); a channel stride other than 1 is read in place by the tail
    alone, and copied where a larger level follows.  ``root``, an (N, h0,
    w0, C) int32 view, (h0, w0) the ceil-halves of ``chain[0]``, takes the
    place of that corner of ``coeff`` (the root band, read in place from
    the parsed coefficients; copied likewise where no tail reads it).
    ``bias``, an (N, C, 16) int32 table, adds ``sign(v) * bias[n, c, k]``
    to each detail coefficient v of chain level k + 1 (the midpoint bias,
    decode.c:50-58).  The inputs are left as they were.  On the card
    ``len(plan_of(...))`` launches."""
    if coeff.dim() != 4 or coeff.dtype != torch.int32:
        raise ValueError(f"inverse_transform: expected (N, H, W, C) int32 "
                         f"coefficients, got {tuple(coeff.shape)} "
                         f"{coeff.dtype}")
    N, H, W, C = coeff.shape
    chain = _check_chain(chain, H, W)
    if colour and C != 3:
        raise ValueError("inverse_transform: the colour transform needs 3 "
                         "channels")
    h0, w0 = (chain[0][0] + 1) // 2, (chain[0][1] + 1) // 2
    for name, t, shape in (("bias", bias, (N, C, 16)),
                           ("root", root, (N, h0, w0, C))):
        if t is not None and (t.dtype != torch.int32
                              or tuple(t.shape) != shape):
            raise ValueError(f"inverse_transform: {name} must be {shape} "
                             f"int32, not {tuple(t.shape)} {t.dtype}")
    given = [t for t in (coeff, bias, root) if t is not None]
    if not cuda_or_cpu("inverse_transform", given):
        return inverse_transform_plain(coeff, chain, colour, to_bytes, bias,
                                       root)
    if C not in (1, 3):
        raise ValueError(f"inverse_transform: the kernels take 1 or 3 "
                         f"channels, not {C}")
    if bias is not None and not bias.is_contiguous():
        raise ValueError("inverse_transform: the bias table must be "
                         "contiguous")
    dev, L = coeff.device, len(chain)
    out = torch.empty((N, H, W, C), device=dev,
                      dtype=torch.uint8 if to_bytes else torch.int32)
    plan = plan_of(coeff, chain, colour, to_bytes)
    # Ping-pong LL buffers for the outputs of every launch but the last:
    # level L - 1's into the first, L - 2's into the second, and so on in
    # turn (each later one smaller than its buffer).
    bufs = [torch.empty(N * chain[l - 1][0] * chain[l - 1][1] * C,
                        dtype=torch.int32, device=dev)
            for l in (L - 1, L - 2)[:len(plan) - 1]]
    lib, stream = build.library(), build.stream_of(coeff)
    bp_ = bias.data_ptr() if bias is not None else None
    # The large levels read whole pixels: the copies stay referenced here
    # until the launches are made.
    if coeff.stride(3) != 1 and not plan[-1].cb:
        coeff = coeff.contiguous()
    if root is None:
        root = coeff
    elif root.stride(3) != 1 and not plan[0].cb:
        root = root.contiguous()  # level 1 reads it as its LL
    det, ll = build.view(coeff), build.view(root)
    for p in plan:
        top = p.levels[-1]
        h, w = chain[top - 1]
        last = top == L
        if last:
            dst, d_frame, d_row = out, H * W * C, W * C
        else:
            dst = bufs[(L - 1 - top) % 2]
            d_frame, d_row = h * w * C, w * C
        flags = (int(colour and last), int(to_bytes and last))
        if p.cb:  # the tail's levels, coarsest first
            build.check(lib.dwt_unlift_tail(
                det, ll, bp_, N, C, build.chain(chain[:top]), dst.data_ptr(),
                d_frame, d_row, *flags, p.cb, p.K, p.R, p.pitch, p.Y,
                stream), "inverse_transform")
        else:
            build.check(lib.dwt_unlift_level(
                det, ll, bp_, top - 1, dst.data_ptr(), d_frame, d_row, N, h,
                w, C, p.bp, p.F, *flags, stream),
                "inverse_transform")
        ll = build.View(dst.data_ptr(), d_frame, d_row, C, 1)
        inverse_transform.launches += 1
    return out


inverse_transform.launches = 0


def dwt2d_inv(coeff: torch.Tensor, pyr: Pyramid) -> torch.Tensor:
    """Inverse multi-level 2-D DWT (decode.c:16-30) on (..., H, W, C)
    int32: coarsest level first, columns then rows.  Leading axes are a
    batch.  The input is left as it was.  :func:`inverse_transform`'s
    int32 route without the colour step: on the card its kernel (the
    frames made contiguous first), on the CPU :func:`dwt2d_inv_plain`."""
    frames = coeff.reshape((-1,) + tuple(coeff.shape[-3:])).contiguous()
    return inverse_transform(frames, pyramid_chain(pyr), False,
                             False).reshape(coeff.shape)


def dwt2d_inv_plain(coeff: torch.Tensor, pyr: Pyramid) -> torch.Tensor:
    """Plain PyTorch version of :func:`dwt2d_inv`."""
    return _unlift_plain(coeff, pyramid_chain(pyr))
