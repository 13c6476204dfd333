"""Integer CDF 5/3 lifting, forward and inverse (port of
``dwt_tpu/ops/lifting.py``).

Whole-axis slice arithmetic over all rows or columns of a level at once.
Every division truncates toward zero (C semantics, never Python's floor);
odd-length boundary rules follow the reference's cdf53.h:11-33: clamped
neighbours, and no update on the last even sample of an odd-N signal.
"""

from __future__ import annotations

import torch

from ..geometry import Pyramid


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
    are a batch."""
    out = img
    for l in range(pyr.levels, 0, -1):
        w, h = pyr.widths[l], pyr.heights[l]
        sub = cdf53_fwd(cdf53_fwd(out[..., :h, :w, :], axis=-2), axis=-3)
        if (h, w) == tuple(out.shape[-3:-1]):
            out = sub  # the first (full-size) level: a new tensor
        else:
            out[..., :h, :w, :] = sub  # in place: ``out`` is this function's
    return out


def dwt2d_inv(coeff: torch.Tensor, pyr: Pyramid) -> torch.Tensor:
    """Inverse multi-level 2-D DWT (decode.c:16-30) on (..., H, W, C):
    coarsest level first, columns then rows.  Leading axes are a batch.
    The input is left as it was."""
    out = coeff
    for l in range(1, pyr.levels + 1):
        w, h = pyr.widths[l], pyr.heights[l]
        sub = cdf53_inv(cdf53_inv(out[..., :h, :w, :], axis=-3), axis=-2)
        if (h, w) == tuple(out.shape[-3:-1]):
            out = sub
        else:
            if out is coeff:
                out = coeff.clone()  # the caller's tensor stays as it was
            out[..., :h, :w, :] = sub
    return out
