"""Decoder's inverse Hilbert scatter (kernel ``csrc/hilbert_scatter.cu``).

Port of ``dwt_tpu/ops/pallas_hilbert.py:hilbert_scatter_pallas``: (C, L)
int32 scan-order coefficients -> (H, W, C) int32 image plane on the
unpadded layout of the decoder's (sub-)pyramid.  The static permutation
arrives as a precomputed (H, W) source index per pixel
(``codec.decoder.scatter_source``): ``out[y, x, c] = lin[c, src[y, x]]``,
and 0 where the index lies outside [0, L) (``-1`` marks the root band,
whose raster crop the caller writes).

The CUDA kernel works on aligned SQ x SQ output squares.  Every level's
Hilbert grid starts at the image origin, so the valid source indices of
one square form a few contiguous runs of scan positions (one, or one per
level where a square straddles a level border).  :func:`square_runs`
builds that run table once a geometry; a block of the kernel copies its
square's runs from ``lin`` into shared memory with coalesced reads,
looks each pixel's slot up among the runs, and writes the square's
output rows as contiguous stretches.

The one-time probe ``hilbert_gather.engine_supported`` launches the same
kernel from C (``csrc/probe.cu``) on one square with one run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import build
from ._launch import need, on_card

SQ = 32  # side of the kernel's output squares (csrc/hilbert_scatter.cu)
GROUP = 12  # channels a block stages at most (4 KB of shared memory each)


def square_runs(src) -> tuple[np.ndarray, np.ndarray]:
    """Run table of an (H, W) source index: for each aligned SQ x SQ square
    (row-major over the squares, ragged bottom and right squares
    included), the maximal runs of consecutive distinct values >= 0 among
    its pixels' indices, ascending, in CSR form: ``sq_ptr``
    (nsq + 1,) int32 and ``runs`` (nruns, 2) int32 of (start, count).
    The counts of a square sum to at most SQ * SQ, the runs are disjoint
    and every index >= 0 falls in exactly one run of its square."""
    s = src.cpu().numpy() if isinstance(src, torch.Tensor) else np.asarray(src)
    H, W = s.shape
    hs, ws = -(-H // SQ), -(-W // SQ)
    pad = np.full((hs * SQ, ws * SQ), -1, np.int32)
    pad[:H, :W] = s
    v = np.sort(pad.reshape(hs, SQ, ws, SQ).transpose(0, 2, 1, 3)
                .reshape(hs * ws, SQ * SQ), axis=1)
    valid = v >= 0
    distinct = valid.copy()
    distinct[:, 1:] &= v[:, 1:] != v[:, :-1]
    start = distinct.copy()
    start[:, 1:] &= ~(valid[:, :-1] & (v[:, 1:] == v[:, :-1] + 1))
    d, st = distinct.reshape(-1), start.reshape(-1)
    pos = np.nonzero(st)[0]
    before = np.cumsum(d)[pos] - 1  # distinct values before each run
    counts = np.diff(np.append(before, d.sum()))
    sq_ptr = np.zeros(hs * ws + 1, np.int64)
    np.cumsum(np.bincount(pos // (SQ * SQ), minlength=hs * ws),
              out=sq_ptr[1:])
    runs = np.stack([v.reshape(-1)[pos], counts], 1).reshape(-1, 2)
    return sq_ptr.astype(np.int32), runs.astype(np.int32)


def run_table(src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`square_runs` of ``src`` as int32 tensors on its device."""
    return tuple(torch.as_tensor(a, device=src.device)
                 for a in square_runs(src))


def hilbert_scatter_plain(lin: torch.Tensor, src: torch.Tensor,
                          sq_ptr=None, runs=None) -> torch.Tensor:
    """Plain PyTorch version: ``out[y, x, c] = lin[c, src[y, x]]`` or 0
    (the run table is accepted for the same signature and not needed)."""
    (C, L), (H, W) = lin.shape, src.shape
    s = src.reshape(-1)
    ok = (s >= 0) & (s < L)
    g = lin[:, s.clamp(0, L - 1).long()]
    return torch.where(ok, g, 0).T.reshape(H, W, C).contiguous()


def launch(lin, src, sq_ptr, runs, out, group: int = GROUP) -> None:
    """The kernel alone, into ``out`` ((H, W, C) int32), staging at most
    ``group`` channels a block (the channels are split into groups of
    near-equal size, one block for each square and group)."""
    (C, L), (H, W) = lin.shape, src.shape
    build.check(build.library().dwt_hilbert_scatter(
        lin.data_ptr(), src.data_ptr(), sq_ptr.data_ptr(), runs.data_ptr(),
        out.data_ptr(), H, W, L, C, runs.shape[0], group,
        build.stream_of(lin)), "hilbert_scatter")


def hilbert_scatter(lin: torch.Tensor, src: torch.Tensor,
                    sq_ptr: torch.Tensor | None = None,
                    runs: torch.Tensor | None = None) -> torch.Tensor:
    """(C, L) int32 coefficients, (H, W) int32 source indices -> (H, W, C)
    int32.  ``sq_ptr`` and ``runs``: the run table of ``src``
    (:func:`square_runs`), which the caller keeps for a geometry; without
    it the wrapper derives it on the host (one copy of ``src``).  The
    table does not change the function, as long as it is ``src``'s."""
    need("hilbert_scatter lin", lin, torch.int32, 2)
    need("hilbert_scatter src", src, torch.int32, 2)
    if (sq_ptr is None) != (runs is None):
        raise ValueError("hilbert_scatter: give both sq_ptr and runs, or "
                         "neither")
    table = ()
    if sq_ptr is not None:
        need("hilbert_scatter sq_ptr", sq_ptr, torch.int32, 1)
        need("hilbert_scatter runs", runs, torch.int32, 2)
        H, W = src.shape
        if sq_ptr.shape[0] != -(-H // SQ) * -(-W // SQ) + 1 \
                or runs.shape[1] != 2:
            raise ValueError("hilbert_scatter: the run table does not fit "
                             "src (sq_ptr: one entry a square and one, "
                             "runs: (nruns, 2))")
        table = (sq_ptr, runs)
    if not on_card("hilbert_scatter", lin, src, *table):
        return hilbert_scatter_plain(lin, src)
    (C, L), (H, W) = lin.shape, src.shape
    out = torch.empty((H, W, C), dtype=torch.int32, device=lin.device)
    if out.numel() == 0:
        return out
    launch(lin, src, *(table or run_table(src)), out)
    hilbert_scatter.launches += 1
    return out


hilbert_scatter.launches = 0
