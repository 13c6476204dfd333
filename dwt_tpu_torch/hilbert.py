"""Hilbert space-filling curve, vectorized over the whole curve at once.

The port's own copy of ``dwt_tpu/hilbert.py`` (numpy only): importing the
JAX package would import JAX, which the GPU package never does.

The reference walks the curve one index at a time with an O(log n) scalar
loop per cell (reference: hilbert.h:15-34, called per-coefficient from
encode.c:46-57 — its hottest non-entropy loop).  Here the entire d->(x,y)
mapping for a 2^k x 2^k grid is computed once, vectorized in numpy, and the
resulting *linearization permutation* (a flat gather index array) is cached
per image geometry.  On device the whole linearization step then collapses
to one gather — no per-cell curve walk ever runs on the device.
"""

from __future__ import annotations

import functools

import numpy as np

from .geometry import Pyramid


@functools.lru_cache(maxsize=None)
def hilbert_xy(n: int) -> tuple:
    """Vectorized index -> (x, y) for the full n*n Hilbert curve (n = 2^k).

    Returns (x, y) int32 arrays of length n*n such that (x[d], y[d]) is the
    cell visited at curve position d.  Matches reference hilbert.h:15-34
    bit-for-bit: the size-n curve is the size-n/2 curve replayed through the
    four quadrant transforms of the reference loop's final (s = n/2)
    iteration — quadrant 0 swaps axes, 1 and 2 translate, 3 reflects+swaps.
    Dyadic recursion costs O(n^2) total (the old whole-curve iterative
    sweep was O(n^2 log n) and ~20x slower at 4096, dominating encoder
    construction for 4K geometries) and memoizes every sub-size, which the
    per-level callers need anyway.
    """
    assert n >= 1 and (n & (n - 1)) == 0
    if n == 1:
        return (np.zeros(1, np.int32), np.zeros(1, np.int32))
    h = n // 2
    xs, ys = hilbert_xy(h)
    m = h * h
    x = np.empty(n * n, np.int32)
    y = np.empty(n * n, np.int32)
    x[:m] = ys
    y[:m] = xs
    x[m : 2 * m] = xs
    y[m : 2 * m] = ys + h
    x[2 * m : 3 * m] = xs + h
    y[2 * m : 3 * m] = ys + h
    x[3 * m :] = (h - 1 - ys) + h
    y[3 * m :] = h - 1 - xs
    return x, y


@functools.lru_cache(maxsize=None)
def linearization_perm(pyr: Pyramid) -> np.ndarray:
    """Flat gather indices realizing the reference coefficient scan order.

    ``linear[k] = coeff2d.reshape(-1)[perm[k]]`` reproduces the order of
    reference encode.c:32-58: root LL band in raster order, then for each
    level l the detail cells of level l+1 (inside its image, outside the
    level-l image) in Hilbert-curve order over the level's pow2 grid.

    Returns int32 array of length pyr.total indexing into the row-major
    (H, W) plane.  Inverse (scatter order for the decoder) is just argsort.
    """
    W = pyr.width
    parts = []
    # Root band: raster order over the coarsest LL.
    w0, h0 = pyr.widths[0], pyr.heights[0]
    yy, xx = np.mgrid[0:h0, 0:w0]
    parts.append((yy * W + xx).reshape(-1))
    # Detail bands per level, Hilbert order.
    for l in range(pyr.levels):
        n = pyr.lengths[l + 1]
        x, y = hilbert_xy(n)
        inside = (x < pyr.widths[l + 1]) & (y < pyr.heights[l + 1])
        outside_prev = (x >= pyr.widths[l]) | (y >= pyr.heights[l])
        keep = inside & outside_prev
        parts.append((y[keep].astype(np.int64) * W + x[keep]).astype(np.int64))
    perm = np.concatenate(parts).astype(np.int32)
    assert perm.shape[0] == pyr.total
    return perm


@functools.lru_cache(maxsize=None)
def reconstruction_perm(pyr: Pyramid) -> np.ndarray:
    """Inverse permutation: scatter linearized coefficients back to 2-D.

    ``coeff2d.reshape(-1)[j] = linear[inv[j]]``.
    """
    perm = linearization_perm(pyr)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return inv


TS_RUN = 32  # tile side of the run decomposition (= pallas_hilbert.TS)


def _level_runs(pyr: Pyramid, l: int, ts: int = TS_RUN):
    """Aligned ts*ts-curve-position runs of level l's detail band.

    Yields (y0, x0, ys, xs, km) per nonempty run: (y0, x0) the enclosing
    ts x ts square's corner, (ys, xs) the run's full curve coordinates and
    ``km`` the kept-mask (inside level image, outside previous level).
    For levels whose Hilbert grid is smaller than ts, one pseudo-run at
    the origin covers the whole level.
    """
    tsq = ts * ts
    n = pyr.lengths[l + 1]
    x, y = hilbert_xy(n)
    keep = ((x < pyr.widths[l + 1]) & (y < pyr.heights[l + 1])
            & ((x >= pyr.widths[l]) | (y >= pyr.heights[l])))
    if n < ts:
        yield 0, 0, y, x, keep
        return
    for m in range(n * n // tsq):
        km = keep[m * tsq : (m + 1) * tsq]
        if not km.any():
            continue
        xs = x[m * tsq : (m + 1) * tsq]
        ys = y[m * tsq : (m + 1) * tsq]
        yield (int(ys[0]) & ~(ts - 1), int(xs[0]) & ~(ts - 1), ys, xs, km)


@functools.lru_cache(maxsize=None)
def padded_layout(pyr: Pyramid, align: int = 512) -> tuple:
    """Lane-aligned scan-order layout of the entropy pipeline (the JAX
    package's TPU layout, kept identical here so that every intermediate
    of the port compares one to one with it).

    Each scan-order segment (root band, then one segment per detail level)
    is padded at its end to a multiple of ``align`` so that every segment
    boundary falls on a TPU-lane-aligned offset — segmented cumsums,
    broadcasts and reductions then never touch unaligned lane slices (a
    ~100x throughput cliff on TPU).  Pad slots gather image index 0 and are
    masked out of every mask/cumsum, so the produced bitstream is unchanged.

    When ``align >= TS_RUN**2`` (the Pallas tile engines' run size), the
    layout is additionally *tile-padded*: every aligned run of 1024 curve
    positions occupies a full 1024-slot window (thinned runs pad their
    tail).  Every run offset is then 1024-aligned, which the 2026-08
    Mosaic's DMA legality rules require of the gather engine's destination
    windows — and partial runs own their windows exclusively, so the
    engine needs no read-modify-write merges.  Interior pads are masked
    exactly like segment-tail pads; the bitstream is unchanged.

    Returns (perm, valid, seg_sizes_padded) where perm/valid have length
    root_pad + sum(padded detail sizes); seg_sizes_padded[0] is the padded
    root size.
    """
    W = pyr.width
    tsq = TS_RUN * TS_RUN
    tile_pad = align >= tsq
    parts_idx, parts_valid, sizes = [], [], []

    def close_segment(seg_idx, seg_valid):
        n = sum(len(p) for p in seg_idx)
        pad = (-n) % align
        seg_idx.append(np.zeros(pad, np.int32))
        seg_valid.append(np.zeros(pad, bool))
        parts_idx.extend(seg_idx)
        parts_valid.extend(seg_valid)
        sizes.append(n + pad)

    # Root band: raster crop, contiguous.
    w0, h0 = pyr.widths[0], pyr.heights[0]
    yy, xx = np.mgrid[0:h0, 0:w0]
    close_segment([(yy * W + xx).reshape(-1).astype(np.int32)],
                  [np.ones(h0 * w0, bool)])

    perm = linearization_perm(pyr)
    if not tile_pad:
        for l in range(pyr.levels):
            a, b = pyr.pixels[l], pyr.pixels[l + 1]
            close_segment([perm[a:b]], [np.ones(b - a, bool)])
    else:
        for l in range(pyr.levels):
            seg_idx, seg_valid = [], []
            for y0, x0, ys, xs, km in _level_runs(pyr, l):
                k = int(km.sum())
                idx = (ys[km].astype(np.int64) * W + xs[km]).astype(np.int32)
                seg_idx += [idx, np.zeros(tsq - k, np.int32)]
                v = np.zeros(tsq, bool)
                v[:k] = True
                seg_valid.append(v)
            close_segment(seg_idx, seg_valid)
    return (np.concatenate(parts_idx), np.concatenate(parts_valid),
            tuple(sizes))


@functools.lru_cache(maxsize=None)
def tile_plan(pyr: Pyramid, align: int = 512, ts: int = 32) -> dict:
    """Static 32x32-tile decomposition of the Hilbert linearization for the
    Pallas gather engine (ops/pallas_hilbert.py).

    Every aligned run of ts*ts curve positions lies inside one aligned
    ts x ts square (Hilbert property), so the linearization gather factors
    into per-tile intra-square permutations.  Runs that are fully kept
    ('clean') realize one of <= 8 dihedral images of the base ts-curve —
    a handful of CONSTANT permutation patterns the kernel applies as s8
    one-hot matmuls; runs thinned by the image crop or the previous-level
    exclusion ('partial') carry an explicit per-rank source list and
    read-modify-write their windows.  Replaces reference encode.c:46-57's
    per-coefficient curve walk AND XLA's ~8 ns/index gather.

    Returns numpy arrays (all int32):
      patterns (n_pat, ts*ts): source lane (r*ts + c) per output rank.
      clean    (n_clean, 4):   y0, x0, pattern id, lin element offset.
      partial  (n_part, 3):    y0, x0, lin element offset.
      partial_src (n_part, ts*ts): source lane per rank; 2^30 = no source.
      Tiles are in lin order within each class.  Root band is raster
      (a dense crop) and is not part of the plan.
    """
    tsq = ts * ts
    tile_pad = align >= tsq  # matches padded_layout's tile-padded mode
    _, _, sizes_p = padded_layout(pyr, align)
    seg_start = np.cumsum([0] + list(sizes_p))  # root, then detail levels
    patterns: list[np.ndarray] = []
    pat_key: dict[bytes, int] = {}
    clean, partial, partial_src = [], [], []
    for l in range(pyr.levels):
        off = int(seg_start[l + 1])
        for y0, x0, ys, xs, km in _level_runs(pyr, l, ts):
            k = int(km.sum())
            if k == tsq:
                srcs = ((ys - y0) * ts + (xs - x0)).astype(np.int32)
                key = srcs[:8].tobytes()
                pid = pat_key.get(key)
                if pid is None or not np.array_equal(patterns[pid], srcs):
                    pid = len(patterns)
                    pat_key[key] = pid
                    patterns.append(srcs)
                clean.append((y0, x0, pid, off))
            else:
                # Edge tiles keep their 32-aligned window: the engine
                # wrappers zero-pad the image to 32-multiples, so the DMA
                # stays in bounds WITHOUT clamping — a clamped corner like
                # y = H - ts breaks the kernel's 8-aligned sublane-offset
                # promise and miscompiles on the 2026-08 Mosaic.
                srcs = np.full(tsq, 1 << 30, np.int32)
                srcs[:k] = ((ys[km] - y0) * ts + (xs[km] - x0)).astype(
                    np.int32)
                partial.append((y0, x0, off))
                partial_src.append(srcs)
            off += tsq if tile_pad else k
    return dict(
        patterns=np.asarray(patterns, np.int32).reshape(-1, tsq),
        clean=np.asarray(clean, np.int32).reshape(-1, 4),
        partial=np.asarray(partial, np.int32).reshape(-1, 3),
        partial_src=np.asarray(partial_src, np.int32).reshape(-1, tsq),
    )


@functools.lru_cache(maxsize=None)
def level_of_position(pyr: Pyramid) -> np.ndarray:
    """For each linearized position, which pyramid chunk it belongs to.

    Root band positions get level -1; detail positions get l in [0, levels).
    """
    out = np.empty(pyr.total, dtype=np.int32)
    out[: pyr.pixels[0]] = -1
    for l in range(pyr.levels):
        out[pyr.pixels[l] : pyr.pixels[l + 1]] = l
    return out
