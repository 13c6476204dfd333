"""Pyramid geometry for the multi-level CDF 5/3 wavelet decomposition.

The port's own copy of ``dwt_tpu/geometry.py``; it imports nothing of the
JAX package.

Behavioral contract follows the reference codec's geometry layer
(reference: utils.h:9-40): levels are produced by repeated ceil-halving
``W2 = (W+1)//2`` until either half would drop below ``min_len`` (default 8).
Level index 0 is the coarsest (root LL band); level ``levels`` is full
resolution.  For each level we record:

* ``widths[l] / heights[l]`` — dimensions of the level-l LL image
* ``pixels[l]`` — ``widths[l]*heights[l]``; this doubles as the offset of
  level-l detail data in the linearized coefficient order
* ``lengths[l]`` — smallest power of two >= max(width, height) of level l;
  the Hilbert grid the level's detail bands are scanned on

Everything here is static host-side metadata computed once per image shape
and baked into the device computation as constants.
"""

from __future__ import annotations

import dataclasses
import functools

MIN_LEN = 8
MAX_LEVELS = 16
MAX_DIM = 65536


def ilog2(x: int) -> int:
    """Floor log2 for x>0; -1 for x<=0 (reference: utils.h:9-15)."""
    l = -1
    while x > 0:
        x //= 2
        l += 1
    return l


def ceil_half(x: int) -> int:
    return (x + 1) // 2


@dataclasses.dataclass(frozen=True)
class Pyramid:
    """Static geometry of one decomposition. Index 0 = coarsest."""

    width: int
    height: int
    levels: int
    widths: tuple  # len levels+1, widths[levels] == width
    heights: tuple
    pixels: tuple  # cumulative linear offsets; pixels[levels] == width*height
    lengths: tuple  # Hilbert grid sizes (pow2) per level

    @property
    def total(self) -> int:
        return self.width * self.height

    def chunk(self, l: int) -> tuple:
        """(offset, size) of level-l detail run in linearized order, l in [0, levels)."""
        return self.pixels[l], self.pixels[l + 1] - self.pixels[l]


@functools.lru_cache(maxsize=None)
def compute_pyramid(width: int, height: int, min_len: int = MIN_LEN) -> Pyramid:
    """Mirror of the reference geometry (utils.h:17-40)."""
    if width < min_len or height < min_len:
        raise ValueError(f"image {width}x{height} smaller than {min_len}x{min_len}")
    if width > MAX_DIM or height > MAX_DIM:
        raise ValueError(f"image {width}x{height} exceeds {MAX_DIM}")

    # Walk down to the coarsest level, then record coarsest-first.  The first
    # halving is always recorded even if below min_len (utils.h:17-26 appends
    # unconditionally; only *deeper* recursion is gated), so e.g. an 8x8 image
    # has one level with a 4x4 root band.
    dims = []
    w, h = width, height
    while True:
        w2, h2 = ceil_half(w), ceil_half(h)
        dims.append((w2, h2))
        if w2 < min_len or h2 < min_len:
            break
        w, h = w2, h2
    dims.reverse()  # coarsest first
    levels = len(dims)
    if levels >= MAX_LEVELS:
        raise ValueError("too many decomposition levels")

    widths = tuple([d[0] for d in dims] + [width])
    heights = tuple([d[1] for d in dims] + [height])
    pixels = tuple(w * h for w, h in zip(widths, heights))
    lengths = tuple(
        max(1 << (ilog2(w - 1) + 1), 1 << (ilog2(h - 1) + 1))
        for w, h in zip(widths, heights)
    )
    return Pyramid(width, height, levels, widths, heights, pixels, lengths)
