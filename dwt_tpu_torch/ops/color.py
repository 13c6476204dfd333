"""Reversible YCoCg-R colour transform (port of ``dwt_tpu/ops/color.py``).

Truncating division, as in the reference (image.h:39-79).
"""

from __future__ import annotations

import torch


def _tdiv2(a: torch.Tensor) -> torch.Tensor:
    return torch.div(a, 2, rounding_mode="trunc")


def rgb_to_ycocg(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 RGB -> YCoCg-R: U=R-B; T=B+U/2; V=G-T; Y=T+V/2."""
    R, G, B = img[..., 0], img[..., 1], img[..., 2]
    U = R - B
    T = B + _tdiv2(U)
    V = G - T
    Y = T + _tdiv2(V)
    return torch.stack([Y, U, V], dim=-1)
