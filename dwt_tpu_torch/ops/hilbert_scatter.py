"""Decoder's inverse Hilbert scatter (kernel ``csrc/hilbert_scatter.cu``).

Port of ``dwt_tpu/ops/pallas_hilbert.py:hilbert_scatter_pallas``: (C, L)
int32 scan-order coefficients -> (H, W, C) int32 image plane on the
unpadded layout of the decoder's (sub-)pyramid.  The static permutation
arrives as a precomputed (H, W) source index per pixel
(``codec.decoder.scatter_source``): ``out[y, x, c] = lin[c, src[y, x]]``,
and 0 where the index lies outside [0, L) (``-1`` marks the root band,
whose raster crop the caller writes).

The one-time probe ``hilbert_gather.engine_supported`` launches the same
kernel from C (``csrc/probe.cu``).
"""

from __future__ import annotations

import torch

from ..runtime import build
from ._launch import need, on_card


def hilbert_scatter_plain(lin: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``out[y, x, c] = lin[c, src[y, x]]`` or 0."""
    (C, L), (H, W) = lin.shape, src.shape
    s = src.reshape(-1)
    ok = (s >= 0) & (s < L)
    g = lin[:, s.clamp(0, L - 1).long()]
    return torch.where(ok, g, 0).T.reshape(H, W, C).contiguous()


def hilbert_scatter(lin: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(C, L) int32 coefficients, (H, W) int32 source indices -> (H, W, C)
    int32."""
    need("hilbert_scatter lin", lin, torch.int32, 2)
    need("hilbert_scatter src", src, torch.int32, 2)
    if not on_card("hilbert_scatter", lin, src):
        return hilbert_scatter_plain(lin, src)
    (C, L), (H, W) = lin.shape, src.shape
    out = torch.empty((H, W, C), dtype=torch.int32, device=lin.device)
    build.check(build.library().dwt_hilbert_scatter(
        lin.data_ptr(), src.data_ptr(), out.data_ptr(), H * W, L, C,
        build.stream_of(lin)), "hilbert_scatter")
    hilbert_scatter.launches += 1
    return out


hilbert_scatter.launches = 0

