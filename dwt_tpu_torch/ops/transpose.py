"""2-D transpose (kernel ``csrc/transpose.cu``).

Port of ``dwt_tpu/ops/pallas_transpose.py:transpose2d``: (R, C) -> (C, R)
for int32, uint32 and int8, any R and C, with the JAX package's output
dtypes: int32 -> int32, int8 -> int8, and uint32 -> int32 (the same bit
patterns; ``torch.uint32`` has no arithmetic on the CPU, so the port
carries such words as int32 anyway).  ``codec/tokens.py:_vli_orders``
runs it twice a call (once a sub-batch of frames), around the VLI order
scan's kernels (``ops/vli_scan.py``): the (N * nblk, TB) int32 transition
parameters in, and the (TB, N * nblk) int8 orders back.

The CUDA source has two kernels: one element a thread through a 32x32
shared tile (int32, and int8 shapes whose sides are not multiples of 16),
and, for int8 with both sides multiples of 16 (the VLI scan's), 128x128
byte tiles moved in 16-byte words and turned with byte permutes in
registers.  :func:`vector_bytes` picks one from the shape.
"""

from __future__ import annotations

import torch

from ..runtime import build
from ._launch import on_card

_DTYPES = (torch.int32, torch.uint32, torch.int8)


def _as_out_dtype(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"transpose2d: expected a 2-D int32, uint32 or int8 "
                         f"tensor, got {x.dim()}-D {x.dtype}")
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def transpose2d_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`transpose2d`."""
    return _as_out_dtype(x).T.contiguous()


def vector_bytes(x: torch.Tensor) -> int:
    """Bytes a thread of the CUDA source moves at once for ``x`` (as
    returned by ``_as_out_dtype``): 16 (the byte kernel: int8 with both
    sides multiples of 16), else 1 (the element kernel)."""
    R, C = x.shape
    return 16 if x.dtype == torch.int8 and R % 16 == 0 and C % 16 == 0 \
        else 1


def launch(x: torch.Tensor, out: torch.Tensor, vec: int) -> None:
    """The kernel alone: ``x`` (as returned by ``_as_out_dtype``) into the
    contiguous (C, R) ``out``, by the byte kernel (``vec`` 16) or by the
    element kernel (``vec`` 1)."""
    R, C = x.shape
    build.check(build.library().dwt_transpose(
        x.data_ptr(), out.data_ptr(), R, C, x.element_size(), vec,
        build.stream_of(x)), "transpose2d")


def transpose2d(x: torch.Tensor) -> torch.Tensor:
    """(R, C) int32/uint32/int8 -> contiguous (C, R) int32/int32/int8."""
    x = _as_out_dtype(x)
    if not on_card("transpose2d", x):
        return transpose2d_plain(x)
    R, C = x.shape
    out = torch.empty((C, R), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    launch(x, out, vector_bytes(x))
    transpose2d.launches += 1
    return out


transpose2d.launches = 0
