"""2-D transpose (kernel ``csrc/transpose.cu``).

Port of ``dwt_tpu/ops/pallas_transpose.py:transpose2d``: (R, C) -> (C, R)
for int32, uint32 and int8, any R and C, with the JAX package's output
dtypes: int32 -> int32, int8 -> int8, and uint32 -> int32 (the same bit
patterns; ``torch.uint32`` has no arithmetic on the CPU, so the port
carries such words as int32 anyway).  The VLI order scan
(``codec/tokens.py:_vli_orders``) runs it twice a stream, int32 in and
int8 out.
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


def transpose2d(x: torch.Tensor) -> torch.Tensor:
    """(R, C) int32/uint32/int8 -> contiguous (C, R) int32/int32/int8."""
    x = _as_out_dtype(x)
    if not on_card("transpose2d", x):
        return transpose2d_plain(x)
    R, C = x.shape
    out = torch.empty((C, R), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = build.library()
    build.check(lib.dwt_transpose(x.data_ptr(), out.data_ptr(), R, C,
                                  x.element_size(), build.stream_of(x)),
                "transpose2d")
    transpose2d.launches += 1
    return out


transpose2d.launches = 0
