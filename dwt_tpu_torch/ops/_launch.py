"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device (launch the kernel),
    False when all lie on the CPU (use the plain version); raises on a mix
    or any other device.  Also requires contiguous tensors."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
    if dev.type == "cuda":
        for t in tensors:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: tensors must be 16-byte aligned")
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def need(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name}: expected a {ndim}-D {dtype} tensor, got "
            f"{t.dim()}-D {t.dtype}")
