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


def cuda_or_cpu(name: str, tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on a mix or any other device.  Cheap on the card's
    path: no device objects are made there."""
    if all(t.is_cuda for t in tensors):
        if len({t.get_device() for t in tensors}) != 1:
            raise ValueError(f"{name}: tensors on several CUDA devices")
        return True
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def need(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name}: expected a {ndim}-D {dtype} tensor, got "
            f"{t.dim()}-D {t.dtype}")


# Bytes: each output of a wrapper's one allocation starts at a multiple,
# so every view passes the 16-byte check of the wrappers downstream.
ALIGN = 256


def arena_layout(specs) -> tuple:
    """((dtype, shape), ...) of a wrapper's outputs -> (the bytes of one
    allocation that holds them all, each output's (dtype, shape, strides,
    offset in elements of its dtype), each one's byte offset).  Outputs lie
    in the order given, each at a multiple of ``ALIGN`` bytes."""
    at, views, offsets = 0, [], []
    for dtype, shape in specs:
        strides, n = [], 1
        for d in reversed(shape):
            strides.insert(0, n)
            n *= d
        size = dtype.itemsize
        views.append((dtype, tuple(shape), tuple(strides), at // size))
        offsets.append(at)
        at += -(-n * size // ALIGN) * ALIGN
    return at, tuple(views), tuple(offsets)


def carve(nbytes: int, views: tuple, device) -> list:
    """One new allocation of ``nbytes`` on ``device`` and the outputs of
    ``arena_layout`` as views of it (bool and uint8 ones of its bytes).
    Every call allocates anew: the views of an
    earlier call stay as they were."""
    arena = torch.empty(nbytes, dtype=torch.uint8, device=device)
    typed = {torch.int32: arena.view(torch.int32),
             torch.bool: arena.view(torch.bool), torch.uint8: arena}
    return [typed[dt].as_strided(shape, strides, off)
            for dt, shape, strides, off in views]
