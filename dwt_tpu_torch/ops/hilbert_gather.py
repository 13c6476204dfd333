"""Stage-1 linearization gather (kernel ``csrc/hilbert_gather.cu``).

Port of ``dwt_tpu/ops/pallas_hilbert.py:hilbert_gather_pallas``: (H, W, C)
int32 coefficients -> (C, nlin) int32 in the padded scan order of
``hilbert.padded_layout(pyr, ALIGN)``.  The static permutation arrives as
a precomputed source index per output slot (``-1`` for pads and the root
band, which stay 0: the caller writes the root raster crop).

:func:`engine_supported` is the port of ``pallas_hilbert.engine_supported``:
a one-time probe, per device, that the gather kernel is built and right
before an encoder uses it.  It raises where the JAX package would fall
back.
"""

from __future__ import annotations

import torch

from ..runtime import build
from ._launch import need, on_card


def hilbert_gather_plain(co: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``out[c, i] = co.flat[src[i], c]`` or 0."""
    C = co.shape[2]
    g = co.reshape(-1, C)[src.clamp(min=0).long()]
    return torch.where((src >= 0)[:, None], g, 0).T.contiguous()


def _launch(co: torch.Tensor, src: torch.Tensor, name: str) -> torch.Tensor:
    C, nlin = co.shape[2], src.shape[0]
    out = torch.empty((C, nlin), dtype=torch.int32, device=co.device)
    lib = build.library()
    build.check(lib.dwt_hilbert_gather(co.data_ptr(), src.data_ptr(),
                                       out.data_ptr(), nlin, C,
                                       build.stream_of(co)), name)
    return out


def hilbert_gather(co: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(H, W, C) int32, (nlin,) int32 source indices -> (C, nlin) int32."""
    need("hilbert_gather co", co, torch.int32, 3)
    need("hilbert_gather src", src, torch.int32, 1)
    if not on_card("hilbert_gather", co, src):
        return hilbert_gather_plain(co, src)
    out = _launch(co, src, "hilbert_gather")
    hilbert_gather.launches += 1
    return out


hilbert_gather.launches = 0

TS = 32  # the JAX engine's tile side: the probe is one TS x TS tile
_PROBED: set = set()


def probe_tile(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's inputs: a (TS, TS, 1) int32 tile holding ``arange`` and
    the identity source index, so the gathered row must equal ``arange``."""
    ar = torch.arange(TS * TS, dtype=torch.int32, device=device)
    return ar.reshape(TS, TS, 1), ar


def engine_probe(co: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The probe's launch: the gather kernel on the tile of
    :func:`probe_tile` (any CUDA tensors of those shapes)."""
    need("engine_probe co", co, torch.int32, 3)
    need("engine_probe src", src, torch.int32, 1)
    if not on_card("engine_probe", co, src):
        return hilbert_gather_plain(co, src)
    out = _launch(co, src, "engine_probe")
    engine_supported.launches += 1
    return out


def engine_supported(device) -> bool:
    """Once per CUDA device: gather one 32x32 ``arange`` tile through the
    kernel and hold it to ``arange``.  Returns True, or raises when the
    kernel cannot launch or gives a wrong result (an encoder never falls
    back to another path).  On the CPU there is no kernel to probe."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _PROBED:
        co, src = probe_tile(device)
        got = engine_probe(co, src).reshape(-1)
        if not torch.equal(got, src):
            bad = int((got != src).sum())
            raise RuntimeError(
                f"engine_supported: the gather kernel on {device} got "
                f"{bad} of {TS * TS} probe values wrong")
        _PROBED.add(device)
    return True


engine_supported.launches = 0
