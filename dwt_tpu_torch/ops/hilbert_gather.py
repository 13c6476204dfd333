"""Stage-1 linearization gather (kernel ``csrc/hilbert_gather.cu``).

Port of ``dwt_tpu/ops/pallas_hilbert.py:hilbert_gather_pallas``: (H, W, C)
int32 coefficients -> (C, nlin) int32 in the padded scan order of
``hilbert.padded_layout(pyr, ALIGN)``, or N frames (N, H, W, C) -> (N, C,
nlin) in one launch (the JAX kernel under ``jax.vmap``).  The static
permutation arrives as a precomputed source index per output slot, shared
by the frames (``-1`` for pads and the root band, which stay 0: the
caller writes the root raster crop).

:func:`engine_supported` is the port of ``pallas_hilbert.engine_supported``:
a one-time probe, per device, that the gather and scatter kernels (the
two tile engines of the JAX package) are built and right before an
encoder or a decoder uses them: one host call (``csrc/probe.cu``) runs
both on one tile and counts the wrong values on the card.  It raises
where the JAX package would fall back.
"""

from __future__ import annotations

import torch

from ..runtime import build
from . import hilbert_scatter as _hs
from ._launch import need, on_card


def hilbert_gather_plain(co: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``out[..., c, i] = co[...].flat[src[i], c]``
    or 0."""
    C = co.shape[-1]
    g = co.reshape(*co.shape[:-3], -1, C)[..., src.clamp(min=0).long(), :]
    return torch.where((src >= 0)[:, None], g, 0).transpose(-1, -2) \
        .contiguous()


def hilbert_gather(co: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(H, W, C) int32, (nlin,) int32 source indices -> (C, nlin) int32;
    (N, H, W, C) -> (N, C, nlin)."""
    if co.dim() not in (3, 4):
        raise ValueError(f"hilbert_gather co: expected (H, W, C) or (N, H, "
                         f"W, C), got {co.dim()}-D")
    need("hilbert_gather co", co, torch.int32, co.dim())
    need("hilbert_gather src", src, torch.int32, 1)
    if not on_card("hilbert_gather", co, src):
        return hilbert_gather_plain(co, src)
    H, W, C = co.shape[-3:]
    nlin = src.shape[0]
    out = torch.empty((*co.shape[:-3], C, nlin), dtype=torch.int32,
                      device=co.device)
    build.check(build.library().dwt_hilbert_gather(
        co.data_ptr(), src.data_ptr(), out.data_ptr(), nlin, C,
        co.shape[0] if co.dim() == 4 else 1, H * W * C,
        build.stream_of(co)), "hilbert_gather")
    hilbert_gather.launches += 1
    return out


hilbert_gather.launches = 0

TS = 32  # the JAX engine's tile side: the probe is one TS x TS tile
_PROBED: set = set()
_BUFFERS: dict = {}


def probe_tile(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's inputs: a (TS, TS, 1) int32 tile holding ``arange`` and
    the identity source index, so the gathered row must equal ``arange``."""
    ar = torch.arange(TS * TS, dtype=torch.int32, device=device)
    return ar.reshape(TS, TS, 1), ar


def _indexed(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def probe_buffers(device) -> tuple:
    """(tile, idx, out, bad) of the probe on ``device``, made once: the
    tile and index of :func:`probe_tile` (flat), a (2 * TS * TS,) int32
    output and a (2,) int32 mismatch count."""
    device = _indexed(device)
    if device not in _BUFFERS:
        co, src = probe_tile(device)
        _BUFFERS[device] = (
            co.reshape(-1), src,
            torch.empty(2 * TS * TS, dtype=torch.int32, device=device),
            torch.empty(2, dtype=torch.int32, device=device))
    return _BUFFERS[device]


def engine_probe_plain(tile, idx, out, bad) -> None:
    """Plain PyTorch version of :func:`engine_probe`."""
    n = idx.numel()
    out[:n] = hilbert_gather_plain(tile.reshape(TS, TS, 1), idx).reshape(-1)
    out[n:] = _hs.hilbert_scatter_plain(
        tile.reshape(1, -1), idx.reshape(TS, TS)).reshape(-1)
    want = torch.arange(n, dtype=out.dtype, device=out.device)
    bad.copy_((out.reshape(2, n) != want).sum(dim=1).to(bad.dtype))


def engine_probe(tile, idx, out, bad) -> None:
    """The probe's one host call, on the buffers of :func:`probe_buffers`:
    the gather kernel writes ``tile`` gathered through ``idx`` into
    ``out[:TS*TS]``, the scatter kernel the tile scattered through the
    (TS, TS) index into ``out[TS*TS:]``, and a compare kernel the count of
    values in each half that differ from ``arange`` into ``bad`` (three
    launches, issued from C).  On CPU tensors, the plain version.  The
    buffers are the probe's own, so nothing is checked here."""
    if not tile.is_cuda:
        return engine_probe_plain(tile, idx, out, bad)
    build.check(build.library().dwt_engine_probe(
        tile.data_ptr(), idx.data_ptr(), out.data_ptr(), bad.data_ptr(),
        TS * TS, build.stream_of(tile)), "engine_supported")
    engine_supported.launches += 3


def engine_supported(device) -> bool:
    """Once per CUDA device: send one 32x32 ``arange`` tile through the
    gather kernel and through the scatter kernel and count the values that
    differ from ``arange`` on the card, in one host call
    (:func:`engine_probe`), then read the two counts.  Returns True, or
    raises when a kernel cannot launch or gives a wrong result (an encoder
    or decoder never falls back to another path).  On the CPU there is no
    kernel to probe."""
    device = _indexed(device)
    if device.type != "cuda":
        return True
    if device not in _PROBED:
        bufs = probe_buffers(device)
        engine_probe(*bufs)
        for kind, bad in zip(("gather", "scatter"), bufs[3].tolist()):
            if bad:
                raise RuntimeError(
                    f"engine_supported: the {kind} kernel on {device} got "
                    f"{bad} of {TS * TS} probe values wrong")
        _PROBED.add(device)
    return True


engine_supported.launches = 0
