"""Single-stream decoder: the entry point of the port's decode path.

Port of ``dwt_tpu/codec/decoder.py``'s ``parse_header``, ``_tail_fn`` and
``decode``.  The host C++ parser (``runtime/native.py``) fills the
linearized coefficients: the bit parse of one stream is serial, as in the
JAX package.  On the device, the inverse tail is two launches or more
and no eager pass: the inverse Hilbert scatter (the CUDA kernel
``csrc/hilbert_scatter.cu``), then kernel 16 (``csrc/lifting_inv.cu``,
through ``ops/lifting.py:inverse_transform``), which reads the scatter's
output, the root band in the parsed coefficients and a small table of the
missing-plane midpoint bias in place, adds the bias to each detail
coefficient as it loads it, and runs the inverse lifting, the inverse
colour transform, the clamp and the uint8 cast.  A warm decode uploads the
coefficients and, where planes are missing, that table.

Truncation and reduced-resolution semantics follow decode.c:136-268: the
output size is that of the deepest level actually decoded; a stream that
dies inside the root band is a hard error (``ValueError``).

``decode_batch`` decodes many same-geometry streams (the tiles of a
``.dwtt`` container, ``codec/tiled.py``): one parse on the parser's host
thread pool, then one batched tail per decoded-level group.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..geometry import compute_pyramid
from ..hilbert import reconstruction_perm
from ..ops.hilbert_gather import engine_supported
from ..ops.hilbert_scatter import hilbert_scatter, square_runs
from ..ops.lifting import bias_plain, inverse_transform, pyramid_chain
from ..runtime import native
from .encoder import _device


def parse_header(stream: bytes) -> tuple:
    if len(stream) < 6 or stream[0] != ord("W") or stream[1] not in (ord("5"), ord("6")):
        raise ValueError("bad header")
    gray = stream[1] == ord("5")
    W = stream[2] + (stream[3] << 8) + 1
    H = stream[4] + (stream[5] << 8) + 1
    return W, H, gray


def scatter_source(pyr) -> np.ndarray:
    """The scatter kernel's (H, W) int32 source index for one pyramid: the
    scan position of each pixel, -1 on the root band."""
    inv = reconstruction_perm(pyr)
    src = np.where(inv < pyr.pixels[0], -1, inv).astype(np.int32)
    return src.reshape(pyr.height, pyr.width)


class _Tail:
    """The inverse tail for one (geometry, decoded levels, channels)
    combination on one device.  Its static tables (the scatter's source
    index and its run table) are built once and kept on the device, so a
    warm decode uploads only the coefficients and, where planes are
    missing, the (N, C, 16) bias table made from ``missing``."""

    def __init__(self, width: int, height: int, out_levels: int,
                 channels: int, gray: bool, device: torch.device):
        pyr = compute_pyramid(width, height)
        self.out_h, self.out_w = pyr.heights[out_levels], pyr.widths[out_levels]
        self.n_out = pyr.pixels[out_levels]
        self.channels, self.gray, self.device = channels, gray, device
        self.out_levels = out_levels
        if out_levels == 0:
            return
        # The level chain of the reduced pyramid coincides with the
        # original's lower levels, so scan order, lifting geometry and the
        # level of a scan position are shared.
        self.sub_pyr = compute_pyramid(self.out_w, self.out_h)
        assert self.sub_pyr.levels == out_levels
        self.chain = pyramid_chain(self.sub_pyr)
        engine_supported(device)  # the tile engines' probe, once a device
        src = scatter_source(self.sub_pyr)
        self.src = torch.as_tensor(src, device=device)
        self.runs = tuple(torch.as_tensor(a, device=device)
                          for a in square_runs(src))  # (sq_ptr, runs)

    def bias_table(self, missing: np.ndarray) -> torch.Tensor | None:
        """The (N, C, 16) int32 midpoint-bias magnitudes of the parser's
        (N, C, 16) missing-plane counts on the device: 2^(missing - 2)
        where two planes or more are missing (decode.c:50-58), else 0; None
        where no decoded level has two planes missing."""
        if not (missing[..., :self.out_levels] >= 2).any():
            return None
        # Made in pinned memory and uploaded without blocking the host
        # (the pinned block is not reused before its copy is done).
        table = torch.empty(missing.shape, dtype=torch.int32,
                            pin_memory=self.device.type == "cuda")
        np.copyto(table.numpy(), np.where(missing >= 2, np.left_shift(
            1, np.clip(missing - 2, 0, 30)), 0), casting="unsafe")
        return table.to(self.device, non_blocking=True)

    def _views(self, coeffs: torch.Tensor) -> tuple:
        """(N, C, total >= n_out) int32 coefficients on the device -> the
        scatter's (outH, outW, N * C) output as an (N, outH, outW, C) view
        (one scatter launch for the N streams as N*C channels; 0 on the
        root band) and the root band as an (N, h0, w0, C) view of
        ``coeffs``."""
        N, C = coeffs.shape[0], self.channels
        x = hilbert_scatter(coeffs.reshape(N * C, -1), self.src, *self.runs)
        x = x.view(self.out_h, self.out_w, N, C).permute(2, 0, 1, 3)
        h0, w0 = self.sub_pyr.heights[0], self.sub_pyr.widths[0]
        root = coeffs[..., :h0 * w0].unflatten(2, (h0, w0)).permute(
            0, 2, 3, 1)
        return x, root

    def pyramid(self, coeffs: torch.Tensor,
                missing: np.ndarray) -> torch.Tensor:
        """(N, C, total >= n_out) int32 coefficients on the device and the
        parser's (N, C, 16) missing-plane counts -> (N, outH, outW, C) int32
        coefficients in the deinterleaved pyramid layout, midpoint bias
        applied (``out_levels`` > 0), for the sharded decoder: the
        scatter's output copied to frame-major order, the root band written
        into it, the bias by ``lifting.bias_plain``."""
        x, root = self._views(coeffs)
        x = x.contiguous()
        x[:, :root.shape[1], :root.shape[2]] = root
        bias = self.bias_table(missing)
        return x if bias is None else bias_plain(x, self.chain, bias)

    def batch(self, coeffs: torch.Tensor, missing: np.ndarray) -> torch.Tensor:
        """(N, C, total >= n_out) int32 coefficients on the device and the
        parser's (N, C, 16) missing-plane counts -> (N, outH, outW, C)
        uint8: one scatter launch for the N streams as N*C channels, then
        kernel 16 (on the card) reading the scatter's output, the root band
        and the bias table in place."""
        N, C, n_out = coeffs.shape[0], self.channels, self.n_out
        if self.out_levels == 0:
            # Root-only decode: the reference still runs one inverse lifting
            # pass at root size (decode.c:258 quirk, SURVEY §2.5).
            x = coeffs[..., :n_out].unflatten(
                2, (self.out_h, self.out_w)).permute(0, 2, 3, 1)
            return inverse_transform(x, ((self.out_h, self.out_w),),
                                     not self.gray, True)
        x, root = self._views(coeffs)
        return inverse_transform(x, self.chain, not self.gray, True,
                                 self.bias_table(missing), root)

    def __call__(self, coeffs: torch.Tensor, missing: np.ndarray) -> torch.Tensor:
        """(C, total >= n_out) int32 coefficients on the device and the
        parser's (C, 16) missing-plane counts -> (outH, outW, C) uint8."""
        return self.batch(coeffs[None], missing[None])[0]


@functools.lru_cache(maxsize=64)
def _tail(width: int, height: int, out_levels: int, channels: int,
          gray: bool, device: torch.device) -> _Tail:
    return _Tail(width, height, out_levels, channels, gray, device)


def _levels_max(pyr, pixels_max: int) -> int:
    """The deepest level with at most ``pixels_max`` pixels (all levels
    when ``pixels_max`` is 0)."""
    levels_max = pyr.levels
    if pixels_max > 0:
        while levels_max > 0 and pyr.pixels[levels_max] > pixels_max:
            levels_max -= 1
    return levels_max


def _parse(stream: bytes, pixels_max: int, device: torch.device) -> tuple:
    """Header and host parse.  Returns (W, H, gray, coeffs, missing,
    out_levels): ``coeffs`` is a (C, W*H) int32 CPU tensor, pinned when
    ``device`` is a CUDA device, so its upload can run asynchronously."""
    W, H, gray = parse_header(stream)
    C = 1 if gray else 3
    pyr = compute_pyramid(W, H)
    # The parser ORs bits into a zeroed buffer.
    coeffs = torch.zeros((C, pyr.total), dtype=torch.int32,
                         pin_memory=device.type == "cuda")
    _, missing, level, _ = native.entropy_decode(
        stream[6:], C, pyr.levels, _levels_max(pyr, pixels_max), pyr.pixels,
        coeffs.numpy())
    return W, H, gray, coeffs, missing, level + 1


def decode(stream: bytes, pixels_max: int = 0, device=None) -> tuple:
    """Decode one ``.dwt`` stream, or a ``.dwtt`` container (the format
    ``encoder.encode`` routes oversized images to); returns (image uint8
    (H, W, C), gray).

    ``pixels_max > 0`` caps the output at the deepest level with at most
    that many pixels.  ``device`` defaults to the CUDA card; without one
    this raises unless ``device="cpu"`` is passed (the kernels' plain
    PyTorch versions)."""
    if stream[:2] == b"WT":
        from . import tiled

        return tiled.decode_tiled(stream, pixels_max=pixels_max,
                                  device=device)
    device = _device(device)
    W, H, gray, coeffs, missing, out_levels = _parse(stream, pixels_max,
                                                     device)
    tail = _tail(W, H, out_levels, 1 if gray else 3, gray, device)
    img = tail(coeffs.to(device, non_blocking=True), missing)
    return img.cpu().numpy(), gray


def decode_batch(payloads: list, width: int, height: int, gray: bool,
                 pixels_max: int = 0, nthreads: int = 0, device=None) -> list:
    """Decode many same-geometry headerless payloads: one parse on the
    host thread pool (``nthreads`` 0 = the hardware's concurrency) into a
    zeroed pinned buffer, one upload, then one batched tail per
    decoded-level group.

    Returns a list of (H', W', C) uint8 images (the size depends on how far
    each stream decoded).  Streams that died inside the root band come
    back as None."""
    device = _device(device)
    C = 1 if gray else 3
    pyr = compute_pyramid(width, height)
    buf = torch.zeros((len(payloads), C, pyr.total), dtype=torch.int32,
                      pin_memory=device.type == "cuda")
    _, missing, level, _, rc = native.entropy_decode_batch(
        payloads, C, pyr.levels, _levels_max(pyr, pixels_max), pyr.pixels,
        nthreads, buf.numpy())
    coeffs = buf.to(device, non_blocking=True)
    out = [None] * len(payloads)
    for lv in np.unique(level):
        idx = np.nonzero((level == lv) & (rc == 0))[0]
        if idx.size == 0:
            continue
        tail = _tail(width, height, int(lv) + 1, C, gray, device)
        sel = coeffs if idx.size == len(payloads) else coeffs[
            torch.as_tensor(idx, device=device)]
        imgs = tail.batch(sel, missing[idx]).cpu().numpy()
        for j, i in enumerate(idx):
            out[int(i)] = imgs[j]
    return out
