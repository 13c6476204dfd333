"""Single-stream lossless encoder: the entry point of the port's encode path.

Port of ``dwt_tpu/codec/encoder.py``'s ``Encoder``, ``get_encoder`` and
``encode``: stage 1 (codec/stage1.py), the tokens half (codec/tokens.py)
and the emit half (codec/emit.py), writing the same ``.dwt`` bytes as the
JAX package and the reference C encoder.  Four CUDA kernels run on the
path: the linearization gather (and its one-time probe when an encoder
is built), compaction kernels A and B and the codeword packer.

Not ported yet, and refused with ``NotImplementedError`` rather than
approximated: byte-budget truncation (``capacity > 0``) and the tiled
``.dwtt`` container for images beyond the single-stream envelope.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..geometry import compute_pyramid
from ..ops import pack
from ..ops.hilbert_gather import engine_supported
from .emit import _stage2_emit
from .stage1 import (ALIGN, NSTATE, PMAX, _transform_and_stats,
                     gather_source)
from .tokens import _stage2_tokens

# Coefficient ceiling of one .dwt stream (as in the JAX package): beyond it
# the JAX package writes the tiled .dwtt container.
SINGLE_STREAM_MAX_COEFFS = 1 << 27

_LATER = "is not ported yet (a later slice of the port); use dwt_tpu"


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _check_planes(planes_max: int) -> int:
    """Magnitudes must stay below 2^29 (bits 29/30 are the sig/ref flags,
    encode.c:115-128): more planes cannot be coded by the format."""
    if planes_max > PMAX:
        raise ValueError(
            f"coefficient magnitude needs {planes_max} bitplanes; the format "
            f"supports at most {PMAX} (magnitudes < 2^29, reference "
            "encode.c:115-128)")
    return planes_max


def _total_bits_host(bits_parts) -> int:
    """Exact stream bit count from the int32 partial sums, totaled in
    Python ints so nothing can wrap."""
    return int(np.asarray(torch.as_tensor(bits_parts).cpu(),
                          dtype=np.int64).sum())


def _check_stream_bits(total_bits: int) -> int:
    """Single-stream bit offsets are int32: a stream of 2^31 bits or more
    would have wrapped them."""
    if total_bits >= 2**31:
        raise ValueError(
            f"stream needs {total_bits} bits; single .dwt streams are "
            "limited to 2^31 bits — the tiled container " + _LATER)
    return total_bits


def _stream_words_bytes(words: torch.Tensor, nbytes: int) -> bytes:
    """The first ``nbytes`` bytes of the little-endian stream words."""
    n = (nbytes + 3) // 4
    return words[:n].cpu().numpy().astype("<i4").tobytes()[:nbytes]


def _bucket(t: int) -> int:
    """Token counts padded to coarse buckets (sixteenths of powers of two,
    multiples of the pack block), as in the JAX package."""
    t = max(t, 4 * pack.BLOCKN)
    b = 1 << (t - 1).bit_length()
    for m in range(9, 16):
        if m * b // 16 >= t:
            b = m * b // 16
            break
    return _round_up(b, pack.BLOCKN)


def _ilog2_host(x: int) -> int:
    return x.bit_length() - 1


def _root_bits_host(stats, pix0: int) -> int:
    """Exact bit count of the root-band coding (encode.c:97-110), replayed
    on the host from the stage-1 stats: per channel one VLI(cnt) through
    the adaptive order chain (which starts at 0), then cnt raw bits per
    coefficient and one sign bit per nonzero."""
    root_cnt = np.asarray(torch.as_tensor(stats["root_cnt"]).cpu())
    root_base = np.asarray(torch.as_tensor(stats["root_base"]).cpu())
    planes_base = int(stats["planes_base"])
    ends = np.concatenate([root_base[1:], [planes_base]])
    bits = 0
    s = 0
    for c in range(root_cnt.shape[0]):
        v = cnt = int(root_cnt[c])
        k = max(_ilog2_host(v + (1 << s)) - s, 0)
        bits += 2 * k + s + 1
        s = min(max(s + k - 2, 0), NSTATE - 1)
        if cnt > 0:
            nnz = int(ends[c] - root_base[c]) - 1 - pix0
            bits += pix0 * cnt + nnz
    return bits


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dwt_tpu_torch: no CUDA device; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


class Encoder:
    """Encoder for one (width, height, channels) geometry on one device:
    holds the static layout (the gather's source index) and reuses it
    across images.  ``device`` defaults to the CUDA card."""

    def __init__(self, width: int, height: int, channels: int, device=None):
        self.device = _device(device)
        self.pyr = compute_pyramid(width, height)
        self.channels = channels
        self.gray = channels == 1
        seg_max = max((self.pyr.pixels[l + 1] - self.pyr.pixels[l]
                       for l in range(self.pyr.levels)), default=0) + ALIGN
        if seg_max >= 1 << 30:
            # Kernel A packs (zero-prefix << 1) | sign into one int32.
            raise NotImplementedError(
                f"{width}x{height}: a detail segment of 2^30 elements or more "
                "needs the tiled container, which " + _LATER)
        engine_supported(self.device)  # the gather's probe, once a device
        self._src = torch.as_tensor(gather_source(self.pyr),
                                    device=self.device)

    def header(self) -> bytes:
        w, h = self.pyr.width, self.pyr.height
        return bytes([
            ord("W"), ord("5") if self.gray else ord("6"),
            (w - 1) & 255, ((w - 1) >> 8) & 255,
            (h - 1) & 255, ((h - 1) >> 8) & 255,
        ])

    def encode(self, img: np.ndarray, capacity: int = 0) -> bytes:
        return self.encode_with_stats(img, capacity)[0]

    def encode_with_stats(self, img: np.ndarray, capacity: int = 0) -> tuple:
        """Returns (stream bytes, info dict) — the structured counterpart of
        the reference's stderr bit counters (encode.c:176,180,230)."""
        if capacity > 0:
            raise NotImplementedError("byte-budget truncation " + _LATER)
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape != (self.pyr.height, self.pyr.width, self.channels):
            raise ValueError(
                f"image shape {img.shape} does not match the encoder's "
                f"{(self.pyr.height, self.pyr.width, self.channels)}")
        pyr, C = self.pyr, self.channels
        t0 = time.perf_counter()
        lin, stats = _transform_and_stats(
            torch.as_tensor(img, device=self.device), pyr, C, self.gray,
            self._src)
        T = int(stats["T"])
        _check_planes(int(stats["planes_max"]))
        padded_T = _bucket(T)
        tv, tr, tf, orders, vmag, com = _stage2_tokens(lin, stats, pyr, C,
                                                       padded_T)
        words, bits_parts, _, layer_ends = _stage2_emit(
            lin, stats, tv, tr, tf, orders, vmag, com, pyr, C, padded_T)
        total_bits = _check_stream_bits(_total_bits_host(bits_parts))
        stream = self.header() + _stream_words_bytes(words,
                                                     (total_bits + 7) // 8)
        dt = time.perf_counter() - t0
        le = layer_ends.cpu().numpy()
        info = {
            "tokens": T,
            "payload_bits": total_bits,
            "meta_bits": 8 * len(self.header()),
            "root_bits": _root_bits_host(stats, pyr.pixels[0]),
            "bytes": len(stream),
            "planes": stats["planes"].cpu().tolist(),
            "levels": pyr.levels,
            "layer_end_bytes": np.unique(
                (le[le < 2**31 - 1] + 7) // 8).tolist(),
            "seconds": dt,
            "mps": pyr.total / 1e6 / dt,
        }
        return stream, info


@functools.lru_cache(maxsize=64)
def get_encoder(width: int, height: int, channels: int,
                device=None) -> Encoder:
    return Encoder(width, height, channels, device)


def encode(img: np.ndarray, gray: bool | None = None, capacity: int = 0,
           container: bool | None = None, device=None) -> bytes:
    """Encode to a single .dwt stream.  ``gray`` is implied by the channel
    count (kept for the JAX package's signature).  ``capacity > 0``,
    ``container=True`` and images beyond the single-stream envelope raise
    NotImplementedError: those routes are later slices of the port."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if container:
        raise NotImplementedError("the tiled .dwtt container " + _LATER)
    if h * w * c > SINGLE_STREAM_MAX_COEFFS:
        raise NotImplementedError(
            f"{w}x{h}x{c} exceeds the single-stream envelope "
            f"({SINGLE_STREAM_MAX_COEFFS} coefficients); the tiled .dwtt "
            "container " + _LATER)
    return get_encoder(w, h, c, device).encode(img, capacity)
