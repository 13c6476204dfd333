"""The port against corrupt and adversarial input (tests/test_robustness.py
mirrored).  The decoder reads untrusted streams: corrupt field values must
give a hard ``ValueError``, and bit flips or random payloads behind a valid
header must give what the JAX package's decoder gives (the same pixels, or
``ValueError`` from both).  ``specmodel`` is no oracle here: on corrupt
streams it raises ``OverflowError`` where the native parser refuses.  The
encoder's static limits (planes, stream bits) must raise, never emit."""

import numpy as np
import pytest
import torch

from conftest import random_image

torch.set_num_threads(1)


def _header(w, h, gray):
    return bytes([
        ord("W"), ord("5") if gray else ord("6"),
        (w - 1) & 255, ((w - 1) >> 8) & 255,
        (h - 1) & 255, ((h - 1) >> 8) & 255,
    ])


def _decode(stream):
    from dwt_tpu_torch.codec import decoder

    return decoder.decode(stream, device="cpu")


@pytest.mark.parametrize("name,stream", [
    # an adaptive-VLI root bit count of ~2^47
    ("huge root count", _header(16, 16, True)
     + b"\x00" * 6 + b"\x01" + b"\x00" * 6 + b"\xff" * 8),
    # root count 0, then a plane count of ~2^46
    ("huge plane count", _header(16, 16, True)
     + b"\x01" + b"\x00" * 5 + b"\x01" + b"\xff" * 8),
    ("truncated root", _header(64, 64, False) + b"\xfe"),
])
def test_hard_errors(name, stream):
    from dwt_tpu.codec import decoder as jd

    with pytest.raises(ValueError):
        _decode(stream)
    with pytest.raises(ValueError):
        jd.decode(stream)


def test_planes_guard():
    from dwt_tpu_torch.codec import encoder
    from dwt_tpu_torch.codec.stage1 import PMAX

    assert PMAX == 29
    assert encoder._check_planes(PMAX) == PMAX
    with pytest.raises(ValueError, match="bitplanes"):
        encoder._check_planes(PMAX + 1)


def test_stream_bits_guard():
    from dwt_tpu_torch.codec import encoder
    from dwt_tpu_torch.codec.emit import LMAX

    assert LMAX >= 2 * max(16, 29) - 1
    assert encoder._check_stream_bits(2**31 - 1) == 2**31 - 1
    with pytest.raises(ValueError, match="tiled"):
        encoder._check_stream_bits(2**31)


def _same_outcome(stream):
    from dwt_tpu.codec import decoder as jd

    try:
        want = np.asarray(jd.decode(stream)[0])
    except ValueError:
        with pytest.raises(ValueError):
            _decode(stream)
        return False
    got, _ = _decode(stream)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    return True


def test_bitflip_fuzz_matches_jax():
    """Single-bit flips of a valid stream (header kept)."""
    from dwt_tpu_torch.codec import encoder

    rng = np.random.default_rng(77)
    img = random_image(rng, 96, 64, 3, "mixed")
    stream = encoder.encode(img, device="cpu")
    decoded = 0
    for _ in range(40):
        pos = int(rng.integers(6, len(stream)))
        mut = bytearray(stream)
        mut[pos] ^= 1 << int(rng.integers(0, 8))
        decoded += _same_outcome(bytes(mut))
    assert decoded > 0


@pytest.mark.parametrize("w,h,gray", [(64, 48, False), (33, 17, True)])
def test_random_blob_fuzz_matches_jax(w, h, gray):
    """Random payloads behind a valid header."""
    rng = np.random.default_rng(78)
    for _ in range(30):
        n = int(rng.integers(1, 4000))
        _same_outcome(_header(w, h, gray)
                      + rng.integers(0, 256, n, dtype=np.uint8).tobytes())
