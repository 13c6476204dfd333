"""The port's tracing harness and its ``DWT_SELFCHECK`` sanitizer, as
tests/test_utils.py holds the JAX package's, on the CPU."""

import time

import numpy as np
import pytest
import torch

from conftest import random_image

torch.set_num_threads(1)


def test_selfcheck_mode_passes(rng, monkeypatch):
    """DWT_SELFCHECK=1: a healthy encode verifies and returns normally."""
    from dwt_tpu_torch.codec import encoder

    monkeypatch.setenv("DWT_SELFCHECK", "1")
    img = random_image(rng, 48, 40, 3, "mixed")
    stream = encoder.encode(img, device="cpu")
    assert stream[:1] == b"W"


def test_selfcheck_mode_catches_corruption(rng, monkeypatch):
    """A corrupted emit must be caught by the self-check, not returned
    silently."""
    from dwt_tpu_torch.codec import encoder

    monkeypatch.setenv("DWT_SELFCHECK", "1")
    img = random_image(rng, 48, 40, 1, "mixed")
    enc = encoder.Encoder(48, 40, 1, device="cpu")
    real = enc.emit

    def broken(lin, stats, padded_T):
        payload, bits, ends = real(lin, stats, padded_T)
        # flip a stream bit: bit 17 of word 3, as the JAX package's test
        flipped = bytearray(payload)
        flipped[14] ^= 1 << 1
        return bytes(flipped), bits, ends

    enc.emit = broken
    with pytest.raises(AssertionError, match="DWT_SELFCHECK"):
        enc.encode(img)
    monkeypatch.delenv("DWT_SELFCHECK")
    enc.encode(img)  # the sanitizer is off: the corrupt stream goes out


def test_selfcheck_outside_timing_and_capacity(rng, monkeypatch):
    """The check's decode is not in ``info["seconds"]``, and a capacity
    encode (a lossy stream) is not checked."""
    from dwt_tpu_torch.codec import decoder, encoder

    monkeypatch.setenv("DWT_SELFCHECK", "1")
    img = random_image(rng, 40, 32, 3, "mixed")
    enc = encoder.Encoder(40, 32, 3, device="cpu")
    enc.encode(img)  # warm
    calls = []
    real = decoder.decode

    def slow(*a, **k):
        calls.append(k.get("device"))
        time.sleep(0.5)
        return real(*a, **k)

    monkeypatch.setattr(decoder, "decode", slow)
    _, info = enc.encode_with_stats(img)
    assert calls == [enc.device] and info["seconds"] < 0.5
    enc.encode_with_stats(img, capacity=200)
    assert len(calls) == 1


def test_stage_timer_report(monkeypatch):
    from dwt_tpu_torch.utils.trace import StageTimer

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    t = StageTimer()
    t.mark("a", np.arange(4), torch.arange(4))
    t.mark("b")
    rep = t.report()
    assert "a" in rep and "b" in rep and "total" in rep
    assert [n for n, _ in t.stages] == ["a", "b"]
    assert synced == []  # nothing on a card to wait for


def test_device_trace_produces_files(tmp_path):
    from dwt_tpu_torch.utils.trace import device_trace

    with device_trace(str(tmp_path)):
        int(torch.arange(16).sum())
    files = list(tmp_path.rglob("*.json"))
    assert files and "aten::" in files[0].read_text()
