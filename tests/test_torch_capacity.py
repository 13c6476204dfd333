"""Byte-budget truncation (``capacity > 0``) in the port's encoder, against
the JAX package (tests/test_encoder.py's capacity tests, mirrored): the
capacity stream equals ``dwt_tpu``'s and the lossless stream's prefix, a
deep budget codes far fewer tokens, and the schedule cuts (the replacement
stats leaves and the tiled path's layer helpers) equal the JAX package's
on the same host stats.  Exact: all of it is integer.  On the CPU each
kernel wrapper runs its plain PyTorch version."""

import numpy as np
import pytest
import torch

from conftest import random_image

torch.set_num_threads(1)

W, H, C = 160, 128, 3


@pytest.fixture(scope="module")
def case():
    from dwt_tpu.codec import encoder as je
    from dwt_tpu_torch.codec import encoder

    img = random_image(np.random.default_rng(11), W, H, C, "mixed")
    full = je.encode(img)
    enc = encoder.get_encoder(W, H, C, "cpu")
    assert enc.encode(img) == full
    return img, full, enc


def test_encoder_capacity():
    from dwt_tpu.codec import encoder as je
    from dwt_tpu_torch.codec import encoder

    img = random_image(np.random.default_rng(5), 64, 64, 3, "mixed")
    full = je.encode(img)
    got = encoder.encode(img, capacity=100, device="cpu")
    assert got == je.encode(img, capacity=100) == full[:100]


@pytest.mark.parametrize("cap", [7, 20, 100, 400, 1500, "half", "-3", "+50"])
def test_capacity_prefix_exact(case, cap):
    """At every budget class (mid-header, mid-root, one layer,
    mid-schedule, near-full, past the end) the stream is the lossless
    stream's prefix, and its info counts the bytes kept."""
    img, full, enc = case
    cap = {"half": len(full) // 2, "-3": len(full) - 3,
           "+50": len(full) + 50}.get(cap, cap)
    got, info = enc.encode_with_stats(img, cap)
    assert got == full[:cap]
    assert info["bytes"] == len(got)


@pytest.mark.parametrize("cap", [400, 2000])
def test_capacity_equals_jax(case, cap):
    """The port's capacity stream and token count equal the JAX encoder's
    with the same budget."""
    from dwt_tpu.codec import encoder as je

    img, _, enc = case
    got, info = enc.encode_with_stats(img, cap)
    want, jinfo = je.get_encoder(W, H, C).encode_with_stats(img, cap)
    assert got == want and info["tokens"] == jinfo["tokens"]


def test_budget_bounded_skips_work():
    """A deep budget codes a small fraction of the full token count."""
    from dwt_tpu_torch.codec import encoder

    img = random_image(np.random.default_rng(13), 320, 240, 3, "mixed")
    enc = encoder.get_encoder(320, 240, 3, "cpu")
    _, full = enc.encode_with_stats(img)
    s, deep = enc.encode_with_stats(img, 2000)
    assert len(s) == 2000
    assert deep["tokens"] < full["tokens"] // 4


def _host(img):
    from dwt_tpu_torch.codec import encoder

    h, w, c = img.shape
    enc = encoder.get_encoder(w, h, c, "cpu")
    return enc, encoder.host_stats(enc.stage1(img)[1])


@pytest.mark.parametrize("cap", [7, 150, 900, 4000, 10**6])
def test_truncate_schedule_equals_jax(case, cap):
    """The replacement leaves of a capacity cut, key by key and dtype by
    dtype, for the same host stats; and the patched device stats keep the
    stage-1 dtypes."""
    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu_torch.codec import encoder

    img = case[0]
    enc, host = _host(img)
    want = je._truncate_schedule(dict(host), cap, compute_pyramid(W, H), C)
    got = encoder._truncate_schedule(dict(host), cap, enc.pyr, C)
    if want is None:
        assert got is None and cap == 10**6
        return
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k
    stats = enc.stage1(img)[1]
    patched = encoder.patch_stats(stats, got)
    for k in got:
        assert patched[k].dtype == stats[k].dtype, k
        assert np.array_equal(patched[k].numpy(), got[k]), k


@pytest.mark.parametrize("wh,c", [((160, 128), 3), ((64, 56), 1)])
def test_layer_helpers_equal_jax(wh, c):
    """The tiled path's layer helpers: schedule layers, lower-bound layer
    bytes and every layer cap."""
    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu_torch.codec import encoder
    from dwt_tpu_torch.codec.emit import LMAX

    img = random_image(np.random.default_rng(17), *wh, c, "mixed")
    enc, host = _host(img)
    jpyr = compute_pyramid(*wh)
    assert LMAX == je.LMAX
    assert np.array_equal(encoder._schedule_layers_host(host, enc.pyr, c),
                          je._schedule_layers_host(host, jpyr, c))
    lb = encoder._layer_lb_bytes_host(host, enc.pyr, c, LMAX)
    assert np.array_equal(lb, je._layer_lb_bytes_host(host, jpyr, c, LMAX))
    cut = 0
    for layer in range(-1, int(host["planes_max"]) + enc.pyr.levels + 1):
        got = encoder._truncate_schedule_to_layer(host, layer, enc.pyr, c)
        want = je._truncate_schedule_to_layer(host, layer, jpyr, c)
        assert (got is None) == (want is None), layer
        if want is not None:
            cut += 1
            for k in want:
                assert np.array_equal(got[k], want[k]), (layer, k)
    assert cut > 2
