"""The port's decode path against the JAX package.

The inverse transforms, the inverse permutation, the scatter's plain
version (against the Pallas scatter in interpret mode), the host parser's
source and loader, PNM bytes, and ``decode(device="cpu")`` against
``dwt_tpu.codec.decoder.decode`` on the streams of ``dwt_tpu``'s encoder:
lossless, truncated prefixes, reduced resolution, root-only.  Exact: all
of it is integer.  On the CPU the scatter wrapper runs its plain version.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import random_image

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

CASES = [  # tests/test_decoder.py's
    (320, 240, 3, "mixed"),
    (321, 239, 1, "mixed"),
    (8, 8, 1, "mixed"),
    (9, 8, 3, "noise"),
    (64, 64, 3, "flat"),
    (96, 80, 3, "mixed"),
]


@functools.lru_cache(maxsize=None)
def _stream(w, h, c, kind, seed=0):
    """An image and its stream from the JAX package's encoder."""
    from dwt_tpu.codec.encoder import get_encoder

    img = random_image(np.random.default_rng(seed), w, h, c, kind)
    return img, get_encoder(w, h, c).encode(img)


def _both(stream, pixels_max=0):
    """(JAX package's result, port's result); each an image and gray, or
    the exception it raised."""
    from dwt_tpu.codec import decoder as jd
    from dwt_tpu_torch.codec import decoder as td

    out = []
    for fn in (lambda: jd.decode(stream, pixels_max),
               lambda: td.decode(stream, pixels_max, device="cpu")):
        try:
            out.append(fn())
        except ValueError as e:
            out.append(e)
    return out


def _same(want, got):
    if isinstance(want, Exception):
        assert isinstance(got, ValueError), got
        return
    (wi, wg), (gi, gg) = want, got
    assert gg == wg and gi.dtype == np.uint8
    assert gi.shape == wi.shape and np.array_equal(gi, wi)


@pytest.mark.parametrize("n", [8, 9, 15, 16, 17, 101, 240])
@pytest.mark.parametrize("axis", [0, 1])
def test_cdf53_inv(rng, n, axis):
    import jax.numpy as jnp

    from dwt_tpu.ops import lifting as jl
    from dwt_tpu_torch.ops import lifting as tl

    shape = (n, 5) if axis == 0 else (5, n)
    x = rng.integers(-1000, 1000, shape).astype(np.int32)
    want = np.asarray(jl.cdf53_inv(jnp.asarray(x), axis=axis))
    got = tl.cdf53_inv(torch.as_tensor(x), axis=axis).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    back = tl.cdf53_inv(tl.cdf53_fwd(torch.as_tensor(x), axis), axis)
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("w,h", [(320, 240), (321, 239), (8, 8), (64, 48),
                                 (17, 1000)])
def test_dwt2d_inv(rng, w, h):
    import jax
    import jax.numpy as jnp

    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu.ops import lifting as jl
    from dwt_tpu_torch import geometry
    from dwt_tpu_torch.ops import lifting as tl

    co = rng.integers(-2000, 2000, (h, w, 3)).astype(np.int32)
    pyr = compute_pyramid(w, h)
    want = np.asarray(jax.jit(lambda x: jl.dwt2d_inv(x, pyr))(
        jnp.asarray(co)))
    x = torch.as_tensor(co)
    tp = geometry.compute_pyramid(w, h)
    got = tl.dwt2d_inv(x, tp).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(x.numpy(), co)  # the input is left as it was
    img = torch.as_tensor(co % 256)
    assert torch.equal(tl.dwt2d_inv(tl.dwt2d_fwd(img, tp), tp), img)


def test_ycocg_to_rgb(rng):
    import jax.numpy as jnp

    from dwt_tpu.ops import color as jc
    from dwt_tpu_torch.ops import color as tc

    # Beyond the clamps too: truncated decodes give such values.
    x = rng.integers(-600, 600, (37, 53, 3)).astype(np.int32)
    want = np.asarray(jc.ycocg_to_rgb(jnp.asarray(x)))
    got = tc.ycocg_to_rgb(torch.as_tensor(x)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    img = torch.as_tensor(rng.integers(0, 256, (9, 7, 3)).astype(np.int32))
    assert torch.equal(tc.ycocg_to_rgb(tc.rgb_to_ycocg(img)), img)


@pytest.mark.parametrize("w,h", [(8, 8), (9, 8), (64, 48), (321, 239),
                                 (640, 480)])
def test_reconstruction_perm(w, h):
    from dwt_tpu import geometry as jg
    from dwt_tpu import hilbert as jh
    from dwt_tpu_torch import geometry as tg
    from dwt_tpu_torch import hilbert as th

    want = jh.reconstruction_perm(jg.compute_pyramid(w, h))
    got = th.reconstruction_perm(tg.compute_pyramid(w, h))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("w,h,c", [(320, 240, 1), (64, 48, 3)])
def test_scatter_plain_equals_pallas(w, h, c):
    """The scatter's plain version against the TPU kernel in interpret
    mode, off the root band (which both leave to the caller)."""
    import jax.numpy as jnp

    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu.hilbert import linearization_perm, tile_plan
    from dwt_tpu.ops.pallas_hilbert import hilbert_scatter_pallas
    from dwt_tpu_torch import geometry
    from dwt_tpu_torch.codec.decoder import scatter_source
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    rng = np.random.default_rng(w + c)
    pyr = compute_pyramid(w, h)
    lin = rng.integers(-2**20, 2**20, (c, w * h)).astype(np.int32)
    want = np.asarray(hilbert_scatter_pallas(
        jnp.asarray(lin), tile_plan(pyr, 1), h, w, c, interpret=True))
    src = torch.as_tensor(scatter_source(geometry.compute_pyramid(w, h)))
    before = hs.hilbert_scatter.launches
    got = hs.hilbert_scatter(torch.as_tensor(lin), src).numpy()
    assert hs.hilbert_scatter.launches == before  # plain path: no launch
    off_root = np.zeros(h * w, bool)
    off_root[linearization_perm(pyr)[pyr.pixels[0]:]] = True
    off_root = off_root.reshape(h, w)
    assert got.shape == want.shape == (h, w, c)
    assert np.array_equal(got[off_root], want[off_root])
    assert not got[~off_root].any()  # the root band is left 0


def test_scatter_plain_on_reduced_pyramid_and_bounds():
    """On a reduced sub-pyramid with a longer coefficient row (the
    decoder's case), and indices outside [0, L) give 0."""
    from dwt_tpu_torch import geometry
    from dwt_tpu_torch.codec.decoder import scatter_source
    from dwt_tpu_torch.hilbert import reconstruction_perm
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    sub = geometry.compute_pyramid(24, 20)
    lin = torch.arange(2 * 3000, dtype=torch.int32).reshape(2, 3000)
    got = hs.hilbert_scatter(lin, torch.as_tensor(scatter_source(sub)))
    inv = reconstruction_perm(sub).reshape(20, 24)
    want = np.stack([inv, inv + 3000], -1)
    want[inv < sub.pixels[0]] = 0
    assert np.array_equal(got.numpy(), want)
    src = torch.tensor([[-1, 0, 5, 6]], dtype=torch.int32)
    got = hs.hilbert_scatter(torch.arange(6, dtype=torch.int32)[None], src)
    assert got.reshape(-1).tolist() == [0, 0, 5, 0]


@pytest.mark.parametrize("w,h,c,kind", CASES)
def test_decode_equals_jax(w, h, c, kind):
    img, stream = _stream(w, h, c, kind)
    want, got = _both(stream)
    _same(want, got)
    if kind != "flat":  # flat images decode to root size (parity)
        assert np.array_equal(got[0], img)


@pytest.mark.parametrize("cap", [64, 150, 400, 1200, 5000])
def test_decode_truncated(cap):
    _, stream = _stream(96, 80, 3, "mixed")
    want, got = _both(stream[:cap])
    _same(want, got)
    if cap == 64:  # inside the root band: a hard error in both
        assert isinstance(want, ValueError)


def test_decode_truncated_root_only(monkeypatch):
    """A prefix decoded at root size (out_levels == 0): one inverse lifting
    pass at root size and no scatter.  The parser counts a level as
    decoded once it starts it, so a prefix with a readable root band
    reaches out_levels == 0 only under a pixels_max below level 1's."""
    from dwt_tpu_torch.codec import decoder as td
    from dwt_tpu_torch.geometry import compute_pyramid

    _, stream = _stream(96, 80, 3, "mixed")
    pyr = compute_pyramid(96, 80)
    cut = stream[:400]
    assert td._parse(cut, 0, torch.device("cpu"))[-1] > 0
    assert td._parse(cut, pyr.pixels[0], torch.device("cpu"))[-1] == 0
    calls = []
    real = td.hilbert_scatter
    monkeypatch.setattr(td, "hilbert_scatter",
                        lambda *a: calls.append(a) or real(*a))
    want, got = _both(cut, pyr.pixels[0])
    _same(want, got)
    assert got[0].shape == (pyr.heights[0], pyr.widths[0], 3) and not calls


@pytest.mark.parametrize("pixels", [1, 300, 1200, 19200])
def test_decode_reduced_resolution(pixels):
    _, stream = _stream(96, 80, 3, "mixed")
    want, got = _both(stream, pixels)
    _same(want, got)


def test_decode_truncated_and_reduced_with_bias():
    """A truncated 4-level stream at reduced resolution: the midpoint bias
    runs with the full pyramid's levels on a reduced scatter."""
    from dwt_tpu_torch.codec import decoder as td

    _, stream = _stream(321, 239, 1, "mixed")
    cut = stream[:len(stream) // 3]
    *_, missing, _ = td._parse(cut, 0, torch.device("cpu"))
    assert (missing >= 2).any()
    for pixels in (0, 20000):
        want, got = _both(cut, pixels)
        _same(want, got)


def test_port_roundtrip():
    """Port encode, then port decode, on the CPU."""
    from dwt_tpu_torch.codec import decoder, encoder

    for w, h, c in [(64, 48, 3), (33, 17, 1)]:
        img = random_image(np.random.default_rng(3), w, h, c, "mixed")
        got, gray = decoder.decode(encoder.encode(img, device="cpu"),
                                   device="cpu")
        assert gray == (c == 1) and np.array_equal(got, img)


def test_decode_refusals(monkeypatch):
    from dwt_tpu_torch.codec import decoder

    _, stream = _stream(8, 8, 1, "mixed")
    with pytest.raises(ValueError, match="container version"):
        decoder.decode(b"WT" + stream[2:], device="cpu")  # read as .dwtt
    with pytest.raises(ValueError, match="bad header"):
        decoder.decode(b"P6" + stream[2:], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decoder.decode(stream)
    assert decoder.decode(stream, device="cpu")[0].shape == (8, 8, 1)


def test_parser_source_is_the_jax_packages():
    """The port's copy of the host parser cannot drift unnoticed."""
    a = (ROOT / "dwt_tpu_torch" / "native" / "entropy_decode.cpp").read_bytes()
    b = (ROOT / "dwt_tpu" / "native" / "entropy_decode.cpp").read_bytes()
    assert a == b


def test_native_loader(monkeypatch, tmp_path):
    """The parser builds under build/dwt_tpu_torch/native/<key>/ (not the
    JAX loader's directory), fills a given zeroed buffer, raises on a
    stream that dies in the root band, and without g++ fails loudly."""
    import shutil

    from dwt_tpu.runtime import native as jn
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.runtime import build, native

    assert native.library_path().parents[2] == build.BUILD_ROOT
    _, stream = _stream(96, 80, 3, "mixed")
    pyr = compute_pyramid(96, 80)
    args = (3, pyr.levels, pyr.levels, pyr.pixels)
    want = jn.entropy_decode(stream[6:], *args)
    buf = np.zeros((3, pyr.total), np.int32)
    got = native.entropy_decode(stream[6:], *args, out=buf)
    assert got[0] is buf
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="root band"):
        native.entropy_decode(stream[6:40], *args)
    with pytest.raises(ValueError, match="out must be"):
        native.entropy_decode(stream[6:], *args, out=buf[:, 1:])
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


@pytest.mark.parametrize("c", [1, 3])
def test_pnm_bytes_equal_jax(c, tmp_path):
    from dwt_tpu.io import pnm as jp
    from dwt_tpu_torch.io import pnm as tp

    img = random_image(np.random.default_rng(c), 13, 7, c, "mixed")
    data = tp.pnm_bytes(img)
    assert data == jp.pnm_bytes(img)
    tp.write_pnm(tmp_path / "a.pnm", img)
    assert (tmp_path / "a.pnm").read_bytes() == data
    back, gray = tp.read_pnm(tmp_path / "a.pnm")
    assert gray == (c == 1) and np.array_equal(back, img)
    commented = data.replace(b" ", b" # a comment\n", 1)
    for a, b in zip(tp.read_pnm(commented), jp.read_pnm(commented)):
        assert np.array_equal(a, b)
