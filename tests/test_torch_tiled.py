"""The port's batch encoder, tiled ``.dwtt`` container, budget allocation
and batch decode against the JAX package (tests/test_tiled.py mirrored,
without the reference binary): every container's bytes equal
``dwt_tpu.codec.tiled.encode_tiled``'s on the same input and every decoded
mosaic equals ``dwt_tpu.codec.tiled.decode_tiled``'s.  Exact: all of it is
integer.  On the CPU each kernel wrapper runs its plain PyTorch version.
Each JAX result is made once per module (its CPU compiles dominate)."""

import numpy as np
import pytest
import torch

from conftest import random_image

torch.set_num_threads(1)

TILE = (64, 64)
IMAGES = {  # name -> (w, h, c); the JAX package's tiled test sizes
    "rgb": (200, 120, 3),   # uneven edge tiles (8-wide, 56-high)
    "gray": (128, 128, 1),
    "square": (128, 128, 3),
    "sub8": (197, 70, 3),   # 197 = 3*64 + 5: the 5 merge into the last tile
    "mask": (160, 128, 3),
}


@pytest.fixture(scope="module")
def jax_tiled():
    """name -> (image, JAX lossless container, JAX decode of it)."""
    from dwt_tpu.codec import tiled as jt

    out = {}
    for i, (name, (w, h, c)) in enumerate(IMAGES.items()):
        img = random_image(np.random.default_rng(40 + i), w, h, c, "mixed")
        data = jt.encode_tiled(img, tile=TILE)
        out[name] = (img, data, np.asarray(jt.decode_tiled(data)[0]))
    return out


def _port():
    from dwt_tpu_torch.codec import tiled

    return tiled


def test_batch_encode_matches_single():
    """Each stream of a batch equals the single-frame encoder's and the
    spec model's, and the batch's layer ends equal the JAX package's
    vmapped batch encoder's."""
    from dwt_tpu import specmodel
    from dwt_tpu.codec import tiled as jt
    from dwt_tpu_torch.codec import encoder

    rng = np.random.default_rng(3)
    imgs = np.stack([random_image(rng, 64, 48, 3, k)
                     for k in ("mixed", "noise", "mixed", "flat")])
    enc = _port().get_batch_encoder(64, 48, 3, "cpu")
    streams = enc.encode_batch(imgs)
    single = encoder.Encoder(64, 48, 3, device="cpu")
    for i, s in enumerate(streams):
        assert s == single.encode(imgs[i])
        assert s == specmodel.encode(imgs[i], gray=False)
    payloads, ends = enc.encode_raw(imgs)
    jpayloads, jends = jt.get_batch_encoder(64, 48, 3).encode_raw(imgs)
    assert payloads == jpayloads and np.array_equal(ends, jends)


def test_batch_encoder_sub_batches(monkeypatch):
    """Sub-batches bounded by MAX_PIXELS_PER_DISPATCH give the same
    streams as one batch."""
    rng = np.random.default_rng(4)
    imgs = np.stack([random_image(rng, 32, 24, 1, "mixed") for _ in range(5)])
    enc = _port().BatchEncoder(32, 24, 1, "cpu")
    whole = enc.encode_batch(imgs)
    monkeypatch.setattr(enc, "MAX_PIXELS_PER_DISPATCH", 2 * 32 * 24)
    assert [lin.shape[0] for lin, _ in enc.stage1_batches(imgs)] == [2, 2, 1]
    assert enc.encode_batch(imgs) == whole


@pytest.mark.parametrize("name", ["rgb", "gray", "sub8"])
def test_tiled_container_lossless(jax_tiled, name):
    img, want, jout = jax_tiled[name]
    data = _port().encode_tiled(img, tile=TILE, device="cpu")
    assert data == want
    out, gray = _port().decode_tiled(data, device="cpu")
    assert gray == (img.shape[2] == 1)
    assert np.array_equal(out, jout) and np.array_equal(out, img)


def test_tiled_budget_truncation(jax_tiled):
    from dwt_tpu.codec import tiled as jt

    img, full, _ = jax_tiled["square"]
    budget = len(full) // 3
    cut = _port().encode_tiled(img, tile=TILE, budget=budget, device="cpu")
    assert cut == jt.encode_tiled(img, tile=TILE, budget=budget)
    assert len(cut) <= budget
    out, _ = _port().decode_tiled(cut, device="cpu")
    assert np.array_equal(out, np.asarray(jt.decode_tiled(cut)[0]))
    mse = np.mean((out.astype(np.float64) - img) ** 2)
    assert 10 * np.log10(255**2 / max(mse, 1e-9)) > 20
    table = np.frombuffer(cut[16:16 + 4 * 4], "<u4")
    assert (table > 0).all()  # no tile is zeroed out


@pytest.mark.parametrize("pixels_max", [256, 16])
def test_tiled_reduced_resolution(jax_tiled, pixels_max):
    """Reduced mosaics (tiles decoded at reduced size, replication
    upsampled) equal the JAX package's."""
    from dwt_tpu.codec import tiled as jt

    img, data, _ = jax_tiled["square"]
    out, _ = _port().decode_tiled(data, pixels_max=pixels_max, device="cpu")
    assert out.shape == img.shape
    assert np.array_equal(
        out, np.asarray(jt.decode_tiled(data, pixels_max=pixels_max)[0]))


def test_oversized_single_stream_routes_to_container(jax_tiled, monkeypatch):
    """``encode`` writes the container, with a one-time warning, when an
    image exceeds the single-stream envelope (shrunk here); container=False
    raises instead; ``decode`` reads the container back."""
    from dwt_tpu.codec import tiled as jt
    from dwt_tpu_torch.codec import decoder, encoder

    monkeypatch.setattr(encoder, "SINGLE_STREAM_MAX_COEFFS", 64 * 64 * 3 - 1)
    monkeypatch.setattr(encoder, "_warned_container", False)
    img = random_image(np.random.default_rng(6), 96, 64, 3, "mixed")
    with pytest.warns(UserWarning, match="single-stream envelope"):
        data = encoder.encode(img, device="cpu")
    assert data[:2] == b"WT" and data == jt.encode_tiled(img)
    back, gray = decoder.decode(data, device="cpu")
    assert not gray and np.array_equal(back, img)
    with pytest.raises(ValueError, match="single-stream envelope"):
        encoder.encode(img, container=False, device="cpu")
    small = random_image(np.random.default_rng(7), 32, 48, 3, "mixed")
    assert encoder.encode(small, device="cpu")[:2] == b"W6"


def test_container_route_with_capacity(jax_tiled):
    """container=True is encode_tiled with the capacity as its budget."""
    from dwt_tpu_torch.codec import encoder

    img, full, _ = jax_tiled["rgb"]
    assert encoder.encode(img, container=True, device="cpu") == \
        _port().encode_tiled(img, device="cpu")
    cap = len(full) // 2
    assert encoder.encode(img, capacity=cap, container=True, device="cpu") \
        == _port().encode_tiled(img, budget=cap, device="cpu")


def test_stream_bits_reroute(monkeypatch):
    """A stream past 2^31 bits reroutes to the container (the check is
    forced for the first two single-stream encodes here, in the stage 2
    that the single stream and the container's batch share), unless
    container=False."""
    from dwt_tpu_torch.codec import encoder

    img = random_image(np.random.default_rng(8), 40, 24, 3, "mixed")
    real = encoder.Encoder.emit_frames
    calls = []

    def huge(self, lin, stats, padded_T):
        calls.append(padded_T)
        if len(calls) <= 2:
            encoder._check_stream_bits(2**31)
        return real(self, lin, stats, padded_T)

    monkeypatch.setattr(encoder.Encoder, "emit_frames", huge)
    monkeypatch.setattr(encoder, "_warned_container", False)
    with pytest.raises(ValueError, match="2\\^31 bits"):
        encoder.encode(img, container=False, device="cpu")
    with pytest.warns(UserWarning, match="2\\^31 bits"):
        data = encoder.encode(img, device="cpu", gray=False)
    assert len(calls) == 3  # the third is the container's one tile
    monkeypatch.setattr(encoder.Encoder, "emit_frames", real)
    assert data == _port().encode_tiled(img, device="cpu")


def test_tiled_budget_masking_byte_identical(jax_tiled, monkeypatch):
    """The conservative layer mask applied before stage 2 leaves the bytes
    equal to the lossless-then-cut path (and to the JAX package's), while
    skipping schedule work for a deep budget."""
    from dwt_tpu.codec import tiled as jt
    from dwt_tpu_torch.codec import encoder

    img, full, _ = jax_tiled["mask"]
    budget = len(full) // 6
    calls = {"masked": 0}
    real = encoder._truncate_schedule_to_layer

    def spy(h, k, pyr, c):
        u = real(h, k, pyr, c)
        calls["masked"] += u is not None
        return u

    monkeypatch.setattr(encoder, "_truncate_schedule_to_layer", spy)
    got = _port().encode_tiled(img, tile=TILE, budget=budget, device="cpu")
    assert calls["masked"] > 0
    monkeypatch.setattr(encoder, "_truncate_schedule_to_layer",
                        lambda *a: None)
    want = _port().encode_tiled(img, tile=TILE, budget=budget, device="cpu")
    assert got == want == jt.encode_tiled(img, tile=TILE, budget=budget)
    assert len(got) <= budget


@pytest.mark.parametrize("seed", range(4))
def test_allocate_budget_equals_jax(seed):
    import jax.numpy as jnp

    from dwt_tpu.parallel.tiled import allocate_budget as jax_allocate
    from dwt_tpu_torch.parallel.tiled import allocate_budget

    rng = np.random.default_rng(seed)
    n, nl = int(rng.integers(1, 40)), int(rng.integers(1, 64))
    lb = rng.integers(0, 5000, (n, nl)) * (rng.random((n, nl)) < 0.8)
    total = int(lb.sum())
    for budget in (0, 1, total // 7, total // 2, total - 1, total, total + 9):
        want = np.asarray(jax_allocate(jnp.asarray(lb, jnp.int32), budget))
        got = allocate_budget(lb, budget)
        assert np.array_equal(got, want), budget
        assert got.sum() <= max(budget, 0)


def test_decode_batch_equals_jax():
    """Prefixes of four tile payloads, one cut inside its root band (None)
    and the others at different depths (several level groups), and a
    reduced decode."""
    from dwt_tpu.codec import decoder as jd
    from dwt_tpu_torch.codec import decoder, encoder

    rng = np.random.default_rng(9)
    imgs = [random_image(rng, 64, 48, 3, k)
            for k in ("mixed", "noise", "mixed", "mixed")]
    payloads = [encoder.encode(im, device="cpu")[6:] for im in imgs]
    cut = [payloads[0], payloads[1][:3], payloads[2][:300],
           payloads[3][:1500]]
    for pixels_max in (0, 200):
        got = decoder.decode_batch(cut, 64, 48, False, pixels_max,
                                   device="cpu")
        want = jd.decode_batch(cut, 64, 48, False, pixels_max)
        assert [g is None for g in got] == [w is None for w in want]
        assert got[1] is None
        for g, w in zip(got, want):
            if w is not None:
                assert g.shape == np.asarray(w).shape
                assert np.array_equal(g, np.asarray(w))
    assert np.array_equal(decoder.decode_batch(payloads, 64, 48, False,
                                               device="cpu")[1], imgs[1])
