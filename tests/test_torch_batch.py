"""The port's batch throughput mode: ``BatchEncoder`` runs a sub-batch of
same-geometry frames through one pipeline with a leading frame axis (each
encode kernel called once a sub-batch), against the JAX package's vmapped
``BatchEncoder`` and against the port's own single-frame pipeline (the
same stage functions at N = 1).  Exact: all of it is integer.  On the CPU
each kernel wrapper runs its plain PyTorch version; the batched plain
versions are held here to their per-frame calls.

Frames of one geometry differ in everything a sub-batch must absorb (T,
planes, the schedule order): each sub-batch holds a flat frame (no detail
plane at all) beside a noise frame.  Sub-batches are forced by a small
``MAX_PIXELS_PER_DISPATCH``, set in both packages."""

import numpy as np
import pytest
import torch

from conftest import random_image
from torch_parity import STATS_KEYS

torch.set_num_threads(1)

GEOMS = {  # name -> (w, h, c)
    "rgb": (64, 48, 3),
    "gray": (48, 32, 1),
    "odd": (33, 17, 3),   # odd edges at every level
    "tile9": (9, 9, 3),   # a 9x9 edge tile
}
KINDS = ("flat", "noise", "mixed", "noise", "flat")
# Frames a batch -> frames a sub-batch (None: the default bound).
SUB = {1: None, 3: 3, 5: 2}
KERNELS = ("hilbert_gather", "compact_tokens", "pack_words",
           "scatter_refbits", "vli_orders")


def _frames(name: str, n: int) -> np.ndarray:
    w, h, c = GEOMS[name]
    rng = np.random.default_rng(sum(map(ord, name)) + n)
    kinds = ("noise",) if n == 1 else KINDS[:n]
    return np.stack([random_image(rng, w, h, c, k) for k in kinds])


def _bound(monkeypatch, name: str, n: int) -> None:
    """Frames a sub-batch for a batch of ``n``, in both packages."""
    from dwt_tpu.codec import tiled as jt
    from dwt_tpu_torch.codec import tiled

    if SUB[n] is not None:
        w, h, _ = GEOMS[name]
        for mod in (jt, tiled):
            monkeypatch.setattr(mod.BatchEncoder, "MAX_PIXELS_PER_DISPATCH",
                                SUB[n] * w * h)


def _spy(monkeypatch) -> dict:
    """Every kernel wrapper's calls (name -> list of argument tuples, the
    tensors cloned: kernel B works in place) through the codec modules,
    and the transpose's, which the encode no longer calls."""
    from dwt_tpu_torch.codec import emit, stage1, tokens

    calls = {k: [] for k in KERNELS + ("transpose2d",)}
    for mod, name in ((stage1, "hilbert_gather"), (tokens, "compact_tokens"),
                      (tokens, "transpose2d"), (tokens, "vli_orders"),
                      (emit, "pack_words"),
                      (emit, "scatter_refbits")):
        def spy(*args, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name].append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args))
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.fixture
def spied(monkeypatch):
    return _spy(monkeypatch)


@pytest.mark.parametrize("n", sorted(SUB))
@pytest.mark.parametrize("name", list(GEOMS))
def test_batch_streams_equal_jax_and_single(monkeypatch, spied, name, n):
    """``encode_raw``'s payloads and layer ends equal the JAX package's
    vmapped batch encoder's exactly, and each payload equals the port's
    single-stream encoder's; each kernel wrapper is called once a
    sub-batch, not once a frame, and the transpose never."""
    from dwt_tpu.codec import tiled as jt
    from dwt_tpu_torch.codec import encoder, tiled

    w, h, c = GEOMS[name]
    imgs = _frames(name, n)
    _bound(monkeypatch, name, n)
    payloads, ends = tiled.BatchEncoder(w, h, c, "cpu").encode_raw(imgs)
    nsub = -(-n // (SUB[n] or n))
    assert {k: len(v) for k, v in spied.items()} == {
        k: 0 if k == "transpose2d" else nsub for k in spied}
    jp, je = jt.BatchEncoder(w, h, c).encode_raw(imgs)
    assert payloads == jp
    assert ends.dtype == np.int64 and np.array_equal(ends, np.asarray(je))
    single = encoder.Encoder(w, h, c, device="cpu")
    for img, p in zip(imgs, payloads):
        assert single.header() + p == single.encode(img)


def _pipeline(enc, imgs, padded_T=0):
    """The stage functions on ``imgs`` as one batch: (lin, stats, padded_T,
    tv, tr, tf, orders, words)."""
    from dwt_tpu_torch.codec import emit, encoder, tokens

    lin, stats = enc.stage1_frames(imgs)
    padded_T = padded_T or encoder._bucket(int(stats["T"].max()))
    pyr, c = enc.pyr, enc.channels
    tv, tr, tf, orders, vmag, com = tokens._stage2_tokens(lin, stats, pyr, c,
                                                          padded_T)
    words = emit._stage2_emit(lin, stats, tv, tr, tf, orders, vmag, com,
                              pyr, c, padded_T)[0]
    return lin, stats, padded_T, tv, tr, tf, orders, words


@pytest.fixture(scope="module")
def batched():
    """name -> (batched run, [single-frame run of each frame at the
    batch's bucket], calls of each kernel wrapper in the batched run, and
    in each single run), five frames a geometry in one sub-batch."""
    from dwt_tpu_torch.codec import encoder

    out = {}
    for name, (w, h, c) in GEOMS.items():
        enc = encoder.Encoder(w, h, c, device="cpu")
        imgs = _frames(name, 5)
        with pytest.MonkeyPatch.context() as mp:
            calls = _spy(mp)
            run = _pipeline(enc, imgs)
            singles, single_calls = [], []
            for img in imgs:
                before = {k: len(v) for k, v in calls.items()}
                singles.append(_pipeline(enc, img[None], run[2]))
                single_calls.append({k: v[before[k]:]
                                     for k, v in calls.items()})
            batch_calls = {k: v[:1] for k, v in calls.items()}
        out[name] = run, singles, batch_calls, single_calls
    return out


@pytest.mark.parametrize("name", list(GEOMS))
def test_batch_intermediates_equal_single(batched, name):
    """Per frame, the batched ``lin``, every ``stats`` key, the token
    arrays, the VLI orders and the stream words equal the single-frame
    pipeline's at the same token bucket."""
    run, singles, _, _ = batched[name]
    lin, stats, padded_T, *rest = run
    assert len({int(t) for t in stats["T"]}) > 1  # the frames differ
    assert int(stats["planes_max"].min()) == 0  # a flat frame
    for i, one in enumerate(singles):
        lin1, stats1, pt1, *rest1 = one
        assert pt1 == padded_T
        assert torch.equal(lin[i], lin1[0])
        for k in STATS_KEYS:
            a, b = stats[k][i], stats1[k][0]
            assert a.dtype == b.dtype and torch.equal(a, b), (i, k)
        for what, a, b in zip(("tv", "tr", "tf", "orders", "words"), rest,
                              rest1):
            assert torch.equal(a[i], b[0]), (i, what)


def _split_plain(name, kernel, args, singles_args):
    """The batched call's plain version, cut into frames, and each
    frame's own plain call."""
    from dwt_tpu_torch.ops import compact, hilbert_gather, pack, vli_scan

    n = len(singles_args)
    if kernel == "hilbert_gather":
        got = hilbert_gather.hilbert_gather_plain(*args)
        return list(got), [hilbert_gather.hilbert_gather_plain(*a)[0]
                           for a in singles_args]
    if kernel == "compact_tokens":
        vmag, meta, npairs = args[:3]
        got = compact.compact_tokens_plain(vmag, meta, npairs)
        return list(got.reshape(n, -1)), [
            compact.compact_tokens_plain(*a[:3]) for a in singles_args]
    if kernel == "pack_words":
        widx, c0, c1, c2, nwords = args
        got = pack.pack_words_plain(widx, c0, c1, c2, nwords)
        return list(got.reshape(n, -1)), [pack.pack_words_plain(*a)
                                          for a in singles_args]
    if kernel == "scatter_refbits":
        vmag, meta, words = args[:3]
        got = compact.scatter_refbits_plain(vmag, meta, words.clone())
        return list(got.reshape(n, -1)), [
            compact.scatter_refbits_plain(a[0], a[1], a[2].clone())
            for a in singles_args]
    # the VLI order scan: frame f's tokens are row f
    got = vli_scan.vli_orders_plain(*args)
    return list(got), [vli_scan.vli_orders_plain(*a)[0]
                       for a in singles_args]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name", list(GEOMS))
def test_batch_plain_equals_per_frame(batched, name, kernel):
    """Each kernel wrapper's plain version on the sub-batch's inputs (the
    frames' arrays end to end, the metadata's rows offset frame by frame)
    equals its per-frame plain calls, frame by frame."""
    _, _, batch_calls, single_calls = batched[name]
    for j, args in enumerate(batch_calls[kernel]):
        got, want = _split_plain(name, kernel, args,
                                 [s[kernel][j] for s in single_calls])
        assert len(got) == len(want) == 5
        for i, (g, w_) in enumerate(zip(got, want)):
            assert g.dtype == w_.dtype and torch.equal(g, w_), (i, j)


@pytest.mark.parametrize("name", list(GEOMS))
def test_batch_vli_orders_read_in_place(batched, name):
    """The sub-batch's VLI order scan gets the token finisher's arrays as
    they lie, contiguous rows at stride padded_T (no spare slot), and no
    transpose runs; its orders are the plain version's on those arrays."""
    from dwt_tpu_torch.ops import vli_scan

    run, _, batch_calls, single_calls = batched[name]
    padded_T, tv, tf, orders = run[2], run[3], run[5], run[6]
    assert tv.stride(0) == tf.stride(0) == padded_T
    (val, vli), = batch_calls["vli_orders"]
    assert torch.equal(val, tv) and torch.equal(vli, tf)
    assert val.dtype == torch.int32 and vli.dtype == torch.bool
    assert batch_calls["transpose2d"] == []
    assert all(s["transpose2d"] == [] for s in single_calls)
    assert torch.equal(orders, vli_scan.vli_orders_plain(tv, tf))


def test_sub_batch_int32_bound_raises():
    """A sub-batch whose buffers would pass the kernels' int32 indices
    raises before anything is allocated, where one frame passes."""
    from dwt_tpu_torch.codec import encoder, tiled

    enc = tiled.BatchEncoder(9, 9, 3, "cpu")
    pyr, nlin = enc.pyr, 8192 * 2
    padded_T = 1 << 29
    encoder._check_batch(1, nlin, pyr, 3, padded_T)
    with pytest.raises(ValueError, match="stream words"):
        encoder._check_batch(3, nlin, pyr, 3, padded_T)
    batch = enc.stage1_batches(_frames("tile9", 3))[0]
    with pytest.raises(ValueError, match="int32"):
        enc.emit_batch(batch, padded_T)
