"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same CUDA tensors (exact), at ragged shapes the 4K main
paths of chip_smoke.py do not reach, and the encoder and decoder on the
card against the same code on the CPU.  Skipped where there is no CUDA card.

On a machine with a card (no JAX needed):

    python3 -m pytest --noconftest -m card tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from imagegen import random_image

pytestmark = pytest.mark.card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _elements(rng, n):
    mag = np.where(rng.random(n) < 0.35, 0,
                   (1 << rng.integers(0, 13, n)) + rng.integers(0, 64, n))
    v = (mag | (rng.integers(0, 2, n) << 30)).astype(np.int64)
    v[rng.random(n) < 0.02] = -1
    return v.astype(np.int32)


def _meta(rng, nunits, E, sub, col4_max):
    """Units at consecutive E-element chunks with ragged valid lengths,
    random planes and carries, a few skipped; counts generous (the kernels
    cap at the true count themselves)."""
    rows, base = [], 0
    for u in range(nunits):
        elen = E - int(rng.integers(0, 1000)) if u % 2 else E
        cnt = 0 if u % 7 == 6 else E
        rows.append([u * E // sub, elen, int(rng.integers(0, 10)), base,
                     int(rng.integers(0, col4_max)),
                     int(rng.integers(0, 5000)), cnt, 0])
        base += E // 4 + 256  # disjoint output ranges
    return torch.as_tensor(np.asarray(rows, np.int32))


def test_compact_kernels_equal_plain(cuda):
    from dwt_tpu_torch.ops import compact

    rng = np.random.default_rng(31)
    E, nunits = compact.E, 12
    vmag = torch.as_tensor(_elements(rng, (nunits + 1) * E)).reshape(
        -1, compact.SUBA).to(cuda)
    meta = _meta(rng, nunits, E, compact.SUBA, 100).to(cuda)
    npairs = int(meta[-1, 3]) + E + 512
    got = compact.compact_tokens(vmag, meta, npairs)
    want = compact.compact_tokens_plain(vmag, meta, npairs)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int((want != 0).sum()) > 10000

    meta_b = meta.clone()
    meta_b[:, 3] = meta[:, 3] // 4  # word windows of the bit ranges
    nwords = int(meta_b[-1, 3]) + E // 32 + 512
    words = torch.as_tensor(rng.integers(-2**31, 2**31, nwords, dtype=np.int64)
                            .astype(np.int32)).to(cuda)
    got = compact.scatter_refbits(vmag, meta_b, words.clone())
    want = compact.scatter_refbits_plain(vmag, meta_b, words.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not torch.equal(got, words)


def _shared_meta(rng, vmag, E, sub, nchunk, planes=10):
    """Units of planes 0..planes-1 sharing each of nchunk chunks, rows
    shuffled as the schedule order gives them: ragged valid lengths (col 1
    < E) on odd chunks, non-zero zero carries, counts below the true count
    on a third of the units, chunk 2 with no live unit.  Returns (meta,
    pair-buffer size)."""
    flat = vmag.reshape(-1).cpu().numpy()
    units = []
    for k in range(nchunk):
        elen = E - int(rng.integers(1, 3000)) if k % 2 else E
        el = flat[k * E:k * E + elen]
        for p in range(planes):
            cnt = int(((el >= 0) & (((el & ((1 << 30) - 1)) >> p) == 1)).sum())
            if k == 2:
                cnt = 0
            elif cnt and rng.random() < 0.3:
                cnt = int(rng.integers(0, cnt))
            units.append([k * E // sub, elen, p, 0, 0,
                          int(rng.integers(0, 1 << 20)), cnt, 0])
    rows, base = [units[i] for i in rng.permutation(len(units))], 0
    for r in rows:
        base += int(rng.integers(0, 300))
        r[3], r[4] = base & ~127, base & 127
        base += r[6]
    return torch.as_tensor(np.asarray(rows, np.int32)), base + 512


@pytest.mark.parametrize("case", ["shared", "pairs cut short", "table given"])
def test_compact_tokens_shared_chunks_equal_plain(cuda, case):
    """Kernel A where units share chunks (the encoder's grouping): planes
    0-9 of a chunk in shuffled rows, counts below the true count, zero
    carries, col 1 < E, a chunk with no live unit; slots past npairs; and
    a unit table given in another group order, which changes nothing."""
    from dwt_tpu_torch.ops import compact

    rng = np.random.default_rng(41)
    E, nchunk = compact.E, 6
    vmag = torch.as_tensor(_elements(rng, (nchunk + 1) * E)).reshape(
        -1, compact.SUBA).to(cuda)
    meta, npairs = _shared_meta(rng, vmag, E, compact.SUBA, nchunk)
    meta = meta.to(cuda)
    table = None
    if case == "pairs cut short":
        npairs //= 2
    if case == "table given":
        table = compact.unit_table(meta).flip(0).contiguous()
        assert table.shape[0] == nchunk - 1
    before = compact.compact_tokens.launches
    got = compact.compact_tokens(vmag, meta, npairs, table)
    want = compact.compact_tokens_plain(vmag, meta, npairs)
    torch.cuda.synchronize()
    assert compact.compact_tokens.launches == before + 1
    assert torch.equal(got, want) and int((want != 0).sum()) > 20000


def _shared_meta_b(rng, vmag, E, sub, nchunk, cut, planes=10):
    """Kernel B's units of planes 0..planes-1 sharing each of nchunk
    chunks, rows shuffled: ragged valid lengths on odd chunks, chunk 2
    with no live unit, counts equal to the true refined count or, with
    ``cut``, below it on a third of the units; each unit's bits after the
    last one's at a random gap and word offset.  Returns (meta, the bit
    after the last unit's)."""
    flat = vmag.reshape(-1).cpu().numpy()
    units = []
    for k in range(nchunk):
        elen = E - int(rng.integers(1, 3000)) if k % 2 else E
        el = flat[k * E:k * E + elen]
        for p in range(planes):
            cnt = int(((el >= 0) & (((el & ((1 << 30) - 1)) >> p) > 1)).sum())
            if k == 2:
                cnt = 0
            elif cut and cnt and rng.random() < 0.3:
                cnt = int(rng.integers(0, cnt))
            units.append([k * E // sub, elen, p, 0, 0, 0, cnt, 0])
    rows, bit = [units[i] for i in rng.permutation(len(units))], 37
    for r in rows:
        r[3] = (bit >> 5) & ~127
        r[4] = bit - 32 * r[3]
        bit += r[6] + int(rng.integers(0, 300))
    return torch.as_tensor(np.asarray(rows, np.int32)), bit


@pytest.mark.parametrize("case", ["shared", "counts cut short",
                                  "table given", "histograms given",
                                  "words near the end"])
def test_scatter_refbits_shared_chunks_equal_plain(cuda, case):
    """Kernel B where units share chunks (the encoder's grouping): planes
    0-9 of a chunk in shuffled rows, counts below the true count, col 1 <
    E, a chunk with no live unit, random prior words; a unit table given
    in another group order and histograms from a count launch over it,
    which change nothing; and a buffer that ends inside the last units'
    bits, whose words past it are dropped."""
    from dwt_tpu_torch.ops import compact

    rng = np.random.default_rng(43)
    E, nchunk = compact.E, 6
    vmag = torch.as_tensor(_elements(rng, (nchunk + 1) * E)).reshape(
        -1, compact.SUBB).to(cuda)
    meta, end = _shared_meta_b(rng, vmag, E, compact.SUBB, nchunk,
                               cut=case == "counts cut short")
    meta = meta.to(cuda)
    nwords = end // 32 + 512
    if case == "words near the end":
        nwords = end // 32 - 1000
    words = torch.as_tensor(rng.integers(-2**31, 2**31, nwords)
                            .astype(np.int32)).to(cuda)
    extra = ()
    if case in ("table given", "histograms given"):
        extra = (compact.unit_table(meta).flip(0).contiguous(),)
        assert extra[0].shape[0] == nchunk - 1
    if case == "histograms given":
        hist = compact.hist_for(extra[0])
        compact.count(vmag, meta, extra[0], hist)
        extra += (hist,)
    before = compact.scatter_refbits.launches
    got = compact.scatter_refbits(vmag, meta, words.clone(), *extra)
    want = compact.scatter_refbits_plain(vmag, meta, words.clone())
    torch.cuda.synchronize()
    assert compact.scatter_refbits.launches == before + 1
    assert torch.equal(got, want) and int((want != words).sum()) > 20000


def test_scatter_refbits_on_a_tile_geometry(cuda, monkeypatch):
    """Kernel B as the encoder calls it (kernel A's table and histograms)
    on a 256x112 tile, the bottom-right tile of a 4K frame in 512x512
    tiles: equal to its plain version, and with its own count launch and
    unit table."""
    from dwt_tpu_torch.codec import emit, encoder
    from dwt_tpu_torch.ops import compact

    img = random_image(np.random.default_rng(9), 256, 112, 3, "mixed")
    want_stream = encoder.Encoder(256, 112, 3, device="cpu").encode(img)
    calls = []
    real = emit.scatter_refbits
    monkeypatch.setattr(emit, "scatter_refbits", lambda v, m, w, *r: (
        calls.append((v, m, w.clone(), *r)), real(v, m, w, *r))[1])
    assert encoder.Encoder(256, 112, 3).encode(img) == want_stream
    (vmag, meta, words, table, hist), = calls
    assert vmag.is_cuda
    want = compact.scatter_refbits_plain(vmag, meta, words.clone())
    for extra in ((table, hist), (table,), ()):
        out = compact.scatter_refbits(vmag, meta, words.clone(), *extra)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert not torch.equal(want, words)


@pytest.mark.parametrize("n,kind", [
    (1, "steps"), (31, "steps"), (12345, "steps"), (1 << 20, "steps"),
    (2047, "steps"), (2048, "steps"), (2049, "steps"), (1, "one word"),
    (50000, "jumps past the window"), (50000, "one word"),
    (50000, "nwords below the last word"), (50000, "27x nwords"),
    (50000, "negative words first")])
def test_pack_kernel_equals_plain(cuda, n, kind):
    """At ragged sizes (a tile is 2048 tokens), across widx jumps larger
    than the shared window, with every token on one word, with nwords
    below widx[-1] + 3 and 27 times it (the encoder's ratio), and with
    negative word indices, whose pieces are dropped."""
    from dwt_tpu_torch.ops import pack

    rng = np.random.default_rng(n)
    steps = rng.integers(0, 4, n)
    steps[rng.random(n) < 0.001] += 5000  # injection-like jumps
    if kind == "jumps past the window":
        steps[rng.random(n) < 0.0005] += 100_000
    if kind == "one word":
        steps[:] = 0
    widx = np.cumsum(steps) - steps[0]
    if kind == "negative words first":
        widx -= 3000
    widx = torch.as_tensor(widx.astype(np.int32)).to(cuda)
    cs = [torch.as_tensor(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                          .astype(np.int32)).to(cuda) for _ in range(3)]
    nwords = int(widx[-1]) + 3
    if kind == "nwords below the last word":
        nwords -= 200
    if kind == "27x nwords":
        nwords *= 27
    got = pack.pack_words(widx, *cs, nwords)
    want = pack.pack_words_plain(widx, *cs, nwords)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_pack_kernel_sets_the_order_flag(cuda):
    """With ``order_flag`` the kernel's order check is left to the caller:
    no host read, the flag set, the launch counted."""
    from dwt_tpu_torch.ops import pack

    c = torch.ones(9000, dtype=torch.int32, device=cuda)
    widx = torch.arange(9000, dtype=torch.int32, device=cuda)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = pack.pack_words.launches
    pack.pack_words(widx, c, c, c, 9010, order_flag=flag)
    assert int(flag) == 0
    widx[2048] = 0  # a tile's first token
    pack.pack_words(widx, c, c, c, 9010, order_flag=flag)
    assert int(flag) == 1 and pack.pack_words.launches == before + 2
    with pytest.raises(ValueError, match="nondecreasing"):
        pack.check_order(flag)


def test_pack_kernel_rejects_unsorted_widx(cuda):
    from dwt_tpu_torch.ops import pack

    c = torch.ones(64, dtype=torch.int32, device=cuda)
    widx = torch.arange(64, dtype=torch.int32, device=cuda)
    widx[40] = 3  # one step back
    before = pack.pack_words.launches
    with pytest.raises(ValueError, match="nondecreasing"):
        pack.pack_words(widx, c, c, c, 80)
    assert pack.pack_words.launches == before


def test_engine_probe_launches_once_a_device(cuda, monkeypatch):
    """The probe sends its tile through the gather and the scatter kernel
    and counts the wrong values on the card, once a device, in one host
    call: three launches on its count."""
    from dwt_tpu_torch.ops import hilbert_gather as hg

    hg._PROBED.clear()
    calls = []
    real = hg.engine_probe
    monkeypatch.setattr(hg, "engine_probe",
                        lambda *a: calls.append(a) or real(*a))
    before = hg.engine_supported.launches
    assert hg.engine_supported(cuda) and hg.engine_supported(cuda)
    assert hg.engine_supported.launches == before + 3 and len(calls) == 1
    tile, idx, out, bad = hg.probe_buffers(cuda)
    want_out, want_bad = out.clone(), bad.clone()
    hg.engine_probe_plain(tile, idx, want_out, want_bad)
    assert torch.equal(out, want_out) and torch.equal(bad, want_bad)
    assert bad.tolist() == [0, 0]


def test_engine_probe_raises_on_a_wrong_value(cuda):
    """A corrupted probe index makes both kernels give a wrong value; the
    compare counts it and engine_supported raises (no fallback)."""
    from dwt_tpu_torch.ops import hilbert_gather as hg

    tile, idx, out, bad = hg.probe_buffers(cuda)
    hg._PROBED.clear()
    idx[5] = 7
    try:
        with pytest.raises(RuntimeError, match="gather kernel"):
            hg.engine_supported(cuda)
        assert bad.tolist() == [1, 1]
    finally:
        idx[5] = 5
    assert hg.engine_supported(cuda)


@pytest.mark.parametrize("w,h,c", [(321, 239, 3), (64, 48, 1), (8, 8, 3)])
def test_gather_kernel_equals_plain(cuda, w, h, c):
    from dwt_tpu_torch.codec.stage1 import gather_source
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import hilbert_gather as hg

    rng = np.random.default_rng(w)
    co = torch.as_tensor(rng.integers(-2**20, 2**20, (h, w, c))
                         .astype(np.int32)).to(cuda)
    src = torch.as_tensor(gather_source(compute_pyramid(w, h))).to(cuda)
    got = hg.hilbert_gather(co, src)
    want = hg.hilbert_gather_plain(co, src)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("w,h,c,kind", [(64, 64, 1, "mixed"),
                                        (96, 80, 3, "noise"),
                                        (321, 239, 1, "mixed"),
                                        (9, 8, 3, "noise"),
                                        (64, 64, 3, "flat"),
                                        (320, 240, 3, "mixed")])
def test_encoder_on_card_equals_cpu(cuda, w, h, c, kind):
    from dwt_tpu_torch.codec import encoder
    from dwt_tpu_torch.ops import (compact, hilbert_gather, pack, transpose,
                                   vli_scan)

    img = random_image(np.random.default_rng(7), w, h, c, kind)
    fns = (hilbert_gather.hilbert_gather, compact.compact_tokens,
           compact.scatter_refbits, pack.pack_words, transpose.transpose2d,
           vli_scan.vli_orders)
    before = [f.launches for f in fns]
    got = encoder.Encoder(w, h, c).encode(img)
    assert got == encoder.Encoder(w, h, c, device="cpu").encode(img)
    moved = [f.launches - b for f, b in zip(fns, before)]
    assert moved == [1, 1, 1, 1, 0, 1], moved


@pytest.mark.parametrize("w,h,c,sub", [(8, 8, 1, None), (9, 8, 3, None),
                                       (321, 239, 1, None),
                                       (320, 240, 3, None),
                                       (320, 240, 3, (160, 120)),
                                       (321, 239, 3, (41, 30))])
def test_scatter_kernel_equals_plain(cuda, w, h, c, sub):
    """On full pyramids and on a reduced sub-pyramid whose coefficient row
    is the full image's (the decoder's reduced decodes)."""
    from dwt_tpu_torch.codec.decoder import scatter_source
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    rng = np.random.default_rng(w + c)
    lin = torch.as_tensor(rng.integers(-2**20, 2**20, (c, w * h))
                          .astype(np.int32)).to(cuda)
    pyr = compute_pyramid(*(sub or (w, h)))
    src = torch.as_tensor(scatter_source(pyr)).to(cuda)
    before = hs.hilbert_scatter.launches
    got = hs.hilbert_scatter(lin, src)
    want = hs.hilbert_scatter_plain(lin, src)
    torch.cuda.synchronize()
    assert hs.hilbert_scatter.launches == before + 1
    assert got.shape == (pyr.height, pyr.width, c) and torch.equal(got, want)


@pytest.mark.parametrize("table", [True, False])
@pytest.mark.parametrize("w,h,c,sub", [(512, 512, 84, None),
                                       (256, 512, 12, None),
                                       (512, 112, 21, None),
                                       (256, 112, 3, None),
                                       (320, 240, 3, (160, 120)),
                                       (321, 239, 3, (41, 30))])
def test_scatter_kernel_with_run_table(cuda, w, h, c, sub, table):
    """At the 4K tiled decode's four (geometry, N * C channels) shapes
    (512x112 has squares of three runs) and on reduced sub-pyramids whose
    coefficient row is the full image's, with the run table given, as the
    decoder's tail gives it, and derived by the wrapper."""
    from dwt_tpu_torch.codec.decoder import scatter_source
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    rng = np.random.default_rng(w + h + c)
    lin = torch.as_tensor(rng.integers(-2**20, 2**20, (c, w * h))
                          .astype(np.int32)).to(cuda)
    pyr = compute_pyramid(*(sub or (w, h)))
    src = torch.as_tensor(scatter_source(pyr)).to(cuda)
    extra = hs.run_table(src) if table else ()
    before = hs.hilbert_scatter.launches
    got = hs.hilbert_scatter(lin, src, *extra)
    want = hs.hilbert_scatter_plain(lin, src)
    torch.cuda.synchronize()
    assert hs.hilbert_scatter.launches == before + 1
    assert got.shape == (pyr.height, pyr.width, c) and torch.equal(got, want)


def test_scatter_kernel_on_any_index(cuda):
    """A random index (repeats, -1, indices past L) makes squares of many
    runs, more than one round of the kernel's 32."""
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    rng = np.random.default_rng(5)
    src = torch.as_tensor(rng.integers(-1, 3040, (70, 45))
                          .astype(np.int32)).to(cuda)
    lin = torch.as_tensor(rng.integers(-2**20, 2**20, (3, 3000))
                          .astype(np.int32)).to(cuda)
    got = hs.hilbert_scatter(lin, src)
    torch.cuda.synchronize()
    assert torch.equal(got, hs.hilbert_scatter_plain(lin, src))


def _port_stream(w, h, c, kind):
    from dwt_tpu_torch.codec import encoder

    img = random_image(np.random.default_rng(7), w, h, c, kind)
    return img, encoder.Encoder(w, h, c, device="cpu").encode(img)


@pytest.mark.parametrize("w,h,c,kind", [(320, 240, 3, "mixed"),
                                        (321, 239, 1, "mixed"),
                                        (8, 8, 1, "mixed"),
                                        (9, 8, 3, "noise"),
                                        (64, 64, 3, "flat"),
                                        (96, 80, 3, "mixed")])
def test_decode_on_card_equals_cpu(cuda, w, h, c, kind):
    from dwt_tpu_torch.codec import decoder
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    img, stream = _port_stream(w, h, c, kind)
    before = hs.hilbert_scatter.launches
    got, gray = decoder.decode(stream)
    want, _ = decoder.decode(stream, device="cpu")
    assert gray == (c == 1) and np.array_equal(got, want)
    if kind != "flat":
        assert np.array_equal(got, img)
        assert hs.hilbert_scatter.launches == before + 1


@pytest.mark.parametrize("cap,pixels", [(64, 0), (150, 0), (400, 0),
                                        (1200, 0), (5000, 0), (0, 1),
                                        (0, 300), (0, 1200), (0, 19200),
                                        (1200, 1200), (400, 30)])
def test_decode_prefix_on_card_equals_cpu(cuda, cap, pixels):
    from dwt_tpu_torch.codec import decoder

    _, stream = _port_stream(96, 80, 3, "mixed")
    stream = stream[:cap] if cap else stream
    if cap == 64:  # inside the root band
        with pytest.raises(ValueError):
            decoder.decode(stream)
        return
    got, _ = decoder.decode(stream, pixels)
    want, _ = decoder.decode(stream, pixels, device="cpu")
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("shape,dtype", [
    ((245760, 128), torch.int32), ((128, 245760), torch.int8),
    ((40, 256), torch.int32), ((256, 40), torch.int32),
    ((300, 300), torch.int32), ((384, 512), torch.uint32),
    ((129, 257), torch.int8), ((1, 1), torch.int32), ((3, 70001), torch.int8),
    ((0, 5), torch.int32)])
def test_transpose_kernel_equals_plain(cuda, shape, dtype):
    """At the 4K VLI scan's shapes (int32 in, int8 out) and at ragged ones
    (the JAX package's transpose test cases among them)."""
    from dwt_tpu_torch.ops import transpose

    rng = np.random.default_rng(shape[0])
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    x = torch.as_tensor(x.astype(np.uint32 if dtype == torch.uint32 else
                                 np.int8 if dtype == torch.int8 else np.int32))
    x = x.to(cuda)
    before = transpose.transpose2d.launches
    got = transpose.transpose2d(x)
    want = transpose.transpose2d_plain(x)
    torch.cuda.synchronize()
    assert got.dtype == (torch.int8 if dtype == torch.int8 else torch.int32)
    assert got.shape == shape[::-1] and torch.equal(got, want)
    assert transpose.transpose2d.launches == before + (x.numel() > 0)


@pytest.mark.parametrize("shape,vec", [
    ((128, 7680), 16), ((128, 245760), 16), ((144, 400), 16),
    ((128, 7684), 1), ((132, 260), 1), ((129, 257), 1), ((3, 5), 1),
    ((257, 129), 1)])
def test_int8_transpose_routes(cuda, shape, vec):
    """The int8 transpose at the VLI scan's shapes (the byte kernel, 16
    bytes a thread) and at sides that are not multiples of 16 (the
    element kernel): one launch each."""
    from dwt_tpu_torch.ops import transpose

    rng = np.random.default_rng(shape[1])
    x = torch.as_tensor(rng.integers(-128, 128, shape).astype(np.int8))
    x = x.to(cuda)
    assert transpose.vector_bytes(x) == vec
    before = transpose.transpose2d.launches
    got = transpose.transpose2d(x)
    want = transpose.transpose2d_plain(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert transpose.transpose2d.launches == before + 1


def _vli_tokens(rng, n, T, kind, cuda, stride=0):
    """(n, T) int32 values and bool VLI flags on the card, each row at
    ``stride`` (T when 0): the encoder's (60 % VLI tokens), any int32
    values, values of 2^30 and more, no VLI token, or one in a hundred."""
    stride = stride or T
    if kind == "any":
        val = rng.integers(-2**31, 2**31, (n, stride))
    elif kind == "largest":
        val = rng.integers(2**30, 2**31, (n, stride))
    else:
        val = rng.integers(0, 2**20, (n, stride)) \
            >> rng.integers(0, 20, (n, stride))
    p = {"inactive": 0.0, "sparse": 0.01}.get(kind, 0.6)
    vli = rng.random((n, stride)) < p
    return (torch.as_tensor(val.astype(np.int32), device=cuda)[:, :T],
            torch.as_tensor(vli, device=cuda)[:, :T])


@pytest.mark.parametrize("n,T,kind,stride", [
    (1, 31_457_280, "encoder", 0),   # the 4K frame's tokens
    (7, 7_864_320, "encoder", 7_864_321),  # a 1080p sub-batch of the batch
                                           # mode, rows as the finisher
                                           # leaves them
    (7, 7_864_320, "encoder", 0),
    (3, 2 * 16384 + 100, "any", 0), (1, 5, "encoder", 0),
    (5, 16384 + 4, "largest", 0), (2, 100_003, "encoder", 100_011),
    (4, 3 * 16384, "inactive", 0), (3, 40 * 16384 + 8, "sparse", 0),
    (2, 16384 - 4, "encoder", 16384)])
def test_vli_kernels_equal_plain(cuda, n, T, kind, stride):
    """The VLI order scan's kernel against its plain version on the same
    CUDA tensors, exact, dtype and shape included: at the 4K and the
    batch shapes and at ragged ones (token counts that are no multiple of
    the tile or of 4, 1-7 frames, rows at a stride past their length);
    one launch a call."""
    from dwt_tpu_torch.ops import vli_scan

    val, vli = _vli_tokens(np.random.default_rng(T + n), n, T, kind, cuda,
                           stride)
    before = vli_scan.vli_orders.launches
    got = vli_scan.vli_orders(val, vli)
    assert vli_scan.vli_orders.launches == before + 1
    want = vli_scan.vli_orders_plain(val, vli)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape == (n, T) and torch.equal(got, want)
    assert kind not in ("encoder", "largest") or int(got.max()) > 3


def test_vli_kernel_past_int32_indices(cuda):
    """Two frames of 2^30 + 2^20 tokens (more than 2^31 in all, and more
    tiles than the scratch first holds): VLI tokens only in a window past
    index 2^31, so the orders are 0 before it, the plain version's of the
    window inside it, and its last order after it."""
    from dwt_tpu_torch.ops import vli_scan

    T, w0, wn = 2**30 + 2**20, 2**30, 500_000
    free = torch.cuda.mem_get_info()[0]
    if free < 9 * 2 * T + 2**30:
        pytest.skip(f"needs {9 * 2 * T + 2**30} bytes free, {free} are")
    val = torch.zeros((2, T), dtype=torch.int32, device=cuda)
    vli = torch.zeros((2, T), dtype=torch.bool, device=cuda)
    wv, wf = _vli_tokens(np.random.default_rng(2), 1, wn, "encoder", cuda)
    val[1, w0:w0 + wn], vli[1, w0:w0 + wn] = wv[0], wf[0]
    got = vli_scan.vli_orders(val, vli)
    want = vli_scan.vli_orders_plain(wv, wf)[0]
    last = int(vli_scan.vli_orders_plain(
        torch.cat([wv, wv[:, :1]], 1), torch.cat([wf, wf[:, :1] & False],
                                                 1))[0, -1])
    torch.cuda.synchronize()
    assert not got[0].any() and not got[1, :w0].any()
    assert torch.equal(got[1, w0:w0 + wn], want)
    assert bool((got[1, w0 + wn:] == last).all()) and last > 3


def test_vli_orders_launches_a_scan(cuda):
    """One ``_vli_orders`` call on the card: one launch of the scan's
    kernel and no transpose, whatever the frame count, and the profiler
    sees no other kernel in the call; orders equal the CPU's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dwt_tpu_torch.codec import tokens
    from dwt_tpu_torch.ops import transpose, vli_scan

    rng = np.random.default_rng(3)
    for n, padded_T in ((1, 4096), (3, 6144 + 64), (5, 2048)):
        val = (rng.integers(0, 2**20, (n, padded_T))
               >> rng.integers(0, 20, (n, padded_T))).astype(np.int32)
        vli = rng.random((n, padded_T)) < 0.6
        v, f = torch.as_tensor(val, device=cuda), torch.as_tensor(vli,
                                                                  device=cuda)
        tokens._vli_orders(v, f, padded_T)  # the scratch made, if not yet
        torch.cuda.synchronize()
        fns = (transpose.transpose2d, vli_scan.vli_orders)
        before = [fn.launches for fn in fns]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = tokens._vli_orders(v, f, padded_T)
            torch.cuda.synchronize()
        assert [fn.launches - b for fn, b in zip(fns, before)] == [0, 1]
        names = {e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA}
        assert names and all("vli_orders_kernel" in k for k in names), names
        want = tokens._vli_orders(torch.as_tensor(val),
                                  torch.as_tensor(vli), padded_T)
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("budget_div", [0, 3])
def test_tiled_on_card_equals_cpu(cuda, budget_div):
    """A small tiled container (uneven edge tiles), lossless and cut to a
    budget, encoded and decoded on the card and on the CPU."""
    from dwt_tpu_torch.codec import tiled

    img = random_image(np.random.default_rng(5), 200, 120, 3, "mixed")
    full = tiled.encode_tiled(img, tile=(64, 64), device="cpu")
    budget = len(full) // budget_div if budget_div else 0
    want = tiled.encode_tiled(img, tile=(64, 64), budget=budget, device="cpu")
    got = tiled.encode_tiled(img, tile=(64, 64), budget=budget)
    assert got == want
    out, _ = tiled.decode_tiled(got)
    ref, _ = tiled.decode_tiled(got, device="cpu")
    assert np.array_equal(out, ref)
    if not budget:
        assert np.array_equal(out, img)


BATCH_KERNELS = ("hilbert_gather", "compact_tokens", "pack_words",
                 "scatter_refbits", "transpose2d", "vli_orders")
# Launches of each wrapper a sub-batch where not one: the VLI order scan
# reads the token arrays in place, and no transpose runs.
BATCH_LAUNCHES = {"transpose2d": 0}


def _batch_pairs():
    """Each batched kernel's wrapper and plain version, and the codec
    module that calls it."""
    from dwt_tpu_torch.codec import emit, stage1, tokens
    from dwt_tpu_torch.ops import (compact, hilbert_gather, pack, transpose,
                                   vli_scan)

    return {
        "hilbert_gather": (stage1, hilbert_gather.hilbert_gather,
                           hilbert_gather.hilbert_gather_plain),
        "compact_tokens": (tokens, compact.compact_tokens,
                           compact.compact_tokens_plain),
        "pack_words": (emit, pack.pack_words, pack.pack_words_plain),
        "scatter_refbits": (emit, compact.scatter_refbits,
                            compact.scatter_refbits_plain),
        "transpose2d": (tokens, transpose.transpose2d,
                        transpose.transpose2d_plain),
        "vli_orders": (tokens, vli_scan.vli_orders,
                       vli_scan.vli_orders_plain),
    }


@pytest.mark.parametrize("w,h,c", [(64, 48, 3), (33, 17, 1), (9, 9, 3)])
def test_batched_kernels_equal_plain(cuda, monkeypatch, w, h, c):
    """Kernels 1-4 and the VLI scan as a 3-frame sub-batch calls them (a
    flat, a noise and a mixed frame: three token counts, one with no
    detail plane), each launched once for the sub-batch (kernel 6 not at
    all) and each call held to its plain version on the same CUDA
    tensors; the payloads and layer ends equal the CPU's."""
    from dwt_tpu_torch.codec import tiled

    rng = np.random.default_rng(w + c)
    imgs = np.stack([random_image(rng, w, h, c, k)
                     for k in ("flat", "noise", "mixed")])
    want = tiled.BatchEncoder(w, h, c, device="cpu").encode_raw(imgs)
    pairs = _batch_pairs()
    calls = {k: [] for k in pairs}
    for name, (mod, fn, _) in pairs.items():
        def spy(*args, _fn=fn, _name=name, **kw):
            calls[_name].append(tuple(a.clone() if hasattr(a, "clone")
                                      else a for a in args))
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    before = {k: fn.launches for k, (_, fn, _) in pairs.items()}
    got = tiled.BatchEncoder(w, h, c).encode_raw(imgs)
    torch.cuda.synchronize()
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    assert {k: fn.launches - before[k] for k, (_, fn, _) in pairs.items()} \
        == {k: BATCH_LAUNCHES.get(k, 1) for k in pairs}
    for name, (_, fn, plain) in pairs.items():
        for args in calls[name]:
            fresh = [[a.clone() if hasattr(a, "clone") else a for a in args]
                     for _ in range(2)]
            k, p = fn(*fresh[0]), plain(*fresh[1])
            torch.cuda.synchronize()
            assert k.dtype == p.dtype and torch.equal(k, p), name
    assert calls["hilbert_gather"][0][0].shape[0] == 3


def test_sub_batch_int32_bound_raises_on_card(cuda):
    """A sub-batch whose stream buffers would pass the kernels' int32
    indices raises before any stage-2 kernel launches; nothing splits it
    or falls back to a loop over its frames."""
    from dwt_tpu_torch.codec import tiled

    pairs = _batch_pairs()
    enc = tiled.BatchEncoder(9, 9, 3)
    imgs = np.stack([random_image(np.random.default_rng(k), 9, 9, 3, "noise")
                     for k in range(3)])
    batch = enc.stage1_batches(imgs)[0]
    before = {k: fn.launches for k, (_, fn, _) in pairs.items()}
    with pytest.raises(ValueError, match="int32"):
        enc.emit_batch(batch, 1 << 29)
    assert {k: fn.launches for k, (_, fn, _) in pairs.items()} == before


def test_sharded_world1_nccl_equals_single(cuda):
    """The sharded routes at world size 1 on NCCL (rank 0 on the card, a
    free local port): the stream equals ``Encoder``'s, the collectives go
    through NCCL, the sharded decode gives the image back and a prefix the
    single-stream decode's pixels, and the tile-parallel container equals
    ``encode_tiled``'s."""
    import socket

    import torch.distributed as dist

    from dwt_tpu_torch.codec import decoder, encoder, tiled
    from dwt_tpu_torch.parallel import encode, hosts

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = hosts.global_mesh()
        assert (mesh.size, mesh.rank, mesh.device) == (
            1, 0, torch.device("cuda", 0))
        img = random_image(np.random.default_rng(5), 200, 120, 3, "mixed")
        hosts.comm_log.clear()
        stream = encode.ShardedEncoder(200, 120, 3, mesh).encode(img)
        assert stream == encoder.Encoder(200, 120, 3, device=cuda).encode(img)
        assert [op for op, _ in hosts.comm_log] == ["all_gather"] * 2
        dec = encode.ShardedDecoder(200, 120, 3, mesh)
        np.testing.assert_array_equal(dec.decode(stream), img)
        cut = stream[:len(stream) * 3 // 4]
        np.testing.assert_array_equal(dec.decode(cut),
                                      decoder.decode(cut)[0])
        assert encode.encode_tiled_sharded(img, mesh, tile=(64, 64)) == \
            tiled.encode_tiled(img, tile=(64, 64))
    finally:
        dist.destroy_process_group()


def _cli(argv, device):
    """(exit code, stdout bytes) of the port's CLI run in this process."""
    import contextlib
    import io

    from dwt_tpu_torch import cli

    out = io.TextIOWrapper(io.BytesIO())
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv, device=device)
    out.flush()
    return rc, out.buffer.getvalue()


def test_cli_on_card_equals_cpu(cuda, tmp_path):
    """``encode`` (lossless and with a capacity), ``tiled-encode`` with a
    budget and ``decode`` (of a stream, at a pixel cap, and of the
    container) write the same bytes on the card as on the CPU."""
    from dwt_tpu_torch.io import pnm

    src = str(tmp_path / "in.pnm")
    pnm.write_pnm(src, random_image(np.random.default_rng(8), 200, 120, 3,
                                    "mixed"))
    runs = [["encode", src, "OUT"], ["encode", src, "-", "3000"],
            ["tiled-encode", src, "OUT", "64", "9000"],
            ["decode", "CPU0", "OUT"], ["decode", "CPU0", "-", "600"],
            ["decode", "CPU2", "OUT"]]
    for dev in ("cpu", cuda):
        d = tmp_path / str(dev)
        d.mkdir()
        for k, argv in enumerate(runs):
            argv = [a.replace("OUT", str(d / f"out{k}"))
                    .replace("CPU", str(tmp_path / "cpu" / "out"))
                    for a in argv]
            rc, so = _cli(argv, dev)
            assert rc == 0
            (d / f"stdout{k}").write_bytes(so)
    names = sorted(p.name for p in (tmp_path / "cpu").iterdir())
    assert len(names) == 4 + len(runs)
    for n in names:
        assert (tmp_path / "cuda" / n).read_bytes() == \
            (tmp_path / "cpu" / n).read_bytes(), n


def test_selftest_on_card_all_ok(cuda):
    """``python -m dwt_tpu_torch.selftest`` on the card: every
    configuration ok, exit 0."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "dwt_tpu_torch.selftest"],
                       cwd=root, capture_output=True, text=True, timeout=900)
    results = json.loads(r.stdout.strip().splitlines()[-1])
    assert r.returncode == 0, r.stderr
    assert list(results) == ["gather", "compact", "refbits", "pack",
                             "scatter", "transpose", "probe", "encode",
                             "decode"]
    assert set(results.values()) == {"ok"}


STAGE1_SHAPES = [
    # (w, h, c, n): 4K RGB, a 7-frame 1080p sub-batch, a group of 512x448
    # tiles, a grey odd-sized frame, a frame wider than one 32-sample tile
    # row of the lifting kernel and only a tile and a bit high
    (3840, 2160, 3, 1), (1920, 1080, 3, 7), (448, 512, 3, 12),
    (321, 239, 1, 1), (1000, 37, 3, 2)]


@pytest.mark.parametrize("w,h,c,n", STAGE1_SHAPES)
def test_stage1_kernels_equal_plain(cuda, w, h, c, n):
    """The forward transform (``launch_levels``: a launch a large level and
    one for the tail; uint8 and int32 frames, and ``dwt2d_fwd`` without
    the colour step) and the plane statistics (one launch) equal their
    plain versions on the same CUDA tensors, every output and slot."""
    from dwt_tpu_torch.codec import stage1
    from dwt_tpu_torch.codec.encoder import Encoder
    from dwt_tpu_torch.ops import lifting, plane_stats

    rng = np.random.default_rng(w * h + n)
    frames = np.stack([random_image(rng, w, h, c, ("mixed", "noise")[i % 2])
                       for i in range(n)])
    enc = Encoder(w, h, c)
    pyr = enc.pyr
    x = torch.as_tensor(frames).to(cuda)
    before = lifting.forward_transform.launches
    coeff = lifting.forward_transform(x, pyr, c == 3)
    assert lifting.forward_transform.launches == before + len(
        lifting.launch_levels(pyr))
    want = lifting.forward_transform_plain(x, pyr, c == 3)
    torch.cuda.synchronize()
    assert coeff.dtype == want.dtype and torch.equal(coeff, want)
    assert torch.equal(lifting.forward_transform(x.to(torch.int32), pyr,
                                                 c == 3), want)
    y = want[0].clone()
    assert torch.equal(lifting.dwt2d_fwd(y, pyr),
                       lifting.dwt2d_fwd_plain(y, pyr))

    lin = stage1._linearize(coeff, enc._src, pyr, c)
    segs = stage1.segs_for(pyr, lin.device)
    args = (lin.reshape(n * c, -1), segs.valid_t, segs.idx_local,
            segs.block_chunk, segs.unit_chunk_t, segs.chunk_base_t)
    before = plane_stats.plane_stats.launches
    got = plane_stats.plane_stats(*args)
    assert plane_stats.plane_stats.launches == before + 1
    want = plane_stats.plane_stats_plain(*args)
    torch.cuda.synchronize()
    for name, g, w_ in zip(["planes", "nS_ck", "lastS_ck", "z0_ck", "zup_ck"],
                           got, want):
        assert g.dtype == w_.dtype and torch.equal(g, w_), name
    assert int(got[0].max()) > 0 and int((got[4] > 0).sum()) > 0


def test_transform_takes_any_frame_count(cuda):
    """More frames than a grid dimension's 65,535 in one transform (8x8
    grey: the tail kernel alone; 16x16 RGB with a level of its own first
    when the tail threshold is lowered), equal to the plain version."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    rng = np.random.default_rng(3)
    for w, c, tail in ((8, 1, lifting.TAIL_SAMPLES), (16, 3, 100)):
        pyr = compute_pyramid(w, w)
        x = torch.as_tensor(rng.integers(0, 256, (70_000, w, w, c),
                                         dtype=np.uint8)).to(cuda)
        saved, lifting.TAIL_SAMPLES = lifting.TAIL_SAMPLES, tail
        try:
            got = lifting.forward_transform(x, pyr, c == 3)
        finally:
            lifting.TAIL_SAMPLES = saved
        torch.cuda.synchronize()
        assert torch.equal(got, lifting.forward_transform_plain(x, pyr,
                                                                c == 3))


def test_stage1_frames_reuses_its_staging_buffer(cuda):
    """The upload keeps one pinned buffer a frame shape; two calls in a row
    give each its own frames on the card."""
    from dwt_tpu_torch.codec.encoder import Encoder

    rng = np.random.default_rng(3)
    enc = Encoder(64, 48, 3)
    a, b = (random_image(rng, 64, 48, 3, "noise")[None] for _ in range(2))
    xa, xb = enc._upload(a), enc._upload(b)
    assert len(enc._staging) == 1
    assert np.array_equal(xa.cpu().numpy(), a)
    assert np.array_equal(xb.cpu().numpy(), b)
    lin, stats = enc.stage1_frames(a)
    lin_cpu, stats_cpu = Encoder(64, 48, 3, device="cpu").stage1_frames(a)
    assert torch.equal(lin.cpu(), lin_cpu)
    assert torch.equal(stats["T"].cpu(), stats_cpu["T"])
