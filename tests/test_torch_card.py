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


def _codeword_inputs(rng, n, T, S, cuda, stride=0):
    """Kernel 11's inputs on the card: (n, T) token values, raw lengths,
    VLI flags and orders, each row at ``stride`` (T when 0), VLI values
    with s + k <= 30 (some at 30), raw tokens of 0-31 bits; (n, S)
    injection sites anywhere in [-3, T + 3] (0, T and the kernel's tile
    edges among them, several steps on one site) and bit counts."""
    from dwt_tpu_torch.ops import codeword

    W = stride or T
    vli = rng.random((n, W)) < 0.55
    s = rng.integers(0, 31, (n, W))
    top = (1 << 31) - (1 << s)  # v + 2^s < 2^31: s + k <= 30
    v = np.minimum(rng.integers(0, 1 << 31, (n, W))
                   >> rng.integers(0, 32, (n, W)), top - 1)
    v = np.where(rng.random((n, W)) < 0.03, top - 1, v)
    raw = rng.integers(0, 32, (n, W))
    rv = np.where(raw == 0, 0, rng.integers(0, 1 << 31, (n, W))
                  >> (31 - raw))
    val = np.where(vli, v, rv).astype(np.int32)
    raw = np.where(vli, 0, raw).astype(np.int32)
    site = rng.integers(-3, T + 4, (n, S))
    edges = [0, T, T - 1, codeword.TILE - 1, codeword.TILE,
             codeword.TILE + 1, 17, 17]
    site[:, :len(edges)] = edges[:S]
    toks = [torch.as_tensor(a, device=cuda)[:, :T]
            for a in (val, raw, vli, s.astype(np.int32))]
    return toks + [torch.as_tensor(site.astype(np.int32), device=cuda),
                   torch.as_tensor(rng.integers(0, 5000, (n, S)).astype(
                       np.int32), device=cuda)]


@pytest.mark.parametrize("n,T,S,stride", [
    (1, 31_457_280, 783, 0),              # the 4K frame's token bucket
    (7, 7_864_320, 783, 7_864_321),       # a 1080p sub-batch, rows as the
                                          # token finisher leaves them
    (3, 2 * 4096 + 100, 174, 0), (1, 5, 8, 0), (2, 100_003, 58, 100_011),
    (5, 2048, 1, 0), (4, 40 * 4096, 1392, 0), (2, 4096, 0, 0),
    (5, 12_288, 783, 12_289),             # 5 frames at stride T + 1: row
                                          # starts at every residue mod 4
    (1000, 8192, 348, 8193),              # the smallest bucket, many frames
    (3, 100_003, 59, 0), (2, 13, 3, 0)])  # the last tile ends at the end of
                                          # its tensors' storages
def test_codeword_kernel_equals_plain(cuda, n, T, S, stride):
    """Kernel 11 against its plain version on the same CUDA tensors, all
    six outputs exact, dtype and shape included: at the 4K and the batch
    shapes and at ragged ones (token counts that are no multiple of the
    tile, rows past their length, no step at all, rows and step tables
    that start anywhere, storages that end inside a 16-byte word); one
    launch a call, and the scratch left clear for the next (a second call
    gives the same)."""
    from dwt_tpu_torch.ops import codeword

    args = _codeword_inputs(np.random.default_rng(T + n), n, T, S, cuda,
                            stride)
    nwords = 2**31 // (n + 1)
    before = codeword.codeword_pieces.launches
    got = codeword.codeword_pieces(*args, nwords)
    again = codeword.codeword_pieces(*args, nwords)
    assert codeword.codeword_pieces.launches == before + 2
    want = codeword.codeword_pieces_plain(*args, nwords)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype == torch.int32 and g.shape == w.shape
        assert torch.equal(g, w) and torch.equal(a, w)
    assert got[5].shape == (n, -(-T // codeword.CHUNK))
    if not stride:  # the storages end where the last row does
        for t in args[:4]:
            st = t.untyped_storage()
            assert t.data_ptr() + t.numel() * t.element_size() \
                == st.data_ptr() + st.nbytes()


def test_codeword_plan_on_the_card(cuda):
    """The launch plan read from the card: its SMs, at least
    ``MIN_BLOCKS`` blocks an SM at the 4K frame's 783 steps (the stages,
    not the registers, set it), the kernel's shared memory equal to the
    wrapper's arithmetic, and a call of a 4K frame's tiles launches as many
    persistent blocks as the card holds."""
    from dwt_tpu_torch.ops import codeword

    x = torch.zeros(1, device=cuda)
    sms, per_sm, smem = codeword._plan_for(x, 783)
    props = torch.cuda.get_device_properties(cuda)
    assert sms == props.multi_processor_count
    assert per_sm >= codeword.MIN_BLOCKS
    assert smem == codeword.smem_bytes(783)
    tiles, grid = codeword.launch_plan(1, 31_457_280, sms, per_sm)
    assert tiles == 15_360 and grid == sms * per_sm


def test_codeword_contribs_is_one_kernel(cuda):
    """One ``emit._codeword_contribs`` of a 320x240 RGB frame on the card:
    one launch of kernel 11, and beside it only the small kernels of the
    (N, S) refinement counts and injection sites it reads (a fill, a where
    and a clamp; the step tables after it are kernel 17's); its outputs
    equal the CPU's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dwt_tpu_torch.codec import emit, encoder, tokens
    from dwt_tpu_torch.ops import codeword

    img = random_image(np.random.default_rng(2), 320, 240, 3, "mixed")
    outs = {}
    for dev in ("cpu", cuda):
        enc = encoder.Encoder(320, 240, 3, device=dev)
        lin, stats = enc.stage1_frames(img[None])
        padded_T = encoder._bucket(int(stats["T"][0]))
        tv, tr, tf, orders, _, _ = tokens._stage2_tokens(
            lin, stats, enc.pyr, 3, padded_T)
        nwords = emit._stream_words(enc.pyr, 3, padded_T)

        def call():
            return emit._codeword_contribs(stats, tv, tr, tf, orders,
                                           padded_T, nwords)

        if dev == "cpu":
            outs[dev] = call()
            continue
        call()
        torch.cuda.synchronize()
        before = codeword.codeword_pieces.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            outs[dev] = call()
            torch.cuda.synchronize()
        assert codeword.codeword_pieces.launches == before + 1
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        assert sum("codeword_kernel" in k for k in names) == 1, names
        assert len(names) <= 4, names
    for a, b in zip(outs["cpu"], outs[cuda]):
        assert torch.equal(a, b.cpu())


def test_stream_download_is_one_copy(cuda):
    """The payloads of a 3-frame sub-batch leave the card in one
    device-to-host copy (two in all of ``emit_frames``, with the bit
    totals'), through the encoder's one pinned buffer, which a smaller
    sub-batch reuses and a larger one grows; payloads equal the CPU's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dwt_tpu_torch.codec import encoder

    rng = np.random.default_rng(8)
    imgs = np.stack([random_image(rng, 64, 48, 3, k)
                     for k in ("mixed", "noise", "flat")])

    def run(enc, frames):
        lin, stats = enc.stage1_frames(frames)
        return enc.emit_frames(lin, stats, encoder._bucket(
            int(stats["T"].max())))[0], (lin, stats)

    want, _ = run(encoder.Encoder(64, 48, 3, device="cpu"), imgs)
    enc = encoder.Encoder(64, 48, 3, device=cuda)
    got, (lin, stats) = run(enc, imgs)
    assert got == want
    land = enc._landing
    assert land.is_pinned() and land.numel() * 4 >= sum(map(len, got))
    assert run(enc, imgs[2:])[0] == want[2:] and enc._landing is land
    padded_T = encoder._bucket(int(stats["T"].max()))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        enc.emit_frames(lin, stats, padded_T)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert sum(n.startswith("Memcpy DtoH") for n in names) == 2, names
    big = np.concatenate([imgs, imgs, imgs])
    assert run(enc, big)[0] == want * 3 and enc._landing.numel() > \
        land.numel()


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
    from dwt_tpu_torch.ops import (codeword, compact, emit_tables, finish,
                                   hilbert_gather, pack, transpose, vli_scan)

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
        "codeword_pieces": (emit, codeword.codeword_pieces,
                            codeword.codeword_pieces_plain),
        "finish_tokens": (tokens, finish.finish_tokens,
                          finish.finish_tokens_plain),
        "packed_elems": (tokens, finish.packed_elems,
                         finish.packed_elems_plain),
        "emit_tables": (emit, emit_tables.emit_tables,
                        emit_tables.emit_tables_plain),
    }


@pytest.mark.parametrize("w,h,c", [(64, 48, 3), (33, 17, 1), (9, 9, 3)])
def test_batched_kernels_equal_plain(cuda, monkeypatch, w, h, c):
    """Kernels 1-4, the VLI scan, kernel 11 (the codeword pieces),
    kernels 12 and 13 (the token finisher, the packed elements) and kernel
    17 (the emit half's step tables) as a 3-frame sub-batch calls them (a flat, a noise and a mixed frame: three
    token counts, one with no detail plane), each launched once for the
    sub-batch (kernel 6 not at all) and each call held to its plain
    version on the same CUDA tensors; the payloads and layer ends equal
    the CPU's."""
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
            for a, b in zip(*((x,) if torch.is_tensor(x) else x
                              for x in (k, p))):
                assert a.dtype == b.dtype and torch.equal(a, b), name
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


@pytest.mark.parametrize("n", (1, 2, 3))
@pytest.mark.parametrize("w,h,c", [(63, 64, 3), (200, 37, 1), (31, 270, 3),
                                   (513, 8, 3), (1001, 777, 3),
                                   (1001, 77, 3), (100, 600, 1),
                                   (513, 16, 3)])
def test_halo_kernels_equal_plain(cuda, w, h, c, n):
    """Kernels 18 and 19, every mode of both and the pair, at n ranks
    played on the card, equal their plain versions exactly: uint8 rows
    with the colour (RGB) to uint8 pixels, and signed int32 rows to int32;
    at world size 1 each launches as ``tiled.launch_plan`` plans (the two
    finest levels in one launch, one level in each other), and the inverse
    gives the image back.  513 x 8 has one halo level (no pair), 513 x 16
    the pair with the fewest rows it takes, 1001 x 77 the pair on three
    column tiles, 100 x 600 a width below a tile."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import halo
    from dwt_tpu_torch.parallel import tiled

    def played(img, fwd, inv, colour, to_bytes):
        fine, grid = tiled.play_forward(img, pyr, n, colour, fwd)
        return fine, grid, tiled.play_inverse(fine, pyr, n, to_bytes, inv)

    pyr = compute_pyramid(w, h)
    gen = torch.Generator(device=cuda).manual_seed(w * h + n)
    u8 = torch.randint(0, 256, (h, w, c), dtype=torch.uint8, device=cuda,
                       generator=gen)
    i32 = torch.randint(-255, 256, (h, w, c), dtype=torch.int32,
                        device=cuda, generator=gen)
    for img, colour, to_bytes in ((u8, c == 3, True), (i32, False, False)):
        before = (halo.halo_forward.launches, halo.halo_inverse.launches)
        got = played(img, halo.halo_forward, halo.halo_inverse, colour,
                     to_bytes)
        launched = (halo.halo_forward.launches - before[0],
                    halo.halo_inverse.launches - before[1])
        want = played(img, halo.halo_forward_plain, halo.halo_inverse_plain,
                      colour, to_bytes)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(got[2][:h], img.to(got[2].dtype))
        if n == 1:
            planned = len(tiled.launch_plan(pyr, 1, 0))
            assert launched == (planned, planned)
            assert planned == max(tiled._halo_plan(pyr, 1)[0] - 1, 1)


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


FINISH_SHAPES = [
    # (w, h, c, frames, cut): the smallest bucket (8,192 slots) at 1 and 7
    # frames, frame counts that are no multiple of 4, schedules cut by a
    # byte budget and by a tiled budget's layer cap, a 4K frame
    (8, 8, 1, 1, None), (9, 8, 3, 7, None), (64, 48, 3, 3, None),
    (96, 80, 3, 5, "capacity"), (128, 32, 1, 2, "layer"),
    (320, 240, 3, 6, "capacity"), (3840, 2160, 3, 1, None)]


def _finish_inputs(w, h, c, n, cut, cuda):
    """Stage 1 of n frames on the card, the schedule cut where asked
    ("capacity": a byte budget of T / 24 bytes; "layer": a tiled budget's
    cap at layer 2), and kernel A's pairs as ``_sig_tokens`` leaves them:
    (encoder, lin, stats, padded_T, pairs)."""
    from dwt_tpu_torch.codec import encoder, tokens
    from dwt_tpu_torch.codec.stage1 import frame

    rng = np.random.default_rng(w * h + n)
    imgs = np.stack([random_image(rng, w, h, c, ("mixed", "noise", "flat")[
        i % 3]) for i in range(n)])
    enc = encoder.Encoder(w, h, c, device=cuda)
    lin, stats = enc.stage1_frames(imgs)
    if cut:
        host = encoder.host_stats(stats)
        upds = {}
        for i in range(n):
            sh = frame(host, i)
            upd = (encoder._truncate_schedule(sh, int(sh["T"]) // 24,
                                              enc.pyr, c)
                   if cut == "capacity" else
                   encoder._truncate_schedule_to_layer(sh, 2, enc.pyr, c))
            if upd is not None:
                upds[i] = upd
        assert upds
        stats = encoder.patch_frames(stats, upds)
    padded_T = encoder._bucket(int(stats["T"].max()))
    pairs, _, _ = tokens._sig_tokens(lin, stats, enc.pyr, c, padded_T)
    return enc, lin, stats, padded_T, pairs


@pytest.mark.parametrize("w,h,c,n,cut", FINISH_SHAPES)
def test_finish_kernels_equal_plain(cuda, w, h, c, n, cut):
    """Kernels 12 and 13 against their plain versions on the same CUDA
    tensors, every output exact, dtype and shape included: the finisher on
    the pair buffer's rows in place and on a contiguous copy, one launch a
    call, its rows at stride padded_T; the packed elements of the frames."""
    from dwt_tpu_torch.codec import stage1
    from dwt_tpu_torch.ops import finish

    enc, lin, stats, padded_T, pairs = _finish_inputs(w, h, c, n, cut, cuda)
    assert pairs.stride(0) > pairs.shape[1] or n == 1
    keys = ("base_sched", "nS_sched", "cin_sched", "valid_sched",
            "root_cnt", "root_base", "planes_base", "planes", "refrun_ok",
            "step_base", "nS", "refrun_val", "T", "carry_end")
    root = lin[:, :, :enc.pyr.pixels[0]]
    tables = [stats[k] for k in keys]
    want = finish.finish_tokens_plain(pairs, root, *tables)
    before = finish.finish_tokens.launches
    for args in ((pairs, root), (pairs.contiguous(), root.contiguous())):
        got = finish.finish_tokens(*args, *tables)
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype and g.shape == (n, padded_T)
            assert g.stride() == (padded_T, 1) and torch.equal(g, w_)
    assert finish.finish_tokens.launches == before + 2
    valid = stage1.segs_for(enc.pyr, lin.device).valid_t
    before = finish.packed_elems.launches
    got = finish.packed_elems(lin, valid)
    assert finish.packed_elems.launches == before + 1
    want = finish.packed_elems_plain(lin, valid)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_stage2_tokens_launches_each_kernel_once(cuda):
    """One ``_stage2_tokens`` of a 3-frame sub-batch on the card: one call
    of each of kernels 12 and 13 (and of kernel A's wrapper and the VLI
    order scan), the token arrays contiguous at row stride padded_T on
    16-byte boundaries (the VLI order scan's 16-byte route), and every
    output equal to the CPU's."""
    from dwt_tpu_torch.codec import encoder, tokens
    from dwt_tpu_torch.ops import compact, finish, vli_scan

    rng = np.random.default_rng(12)
    imgs = np.stack([random_image(rng, 64, 48, 3, k)
                     for k in ("mixed", "noise", "flat")])
    outs = {}
    for dev in ("cpu", cuda):
        enc = encoder.Encoder(64, 48, 3, device=dev)
        lin, stats = enc.stage1_frames(imgs)
        padded_T = encoder._bucket(int(stats["T"].max()))
        fns = (finish.finish_tokens, finish.packed_elems,
               compact.compact_tokens, vli_scan.vli_orders)
        before = [fn.launches for fn in fns]
        outs[dev] = tokens._stage2_tokens(lin, stats, enc.pyr, 3, padded_T)
        torch.cuda.synchronize()
        if dev == "cpu":
            continue
        assert [fn.launches - b for fn, b in zip(fns, before)] == [1] * 4
        for t in outs[dev][:4]:
            assert t.shape == (3, padded_T) and t.stride() == (padded_T, 1)
            assert t.data_ptr() % 16 == 0
    for a, b in zip(outs["cpu"][:5], outs[cuda][:5]):
        assert torch.equal(a, b.cpu())


# Kernels 14 and 15 at the main paths' shapes (a 4K frame, a 7-frame
# 1080p sub-batch of the batch mode) and at small ones (16x16 tiles: two
# levels; grey).
SCHEDULE_SHAPES = [(3840, 2160, 3, 1), (1920, 1080, 3, 7), (16, 16, 3, 5),
                   (96, 80, 1, 3)]


def _frames(w, h, c, n):
    rng = np.random.default_rng(w + h + n)
    return np.stack([random_image(rng, w, h, c, ("mixed", "noise", "flat")[
        i % 3]) for i in range(n)])


@pytest.mark.parametrize("w,h,c,n", SCHEDULE_SHAPES)
def test_schedule_kernel_equals_plain(cuda, w, h, c, n):
    """Kernel 14 against its plain version on the same CUDA tensors, every
    output exact, dtype and shape included; one launch a call, its outputs
    in a new allocation each call."""
    from dwt_tpu_torch.codec import encoder, stage1
    from dwt_tpu_torch.ops import schedule as sc
    from dwt_tpu_torch.ops.lifting import forward_transform
    from dwt_tpu_torch.ops.plane_stats import plane_stats

    enc = encoder.Encoder(w, h, c, device=cuda)
    x = torch.as_tensor(_frames(w, h, c, n), device=cuda)
    lin = stage1._linearize(forward_transform(x, enc.pyr, c == 3), enc._src,
                            enc.pyr, c)
    segs = stage1.segs_for(enc.pyr, lin.device)
    planes, *tabs = plane_stats(lin.reshape(n * c, -1), segs.valid_t,
                                segs.idx_local, segs.block_chunk,
                                segs.unit_chunk_t, segs.chunk_base_t)
    args = (planes.reshape(n, c),
            *(t.reshape(n, c, *t.shape[1:]) for t in tabs),
            lin[:, :, :enc.pyr.pixels[0]], segs.real_t,
            segs.level_chunk_base_t, segs.level_nchunk_t)
    want = sc.schedule_plain(*args)
    heads = []
    for _ in range(2):
        before = sc.schedule.launches
        got = sc.schedule(*args)
        torch.cuda.synchronize()
        assert sc.schedule.launches == before + 1
        for k, g, w_ in zip(sc.OUT_KEYS, got, want):
            assert g.dtype == w_.dtype and g.shape == w_.shape, k
            assert torch.equal(g, w_), k
            assert g.data_ptr() % 256 == 0 or k in ("T", "planes", "nS_ck")
        heads.append(got[0])
    assert heads[0].data_ptr() != heads[1].data_ptr()
    assert torch.equal(heads[0], heads[1])


@pytest.mark.parametrize("w,h,c,n", SCHEDULE_SHAPES)
def test_unit_tables_kernel_equals_plain(cuda, w, h, c, n):
    """Kernel 15 against its plain version on the same CUDA tensors (stage
    1's on the card), every output exact, at the frames' token bucket and
    at four times it; one launch a call."""
    from dwt_tpu_torch.codec import encoder, stage1
    from dwt_tpu_torch.ops import units

    enc = encoder.Encoder(w, h, c, device=cuda)
    lin, stats = enc.stage1_frames(_frames(w, h, c, n))
    segs = stage1.segs_for(enc.pyr, lin.device)
    bucket = encoder._bucket(int(stats["T_host"].max()))
    for padded_T in (bucket, 4 * bucket):
        args = (stats["order"], stats["ubase_sched"], stats["valid_sched"],
                stats["step_base"], stats["nS_ck"], stats["scar_ck"],
                stats["zcar_ck"], segs.level_chunk_base_t,
                segs.ch_start_t, segs.ch_len_t, segs.n, padded_T)
        before = units.unit_tables.launches
        got = units.unit_tables(*args)
        torch.cuda.synchronize()
        assert units.unit_tables.launches == before + 1
        want = units.unit_tables_plain(*args)
        for k, g, w_ in zip(units.OUT_KEYS, got, want):
            assert g.dtype == w_.dtype and g.shape == w_.shape, k
            assert torch.equal(g, w_), k


# Kernel 16's shapes: (w, h, c, n); ragged sizes, a tail that reaches the
# finest level (small images), large levels of one and several strips and
# bands, and the paths' own sizes.
INVERSE_SHAPES = [(8, 8, 3, 1), (17, 9, 1, 3), (70, 50, 3, 7),
                  (321, 239, 3, 1), (321, 239, 1, 7), (1000, 37, 3, 3),
                  (513, 129, 1, 3), (480, 270, 3, 1), (512, 448, 3, 7),
                  (3840, 2160, 3, 1)]


@pytest.mark.parametrize("w,h,c,n", INVERSE_SHAPES)
def test_inverse_kernel_equals_plain(cuda, w, h, c, n):
    """Kernel 16 (``plan_of``: one launch for the tail, one a larger
    level) against its plain version on the same CUDA tensors: the uint8
    image with and without the colour, the int32 route with and without
    it, and ``dwt2d_inv``; coefficients beyond +-255 so that every clamp
    acts; then as the decoder hands it over (the (H, W, N, C) view, the
    root band in an (N, C, total) buffer, a bias table); the inputs left as
    they were."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    rng = np.random.default_rng(w * h + n)
    pyr = compute_pyramid(w, h)
    chain = lifting.pyramid_chain(pyr)
    x = torch.as_tensor(rng.integers(-700, 700, (n, h, w, c),
                                     dtype=np.int32)).to(cuda)
    x0 = x.clone()
    for colour, to_bytes in {(c == 3, True), (False, True), (False, False),
                             (c == 3, False)}:
        before = lifting.inverse_transform.launches
        got = lifting.inverse_transform(x, chain, colour, to_bytes)
        assert lifting.inverse_transform.launches == before + len(
            lifting.plan_of(x, chain, colour, to_bytes))
        want = lifting.inverse_transform_plain(x, chain, colour, to_bytes)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), (colour, to_bytes)
    assert torch.equal(lifting.dwt2d_inv(x[0], pyr),
                       lifting.dwt2d_inv_plain(x[0], pyr))
    assert torch.equal(x, x0)
    # As the decoder hands it over.
    h0, w0 = pyr.heights[0], pyr.widths[0]
    view = x.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3)
    lin = torch.as_tensor(rng.integers(-700, 700, (n, c, h0 * w0 + 5),
                                       dtype=np.int32)).to(cuda)
    root = lin[..., :h0 * w0].unflatten(2, (h0, w0)).permute(0, 2, 3, 1)
    missing = rng.integers(0, 9, (n, c, 16))
    bias = torch.as_tensor(np.where(missing >= 2, 1 << np.clip(
        missing - 2, 0, 30), 0).astype(np.int32)).to(cuda)
    lin0 = lin.clone()
    for colour, to_bytes in {(c == 3, True), (False, False)}:
        got = lifting.inverse_transform(view, chain, colour, to_bytes, bias,
                                        root)
        want = lifting.inverse_transform_plain(view, chain, colour, to_bytes,
                                               bias, root)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (colour, to_bytes)
    assert torch.equal(view, x0) and torch.equal(lin, lin0)
    # Channels apart (a channel stride other than 1): the tail reads them
    # in place, a larger level from a copy.
    planar = x.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
    assert torch.equal(
        lifting.inverse_transform(planar, chain, c == 3, True, bias),
        lifting.inverse_transform_plain(planar, chain, c == 3, True, bias))


@pytest.mark.parametrize("w,h,c", [(313, 263, 3), (8192, 16, 1),
                                   (16, 8192, 3), (3840, 2160, 3)])
def test_inverse_kernel_root_chain(cuda, w, h, c):
    """The decoder's root-only pass: the chain of the root size alone, in
    the tail or, for a root band of more than ``TAIL_SAMPLES`` samples a
    channel (8192x16), as a large level reading its LL quadrant from the
    coefficients; one launch, equal to the plain version."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    pyr = compute_pyramid(w, h)
    chain = ((pyr.heights[0], pyr.widths[0]),)
    rng = np.random.default_rng(w + h)
    x = torch.as_tensor(rng.integers(-700, 700, (3,) + chain[0] + (c,),
                                     dtype=np.int32)).to(cuda)
    before = lifting.inverse_transform.launches
    got = lifting.inverse_transform(x, chain, c == 3, True)
    assert lifting.inverse_transform.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, lifting.inverse_transform_plain(x, chain, c == 3,
                                                            True))


def test_dwt2d_inv_on_a_view(cuda):
    """``dwt2d_inv`` on the sharded decoder's coarse corner, a view that is
    not contiguous, equals the plain version and leaves the view as it
    was."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    rng = np.random.default_rng(5)
    big = torch.as_tensor(rng.integers(-700, 700, (270, 480, 3),
                                       dtype=np.int32)).to(cuda)
    big0 = big.clone()
    for hc, wc in ((9, 15), (135, 240)):
        view = big[:hc, :wc]
        assert not view.is_contiguous()
        pyr = compute_pyramid(wc, hc)
        got = lifting.dwt2d_inv(view, pyr)
        torch.cuda.synchronize()
        assert torch.equal(got, lifting.dwt2d_inv_plain(view.clone(), pyr))
    assert torch.equal(big, big0)


@pytest.mark.parametrize("w,h,c,pixels,cut", [(321, 239, 3, 0, 1),
                                              (96, 80, 1, 0, 1),
                                              (321, 239, 3, 30, 1),
                                              (96, 80, 1, 40, 1),
                                              (321, 239, 3, 0, 3),
                                              (96, 80, 1, 0, 4)])
def test_decode_tail_is_kernel_16(cuda, monkeypatch, w, h, c, pixels, cut):
    """A decode tail on the card launches the scatter once and kernel 16
    ``len(plan_of(...))`` times and runs no plain version, no eager
    midpoint bias (``bias_plain``) and no copy of the scatter's output
    (``_Tail.pyramid``), on the pyramid route, on the root-only route
    (``pixels`` below level 1's pixel count) and on a stream cut to a
    ``cut``-th of its bytes (planes missing: the bias inside kernel 16);
    its image equals the CPU decode's."""
    from dwt_tpu_torch.codec import decoder
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import color, hilbert_scatter, lifting

    img, stream = _port_stream(w, h, c, "mixed")
    stream = stream[:len(stream) // cut]
    want, _ = decoder.decode(stream, pixels, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version or an eager pass ran on the "
                             "card's path")

    for mod, name in ((lifting, "inverse_transform_plain"),
                      (lifting, "_unlift_plain"), (lifting, "cdf53_inv"),
                      (lifting, "ycocg_to_rgb"), (color, "ycocg_to_rgb"),
                      (lifting, "bias_plain"), (decoder, "bias_plain"),
                      (decoder._Tail, "pyramid")):
        monkeypatch.setattr(mod, name, refuse)
    before = lifting.inverse_transform.launches
    scat = hilbert_scatter.hilbert_scatter.launches
    calls = []
    kernel = lifting.inverse_transform

    def keep(*args):
        calls.append(args)
        return kernel(*args)

    monkeypatch.setattr(decoder, "inverse_transform", keep)
    got, _ = decoder.decode(stream, pixels)
    oh, ow = want.shape[:2]
    pyr = compute_pyramid(w, h)
    root = (oh, ow) == (pyr.heights[0], pyr.widths[0])
    assert len(calls) == 1
    assert lifting.inverse_transform.launches == before + len(
        lifting.plan_of(*calls[0][:4]))
    assert hilbert_scatter.hilbert_scatter.launches == scat + (not root)
    assert np.array_equal(got, want)
    assert root == (pixels > 0)  # the root-only route where asked
    if cut > 1:  # the bias table went to kernel 16
        assert calls[0][4] is not None
    if pixels == 0 and cut == 1:
        assert np.array_equal(got, img)


# Kernel 17's seeded tables: (N, C, L, T, nwords, order), as
# tests/test_torch_emit_tables.py's replay takes them; up to 2,030 steps a
# frame, groups of 32 to 256 threads, clamped word windows; orders that
# are random permutations or no permutation (the sort), and sites already
# in order (no sort); frame counts about 4 and 8 frames a block (16x16
# tiles' 174 steps), and 16x16 sub-batches past 1,024 frames.
EMIT_SEEDED = [(1, 1, 1, 4096, 9000, "random"), (3, 1, 2, 5000, 1000, "none"),
               (2, 3, 4, 8192, 2**20, "random"),
               (1, 3, 23, 9000, 50_000, "random"),
               (1, 1, 70, 2048, 3000, "sorted"), (4, 2, 1, 3, 5000, "random"),
               (700, 3, 2, 8192, 40_000, "random"),
               (3, 3, 2, 4096, 9000, "sorted"), (4, 3, 2, 4096, 9000, "none"),
               (5, 3, 2, 4096, 9000, "random"),
               (7, 3, 2, 4096, 9000, "sorted"), (8, 3, 2, 4096, 9000, "none"),
               (9, 3, 2, 4096, 9000, "sorted"),
               (1500, 3, 2, 8192, 40_000, "sorted"),
               (2, 3, 23, 9000, 50_000, "sorted"),
               (2, 1, 4, 4096, 9000, "sorted"),
               (3, 1, 4, 5000, 9000, "random")]


@pytest.mark.parametrize("N,C,L,T,nwords,order", EMIT_SEEDED)
def test_emit_tables_kernel_equals_plain_seeded(cuda, N, C, L, T, nwords,
                                                order):
    """Kernel 17 against its plain version on seeded tables on the card
    (tied and clamped sites, wrapping sums, any in-range unit columns),
    through its sort (random orders, orders that are no permutation) and
    without it (sites in order): every output exact; one launch a call,
    its outputs in a new allocation each call."""
    from test_torch_emit_tables import _seeded

    from dwt_tpu_torch.ops import emit_tables

    rng = np.random.default_rng(N * 1000 + C * 100 + L)
    # 116 steps of 464 units: blocks of more threads than keys
    lnc = (np.ones(L, int) if (C, L) == (3, 2) else np.full(L, 4)
           if (C, L) == (1, 4) else rng.integers(1, 5, L))
    args = [a.to(cuda) if torch.is_tensor(a) else a
            for a in _seeded(rng, N, C, L, lnc, T, nwords, order=order)]
    _kernel_twice_equals_plain(args)


def _kernel_twice_equals_plain(args):
    from dwt_tpu_torch.ops import emit_tables

    want = emit_tables.emit_tables_plain(*args)
    heads = []
    for _ in range(2):
        before = emit_tables.emit_tables.launches
        got = emit_tables.emit_tables(*args)
        torch.cuda.synchronize()
        assert emit_tables.emit_tables.launches == before + 1
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype and g.shape == w_.shape
            assert torch.equal(g, w_)
        heads.append(got[4])
    assert heads[0].data_ptr() != heads[1].data_ptr()


@pytest.mark.parametrize("N,C,L", [(1, 1, 1), (3, 3, 2), (4, 3, 2),
                                   (5, 3, 2), (9, 3, 2), (17, 3, 2),
                                   (1100, 3, 2), (3, 3, 7), (3, 1, 24),
                                   (2, 3, 9), (2, 1, 4)])
def test_emit_tables_kernel_equals_plain_scheduled(cuda, N, C, L):
    """Kernel 17 against its plain version on tables in schedule order
    (kernel 14's and 15's plain versions on seeded planes: no sort), at
    frame counts either side of 4 frames a block, a 16x16 sub-batch past
    1,024 frames, and many blocks a frame."""
    from test_torch_emit_tables import _scheduled

    rng = np.random.default_rng(N * 100 + C * 10 + L)
    lnc = (np.ones(L, int) if (C, L) == (3, 2) else np.full(L, 4)
           if (C, L) == (1, 4) else rng.integers(1, 7, L))
    args = [a.to(cuda) if torch.is_tensor(a) else a
            for a in _scheduled(rng, N, C, L, lnc)]
    site, order = args[3], args[4].long()
    assert (torch.diff(site.gather(1, order), dim=1) >= 0).all()
    _kernel_twice_equals_plain(args)


@pytest.mark.parametrize("w,h,c,n,cut", [(3840, 2160, 3, 1, None),
                                         (1920, 1080, 3, 7, None),
                                         (16, 16, 3, 5, None),
                                         (96, 80, 1, 3, "layer"),
                                         (64, 48, 3, 3, "capacity")])
def test_emit_tables_kernel_equals_plain(cuda, w, h, c, n, cut):
    """Kernel 17 on the encoder's own inputs on the card (stage 1, the
    tokens half and kernel 11 there), lossless and with schedules cut as
    a byte budget and a tiled layer cap cut them: every output equal to
    its plain version's on the same CUDA tensors, and its one kernel, and
    no other, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dwt_tpu_torch.codec import emit, encoder, tokens
    from dwt_tpu_torch.codec.stage1 import frame
    from dwt_tpu_torch.ops import emit_tables

    enc = encoder.Encoder(w, h, c, device=cuda)
    lin, stats = enc.stage1_frames(_frames(w, h, c, n))
    if cut:
        host, upds = encoder.host_stats(stats), {}
        for i in range(n):
            sh = frame(host, i)
            upd = (encoder._truncate_schedule(sh, int(sh["T"]) // 24,
                                              enc.pyr, c)
                   if cut == "capacity" else
                   encoder._truncate_schedule_to_layer(sh, 2, enc.pyr, c))
            if upd is not None:
                upds[i] = upd
        assert upds
        stats = encoder.patch_frames(stats, upds)
    padded_T = encoder._bucket(int(stats["T"].max()))
    tv, tr, tf, orders, _, com = tokens._stage2_tokens(lin, stats, enc.pyr,
                                                       c, padded_T)
    nwords = emit._stream_words(enc.pyr, c, padded_T)
    chunks, nref, inj, off, *_ = emit._codeword_contribs(
        stats, tv, tr, tf, orders, padded_T, nwords)
    kept = []
    real = emit.emit_tables
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(emit, "emit_tables",
                   lambda *a: (kept.append(a), real(*a))[1])
        got = emit._step_tables(stats, com, enc.pyr, off, chunks, nref, inj,
                                nwords)
    want = emit_tables.emit_tables_plain(*kept[0])
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        assert torch.equal(g, w_)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        emit_tables.emit_tables(*kept[0])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if names:  # the profiler drops every event in some sessions
        assert len(names) == 1 and "emit_tables_kernel" in names[0], names


# The kernels the emit half may launch after kernel 11, by the names the
# profiler gives them: the pack wrapper's zero fill and kernel, kernel
# 17's, kernel B's.
EMIT_GATE = ("pack_words_kernel", "FillFunctor", "emit_tables_kernel",
             "refbits_scatter_kernel")


@pytest.mark.parametrize("w,h,c,n", [(320, 240, 3, 1), (64, 48, 3, 3)])
def test_emit_gate(cuda, monkeypatch, w, h, c, n):
    """From kernel 11's end to the download, ``emit_frames`` launches only
    the pack, kernel 17 and kernel B kernels and makes one device-to-host
    copy (``_host_totals``'), with the plain versions of the step tables
    made to raise; its payloads equal the CPU's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dwt_tpu_torch.codec import emit, encoder
    from dwt_tpu_torch.ops import emit_tables

    imgs = _frames(w, h, c, n)

    def run(enc):
        lin, stats = enc.stage1_frames(imgs)
        return enc.emit_frames(lin, stats, encoder._bucket(
            int(stats["T"].max()))), (lin, stats)

    want, _ = run(encoder.Encoder(w, h, c, device="cpu"))
    enc = encoder.Encoder(w, h, c, device=cuda)
    got, (lin, stats) = run(enc)
    assert got[0] == want[0] and np.array_equal(got[2], want[2])

    def refuse(*args, **kwargs):
        raise AssertionError("an eager pass of the step tables ran")

    for mod, name in ((emit, "_bit_partials"), (emit, "_kernel_b_meta"),
                      (emit, "_layer_boundaries"),
                      (emit_tables, "emit_tables_plain"),
                      (emit_tables, "refstart_plain"),
                      (emit_tables, "bit_partials_plain"),
                      (emit_tables, "kernel_b_meta_plain"),
                      (emit_tables, "layer_ends_plain")):
        monkeypatch.setattr(mod, name, refuse)
    padded_T = encoder._bucket(int(stats["T"].max()))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = enc.emit_frames(lin, stats, padded_T)
        torch.cuda.synchronize()
    assert again[0] == want[0]
    ev = sorted((e for e in prof.events()
                 if e.device_type == DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    k11 = [i for i, e in enumerate(ev) if "codeword_kernel" in e.name]
    if not k11:  # the profiler drops every event in some sessions
        return
    after = [e.name for e in ev[k11[0] + 1:]]
    # the download's own events come last: its gather and its copy
    tail = 1 + (n > 1)
    gated, download = after[:-tail], after[-tail:]
    assert sum("Memcpy DtoH" in x for x in download) == 1, after
    assert sum("Memcpy DtoH" in x for x in gated) == 1, after
    kernels = [x for x in gated if "Memcpy" not in x]
    assert all(any(k in x for k in EMIT_GATE) for x in kernels), kernels
    for k in ("pack_words_kernel", "emit_tables_kernel",
              "refbits_scatter_kernel"):
        assert sum(k in x for x in kernels) == 1, (k, kernels)
