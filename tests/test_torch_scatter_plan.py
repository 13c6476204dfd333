"""The decompositions of the decode scatter (kernel 5) and of the int8
transpose (kernel 6), held on the CPU (their CUDA code runs only on the
card: tests/test_torch_card.py, chip_smoke.py).

Scatter.  ``square_runs`` cuts the output into aligned 32x32 squares and
lists, for each, the contiguous runs of scan positions its valid pixels
read.  One block of the CUDA kernel takes one (square, channel group):
it stages each run of each channel of its group from ``lin`` into a slot
buffer (32 runs a round, by asynchronous copies), looks each pixel's slot
up among the runs (a binary search over their starts) and writes the
square's output rows, lane j of a row on pixel j // gc, channel j % gc.
``_scatter`` replays that in numpy and asserts that each element of
``lin`` is staged at most once and that no pixel reads a slot its block
did not stage; it must equal ``hilbert_scatter_plain`` and the JAX
package's Pallas scatter (interpret mode).

Transpose.  For int8 with both sides multiples of 16, a block moves a
128x128 byte tile: 16-byte words along the input rows into a
word-swizzled shared tile, then 16x4 byte blocks turned with
``__byte_perm`` and written as 16-byte words along the output rows.
``_transpose_bytes`` replays that, bank conflicts included, and must
equal ``x.T``.  Exact.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NPIX = 32 * 32
STRIDE = NPIX + 1
RCH = 32


@functools.lru_cache(maxsize=None)
def _row_lanes(gc: int, npx: int) -> tuple:
    """The write phase's (pixel, channel) of each int of a square row, as
    the lanes step them (px += 32 // gc, c += 32 % gc with a carry), in
    lane-major order; asserts that they equal divmod(j, gc) and that the
    32 lanes of a step write consecutive ints."""
    q, rm = 32 // gc, 32 % gc
    js, pxs, cs = [], [], []
    for lane in range(32):
        px, c = divmod(lane, gc)
        for j in range(lane, npx * gc, 32):
            assert (px, c) == divmod(j, gc)
            js.append(j)
            pxs.append(px)
            cs.append(c)
            px, c = px + q, c + rm
            if c >= gc:
                c, px = c - gc, px + 1
    assert sorted(js) == list(range(npx * gc))
    return np.asarray(pxs), np.asarray(cs)


def _search(starts, s):
    """The kernel's binary search: the last of ``starts`` (one round)
    that is <= s, or 0, for each of ``s``."""
    lo, hi = np.zeros(s.shape, np.int64), np.full(s.shape, len(starts))
    while (hi - lo > 1).any():
        act = hi - lo > 1
        mid = (lo + hi) >> 1
        le = starts[np.minimum(mid, len(starts) - 1)] <= s
        lo = np.where(act & le, mid, lo)
        hi = np.where(act & ~le, mid, hi)
    return lo


def _scatter(lin, src, sq_ptr, runs, group):
    """The CUDA kernel, block by block, on numpy arrays.  Returns the
    (H, W, C) output and how often each element of ``lin`` was staged."""
    (C, L), (H, W) = lin.shape, src.shape
    sqy, sqx = -(-H // 32), -(-W // 32)
    ngroups = -(-C // group)
    G = -(-C // ngroups)
    out = np.full((H, W, C), -7, np.int64)
    writes = np.zeros((H, W, C), np.int64)
    staged = np.zeros((C, L), np.int64)
    for sq in range(sqy * sqx):
        for g in range(ngroups):
            y0, x0 = (sq // sqx) * 32, (sq % sqx) * 32
            c0 = g * G
            gc = min(G, C - c0)
            ys, xs = np.mgrid[y0:y0 + 32, x0:x0 + 32]
            inside = (ys < H) & (xs < W)
            v = np.where(inside, src[np.minimum(ys, H - 1),
                                     np.minimum(xs, W - 1)], -1)
            s = np.where((v >= 0) & (v < L), v, -1).reshape(-1)
            slot = np.full(NPIX, -1, np.int64)
            buf = np.full((G, STRIDE), -9, np.int64)
            filled = np.zeros((G, STRIDE), bool)
            rb = min(max(int(sq_ptr[sq]), 0), runs.shape[0])
            re = min(max(int(sq_ptr[sq + 1]), rb), runs.shape[0])
            base = 0
            for r0 in range(rb, re, RCH):
                n = min(RCH, re - r0)
                a = runs[r0:r0 + n, 0].astype(np.int64)
                b = a + np.maximum(runs[r0:r0 + n, 1], 0)
                lo, hi = np.maximum(a, 0), np.minimum(b, L)
                ct = np.where(hi > lo, np.minimum(hi - lo, NPIX), 0)
                off = np.minimum(base + np.cumsum(ct) - ct, NPIX)
                cnt = np.minimum(ct, NPIX - off)
                r = _search(lo, s)
                d = s - lo[r]
                hit = (slot < 0) & (s >= 0) & (d >= 0) & (d < cnt[r])
                slot = np.where(hit, off[r] + d, slot)
                for k in range(n):
                    rows = slice(c0, c0 + gc)
                    seg = slice(off[k], off[k] + cnt[k])
                    buf[:gc, seg] = lin[rows, lo[k]:lo[k] + cnt[k]]
                    filled[:gc, seg] = True
                    staged[rows, lo[k]:lo[k] + cnt[k]] += 1
                base = off[n - 1] + cnt[n - 1]
            assert base <= NPIX
            slot = slot.reshape(32, 32)
            npx = min(32, W - x0)
            pxs, cs = _row_lanes(gc, npx)
            for row in range(min(32, H - y0)):
                t = slot[row, pxs]
                assert filled[cs[t >= 0], t[t >= 0]].all()
                val = np.where(t >= 0, buf[cs, np.maximum(t, 0)], 0)
                out[y0 + row, x0 + pxs, c0 + cs] = val
                writes[y0 + row, x0 + pxs, c0 + cs] += 1
    assert (writes == 1).all()
    return out, staged


def _geometry(w, h, sub=None):
    from dwt_tpu_torch.codec.decoder import scatter_source
    from dwt_tpu_torch.geometry import compute_pyramid

    pyr = compute_pyramid(*(sub or (w, h)))
    return pyr, scatter_source(pyr)


def _check_table(src, sq_ptr, runs):
    """The run table's invariants: counts <= 1,024 a square, runs
    ascending and disjoint, every index >= 0 in exactly one run of its
    square, and no position in a run that no pixel of the square reads."""
    from dwt_tpu_torch.ops.hilbert_scatter import SQ

    H, W = src.shape
    sqx = -(-W // SQ)
    assert sq_ptr.dtype == runs.dtype == np.int32 and runs.shape[1] == 2
    assert sq_ptr[0] == 0 and sq_ptr[-1] == runs.shape[0]
    assert len(sq_ptr) == -(-H // SQ) * sqx + 1
    assert (runs[:, 1] > 0).all() and (runs[:, 0] >= 0).all()
    for sq in range(len(sq_ptr) - 1):
        y0, x0 = (sq // sqx) * SQ, (sq % sqx) * SQ
        vals = src[y0:y0 + SQ, x0:x0 + SQ]
        vals = np.unique(vals[vals >= 0])
        r = runs[sq_ptr[sq]:sq_ptr[sq + 1]].astype(np.int64)
        assert r[:, 1].sum() <= NPIX
        assert (r[1:, 0] > r[:-1, 0] + r[:-1, 1]).all()  # disjoint, apart
        covered = np.concatenate([np.arange(a, a + n) for a, n in r]
                                 or [np.zeros(0, np.int64)])
        assert np.array_equal(covered, vals)


CASES = [  # (w, h, channels, reduced sub-pyramid or None)
    (8, 8, 1, None), (8, 8, 3, None), (9, 8, 1, None), (9, 8, 3, None),
    (321, 239, 1, None), (321, 239, 3, None),
    # the 4K tiled decode's four groups: N tiles as N * C channels
    (512, 512, 84, None), (256, 512, 12, None), (512, 112, 21, None),
    (256, 112, 3, None),
    # a reduced decode: the sub-pyramid's index into the full image's row
    (320, 240, 3, (160, 120)), (321, 239, 3, (41, 30)),
]


@pytest.mark.parametrize("w,h,c,sub", CASES)
def test_scatter_replay_equals_plain_and_jax(w, h, c, sub):
    import jax.numpy as jnp

    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu.hilbert import tile_plan
    from dwt_tpu.ops.pallas_hilbert import hilbert_scatter_pallas
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    rng = np.random.default_rng(w * 7 + h + c)
    lin = rng.integers(-2**20, 2**20, (c, w * h)).astype(np.int32)
    pyr, src = _geometry(w, h, sub)
    sq_ptr, runs = hs.square_runs(src)
    _check_table(src, sq_ptr, runs)
    got, staged = _scatter(lin, src, sq_ptr, runs, hs.GROUP)
    valid = np.zeros(lin.shape[1], bool)
    valid[src[src >= 0]] = True
    assert (staged[:, valid] == 1).all() and not staged[:, ~valid].any()
    want = hs.hilbert_scatter_plain(torch.from_numpy(lin),
                                    torch.from_numpy(src)).numpy()
    assert got.shape == want.shape == (pyr.height, pyr.width, c)
    assert np.array_equal(got, want)
    # The JAX package's kernel takes at most 4 channels, on the
    # sub-pyramid's own row length: the first stream's channels.
    k = min(c, 3)
    jpyr = compute_pyramid(pyr.width, pyr.height)
    jax_out = np.asarray(hilbert_scatter_pallas(
        jnp.asarray(lin[:k, :pyr.total]), tile_plan(jpyr, 1), pyr.height,
        pyr.width, k, interpret=True))
    assert np.array_equal(got[..., :k], jax_out)


@pytest.mark.parametrize("group", [1, 5, 12, 36])
def test_scatter_replay_channel_groups(group):
    """Every group size gives the same output (36 channels: groups of
    one, 8 groups of 4 or 5, 3 of 12, one of 36, more than a warp's
    lanes), on a ragged 100x70."""
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    _, src = _geometry(100, 70)
    lin = np.random.default_rng(group).integers(
        -2**20, 2**20, (36, src.size)).astype(np.int32)
    got, _ = _scatter(lin, src, *hs.square_runs(src), group)
    want = hs.hilbert_scatter_plain(torch.from_numpy(lin),
                                    torch.from_numpy(src)).numpy()
    assert np.array_equal(got, want)


def test_scatter_replay_on_any_index_and_table():
    """The kernel's function does not rest on the Hilbert structure: a
    random index (repeats, indices past L, -1) gives many runs a square,
    more than one round of 32; and a table that is not src's (runs past
    L, overlapping, more than 1,024 slots) stays inside the buffers."""
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    rng = np.random.default_rng(5)
    L = 3000
    src = rng.integers(-1, L + 40, (70, 45)).astype(np.int32)
    lin = rng.integers(-2**20, 2**20, (3, L)).astype(np.int32)
    sq_ptr, runs = hs.square_runs(src)
    _check_table(src, sq_ptr, runs)
    assert np.diff(sq_ptr).max() > RCH
    got, _ = _scatter(lin, src, sq_ptr, runs, 2)
    want = hs.hilbert_scatter_plain(torch.from_numpy(lin),
                                    torch.from_numpy(src)).numpy()
    assert np.array_equal(got, want)
    bad = np.asarray([[0, 2000], [100, 50], [L - 5, 900]], np.int32)
    ptr = np.asarray([0, 3] + [3] * (len(sq_ptr) - 2), np.int32)
    _scatter(lin, src, ptr, bad, 2)  # asserts inside the replay


@pytest.mark.parametrize("w,h,hist", [
    (3840, 2160, {1: 8037, 2: 123}), (512, 512, {1: 256}),
    (256, 512, {1: 128}), (512, 112, {1: 52, 2: 10, 3: 2}),
    (256, 112, {1: 26, 2: 6}), (960, 540, {1: 477, 2: 33}),
    (321, 239, {1: 73, 2: 15})])
def test_square_run_histogram(w, h, hist):
    """Runs a square at the 4K frame's and the tiles' geometries: one for
    most squares, one a level where a square straddles a level border."""
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    _, src = _geometry(w, h)
    sq_ptr, runs = hs.square_runs(src)
    n, k = np.unique(np.diff(sq_ptr), return_counts=True)
    assert dict(zip(n.tolist(), k.tolist())) == hist
    assert runs[:, 1].sum() == (src >= 0).sum()
    if w == 3840:
        assert (len(sq_ptr) - 1, runs.shape[0]) == (8160, 8283)


def test_decoder_tail_keeps_the_run_table():
    """The tail builds the table beside its index, and hands it to the
    scatter wrapper."""
    from dwt_tpu_torch.codec import decoder
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    tail = decoder._Tail(96, 80, 3, 3, False, torch.device("cpu"))
    want = hs.square_runs(tail.src)
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(tail.runs, want))


def test_scatter_wrapper_checks_the_table():
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    _, src = _geometry(40, 33)
    src = torch.from_numpy(src)
    lin = torch.arange(2 * 40 * 33, dtype=torch.int32).reshape(2, -1)
    sq_ptr, runs = hs.run_table(src)
    want = hs.hilbert_scatter_plain(lin, src)
    assert torch.equal(hs.hilbert_scatter(lin, src, sq_ptr, runs), want)
    with pytest.raises(ValueError, match="both"):
        hs.hilbert_scatter(lin, src, sq_ptr)
    with pytest.raises(ValueError, match="does not fit"):
        hs.hilbert_scatter(lin, src, sq_ptr[:-1], runs)
    with pytest.raises(ValueError, match="int32"):
        hs.hilbert_scatter(lin, src, sq_ptr.long(), runs)
    with pytest.raises(ValueError, match="does not fit"):
        hs.hilbert_scatter(lin, src, sq_ptr, runs.reshape(-1, 1))


# --- the int8 transpose ------------------------------------------------

TB, TBW, V = 128, 32, 16


def _swizzle(row):
    return ((row >> 4) & 7) << 2


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 numpy arrays."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * k)) & 7] << (8 * k) for k in range(4))


def _transpose4x4(a, b, c, d):
    x0, x1 = _byte_perm(a, b, 0x5140), _byte_perm(a, b, 0x7362)
    y0, y1 = _byte_perm(c, d, 0x5140), _byte_perm(c, d, 0x7362)
    return (_byte_perm(x0, y0, 0x5410), _byte_perm(x0, y0, 0x7632),
            _byte_perm(x1, y1, 0x5410), _byte_perm(x1, y1, 0x7632))


def _banks_distinct(words):
    """One shared-memory access of a warp (or of a quarter warp for
    16-byte words) is conflict-free: its words fall in distinct banks."""
    banks = np.asarray(words) % 32
    assert len(set(banks.tolist())) == len(banks)


def _transpose_bytes(x):
    """The byte kernel, block by block, on an (R, C) int8 numpy array."""
    R, C = x.shape
    per_row = TB // V
    out = np.zeros((C, R), np.uint8)
    written = np.zeros((C, R), np.int64)
    u = np.arange(TB * per_row)                         # phase 1
    lrow, lw = u // per_row, u % per_row
    ldst = lrow * TBW + ((lw * 4) ^ _swizzle(lrow))
    for i in range(0, len(u), 8):  # a quarter warp's 16-byte stores
        _banks_distinct((ldst[i:i + 8, None] + np.arange(4)).reshape(-1))
    t = np.arange(256)                                  # phase 2
    a, b = t % per_row, t // per_row
    rows = a[:, None] * V + np.arange(V)                # (threads, V)
    src_w = rows * TBW + (b[:, None] ^ _swizzle(rows))
    for i in range(0, 256, 32):
        for m in range(V):
            _banks_distinct(src_w[i:i + 32, m])
    xb = x.view(np.uint8)
    for r0 in range(0, R, TB):
        for c0 in range(0, C, TB):
            tile = np.zeros(TB * TBW, np.uint32)
            r, c = r0 + lrow, c0 + lw * V
            ok = (r < R) & (c < C)
            for k in range(4):
                word = sum(xb[r[ok], c[ok] + 4 * k + j].astype(np.uint32)
                           << (8 * j) for j in range(4))
                tile[ldst[ok] + k] = word
            w = [tile[src_w[:, m]] for m in range(V)]
            for m in range(0, V, 4):
                w[m:m + 4] = _transpose4x4(*w[m:m + 4])
            orow = r0 + a * V
            for k in range(4):
                oc = c0 + 4 * b + k
                ok = (oc < C) & (orow < R)
                for j in range(4):
                    for byte in range(4):
                        rr = orow[ok] + 4 * j + byte
                        out[oc[ok], rr] = (w[4 * j + k][ok] >> (8 * byte)) \
                            & 0xFF
                        written[oc[ok], rr] += 1
    assert (written == 1).all()
    return out.view(np.int8)


def _transpose_elements(x):
    """The element kernel: 32x32 tiles, each element through the tile."""
    R, C = x.shape
    out = np.zeros((C, R), x.dtype)
    for r0 in range(0, R, 32):
        for c0 in range(0, C, 32):
            t = x[r0:r0 + 32, c0:c0 + 32]
            out[c0:c0 + t.shape[1], r0:r0 + t.shape[0]] = t.T
    return out


@pytest.mark.parametrize("shape,vec", [
    ((128, 7680), 16), ((144, 400), 16), ((16, 16), 16), ((128, 7684), 1),
    ((132, 260), 1), ((129, 257), 1), ((3, 5), 1), ((257, 129), 1),
    ((3, 70001), 1)])
def test_transpose_replay_equals_transpose(shape, vec):
    from dwt_tpu_torch.ops import transpose

    x = np.random.default_rng(shape[1]).integers(
        -128, 128, shape).astype(np.int8)
    assert transpose.vector_bytes(torch.from_numpy(x)) == vec
    got = _transpose_bytes(x) if vec > 1 else _transpose_elements(x)
    assert got.dtype == np.int8 and np.array_equal(got, x.T)
    assert np.array_equal(
        transpose.transpose2d(torch.from_numpy(x)).numpy(), x.T)


def test_vli_scan_transposes_by_words():
    """Kernel 6 at the shapes the VLI scan gave it before it read the
    token arrays in place (``chip_smoke.py`` holds it there): the int8
    (128, padded_T / 128) always takes the byte kernel, since every token
    bucket is a multiple of the pack block, 2,048; the int32 transpose
    keeps the element kernel."""
    from dwt_tpu_torch.codec.encoder import _bucket
    from dwt_tpu_torch.codec.tokens import VLI_BLOCK
    from dwt_tpu_torch.ops import transpose

    for t in (1, 5000, 8193, 29_420_237, 2**27 + 1):
        padded_T = _bucket(t)
        assert padded_T % VLI_BLOCK == 0  # the scan's blocks: VLI_BLOCK
        nblk = padded_T // VLI_BLOCK
        assert transpose.vector_bytes(torch.zeros(
            (VLI_BLOCK, nblk), dtype=torch.int8)) == 16
        assert transpose.vector_bytes(torch.zeros(
            (nblk, VLI_BLOCK), dtype=torch.int32)) == 1
