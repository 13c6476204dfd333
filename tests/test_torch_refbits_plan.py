"""Kernel B's chunk-major decomposition, held on the CPU (its CUDA code
runs only on the card: tests/test_torch_card.py, chip_smoke.py).

The CUDA kernel groups the units of one chunk through kernel A's (G, P)
unit table and reads each element once for all its planes: an element of
key b (its magnitude's bit length) is refined at the planes p < b - 1, so
its rank in the unit of plane p is the count of earlier elements with a
key in [p + 2, 30], a suffix of the count launch's key histograms.  Each
thread reads consecutive elements once and, at each live plane, packs the
plane bits of its refined elements in order: consecutive stream bits, so
at most two words; a warp scan of the counts places them, and a block
assembles its whole run of each plane in shared memory and adds the
words strictly inside the run with plain stores, the two edge words with
atomics.  ``_scatter`` below replays that in numpy and asserts those
claims (at most two words a thread and plane; no plainly written word
touched by another run); it must equal ``scatter_refbits_plain`` and the
JAX package's Pallas kernel (interpret mode).  The encoder hands kernel B
the histograms of kernel A's count launch; the last test checks that
every group live for B was counted by A on lossless, capacity and tiled
encodes.  Exact.
"""

import numpy as np
import pytest
import torch

from conftest import random_image
from test_torch_kernels import _elements, _unit_rows, small_units  # noqa: F401

torch.set_num_threads(1)

PAD_KEY = 31
WARPS = 8
SUBLENS = (256, 1024, 2048)


def _keys(v):
    """Bit length of each element's magnitude; PAD_KEY for padding."""
    mag = (v & ((1 << 30) - 1)).astype(np.float64)
    return np.where(v < 0, PAD_KEY, np.frexp(mag)[1])


def _live_rows(m, slots):
    """Lane b -> meta row of the group's live unit of plane b - 1 (table
    slot b - 1), as the kernels' group_units reads the table row."""
    return {q + 1: int(r) for q, r in enumerate(slots)
            if 0 <= r < m.shape[0] and m[r, 6] > 0}


def _count(vmag, meta, table, sublen, E):
    """The count launch: for each group with a live unit in ``meta``, per
    sub-range the histogram of its keys (row 0) and, per warp segment, the
    histogram of the segments before it (row 1 + w).  Rows the launch
    leaves unwritten hold -1."""
    flat, m, t = vmag.reshape(-1), meta.astype(np.int64), table
    nsub, wseg = -(-E // sublen), sublen // WARPS
    hist = np.full((t.shape[0], nsub, 1 + WARPS, 32), -1, np.int64)
    for g in range(t.shape[0]):
        rows = _live_rows(m, t[g])
        if not rows:
            continue
        r = rows[min(rows)]
        el0, ln = m[r, 0] * vmag.shape[1], max(0, min(m[r, 1], E))
        keys = _keys(flat[el0:el0 + ln])
        for s in range(-(-ln // sublen)):
            acc = np.zeros(32, np.int64)
            for w in range(WARPS):
                hist[g, s, 1 + w] = acc
                lo = s * sublen + w * wseg
                acc = acc + np.bincount(keys[lo:lo + wseg], minlength=32)
            hist[g, s, 0] = acc
    return hist


def _scatter(vmag, meta, words, table, hist, sublen, E):
    """Kernel B's scatter launch, replayed on (vmag, meta, words) as numpy
    arrays over ``hist`` (:func:`_count`).  Returns the new words and
    {"plain": words stored plainly, "atomic": edge words added atomically,
    "runs": block runs}."""
    from dwt_tpu_torch.ops.compact import SUBLEN

    flat, m = vmag.reshape(-1), meta.astype(np.int64)
    nwords, wseg = words.shape[0], sublen // WARPS
    # Shared words of a block: its runs hold at most sublen * 29 bits, and
    # each adds at most 2 words of alignment (the kernel's B_WORDS).
    cap = sublen * 29 // 32 + 2 * 32
    assert SUBLEN * 29 // 32 + 2 * 32 == 3776
    acc = words.view(np.uint32).astype(np.int64)
    touched, plain, stats = {}, {}, dict(plain=0, atomic=0, runs=0)
    for g in range(table.shape[0]):
        rows = _live_rows(m, table[g])
        if not rows:
            continue
        r = rows[min(rows)]
        el0, ln = m[r, 0] * vmag.shape[1], max(0, min(m[r, 1], E))
        vals = flat[el0:el0 + ln]
        keys = _keys(vals)
        keys = np.where(keys == PAD_KEY, 0, keys)  # padding: never refined
        for s in range(-(-ln // sublen)):
            assert (hist[g, :s + 1, 0] >= 0).all()  # only rows counted
            before, cur = hist[g, :s, 0, :31].sum(0), hist[g, s, 0, :31]
            runs, tot = {}, 0
            for b, r in sorted(rows.items()):
                rank0, nrun = before[b + 1:].sum(), cur[b + 1:].sum()
                ncap = min(max(m[r, 6] - rank0, 0), nrun)
                if ncap <= 0:
                    continue
                bit = 32 * m[r, 3] + m[r, 4] + rank0
                w0 = bit >> 5
                nw = ((bit + ncap - 1) >> 5) - w0 + 1
                runs[b] = dict(a=bit & 31, ncap=ncap, w0=w0, nw=nw, seg=tot)
                tot += nw
            assert tot <= cap
            if not runs:
                continue
            shared = np.zeros(tot, np.int64)
            for w in range(WARPS):
                hrow = hist[g, s, 1 + w, :31]
                assert (hrow >= 0).all()
                lo = s * sublen + w * wseg
                k = np.zeros(wseg, np.int64)  # past the chunk: key 0
                v = np.zeros(wseg, np.int64)
                k[:max(0, ln - lo)] = keys[lo:lo + wseg]
                v[:max(0, ln - lo)] = vals[lo:lo + wseg]
                lane = np.arange(wseg) // (wseg // 32)  # each element's thread
                for b, run in runs.items():
                    if b >= k.max():
                        continue  # no element of the warp refined
                    R = k > b
                    rank0 = hrow[b + 1:].sum()  # the warp's first rank
                    lr = rank0 + np.cumsum(R) - R
                    mine = R & (lr < run["ncap"])
                    pos = run["a"] + lr
                    # A thread's bits are consecutive: at most two words.
                    first = np.full(32, 2**40)
                    last = np.full(32, -1)
                    np.minimum.at(first, lane[mine], pos[mine] >> 5)
                    np.maximum.at(last, lane[mine], pos[mine] >> 5)
                    assert (last - first <= 1).all()
                    on = mine & (((v >> (b - 1)) & 1) == 1)
                    np.bitwise_or.at(shared, run["seg"] + (pos[on] >> 5),
                                     np.left_shift(1, pos[on] & 31))
            for b, run in runs.items():
                stats["runs"] += 1
                for i in range(run["nw"]):
                    x, wd = shared[run["seg"] + i], run["w0"] + i
                    if not x or wd < 0 or wd >= nwords:
                        continue
                    acc[wd] += x
                    touched.setdefault(wd, set()).add((g, s, b))
                    if 0 < i < run["nw"] - 1:
                        plain[wd] = (g, s, b)
                        stats["plain"] += 1
                    else:
                        stats["atomic"] += 1
    # A word stored plainly is touched by its own run alone.
    for wd, owner in plain.items():
        assert touched[wd] == {owner}, (wd, touched[wd])
    assert stats["atomic"] <= 2 * stats["runs"]
    acc &= 0xFFFFFFFF
    return np.where(acc >= 2**31, acc - 2**32, acc).astype(np.int32), stats


def _pallas(vmag, meta, words):
    import jax.numpy as jnp

    from dwt_tpu.ops import pallas_compact as pc

    return np.asarray(pc.scatter_refbits_pallas(
        jnp.asarray(vmag), jnp.asarray(meta),
        jnp.asarray(words.view(np.uint32)).reshape(1, -1),
        interpret=True))[0].view(np.int32)


def _kernels_drive(rng, E):
    """tests/test_torch_kernels.py's kernel-B drive: one unit a chunk, a
    word-misaligned first bit, gaps between the units' bits."""
    from dwt_tpu.ops import pallas_compact as pc
    from dwt_tpu_torch.ops import compact

    vmag = _elements(rng, 9, E, compact.SUBB)
    rows = _unit_rows(rng, vmag, E, compact.SUBB, 2)
    bit0, starts = 37, []
    for *_, cnt in rows:
        starts.append(bit0)
        bit0 += cnt + int(rng.integers(0, 70))
    nwords = bit0 // 32 + compact.WREF + 128
    meta = []
    for (row, elen, p, cnt), ub in zip(rows, starts):
        ws = min((ub >> 5) & ~127, (nwords - pc.WREF) // 128 * 128)
        meta.append([row, elen, p, ws, ub - 32 * ws, 0, cnt, 0])
    words = rng.integers(0, 2**32, nwords, dtype=np.uint64).astype(np.uint32)
    return vmag, np.asarray(meta, np.int32), words.view(np.int32)


def _shared_drive(rng, E, kind):
    """Units of planes 0-9 sharing each of 5 chunks, rows shuffled as the
    schedule order gives them: ragged valid lengths, a chunk with no live
    unit, each unit's bits after the last one's with a random gap (none
    for "misaligned": neighbours share edge words), random prior words.
    "cut": counts below the true count on a third of the units; "past
    nwords": the buffer ends inside the units' bits; "prior ones": every
    prior word all ones, so the adds carry."""
    from dwt_tpu.ops import pallas_compact as pc
    from dwt_tpu_torch.ops import compact

    nchunk = 5
    vmag = _elements(rng, nchunk, E, compact.SUBB)
    flat = vmag.reshape(-1)
    units = []
    for k in range(nchunk):
        elen = E - int(rng.integers(1, 500)) if k % 2 else E
        el = flat[k * E:k * E + elen]
        for p in range(10):
            cnt = int(((el >= 0) & (((el & compact.MAGMASK) >> p) > 1)).sum())
            if k == 3:
                cnt = 0
            elif kind == "cut" and cnt and rng.random() < 0.35:
                cnt = int(rng.integers(0, cnt))
            units.append((k * E // compact.SUBB, elen, p, cnt))
    rows, bit = [], int(rng.integers(0, 32))
    for i in rng.permutation(len(units)):
        rows.append((*units[i], bit))
        bit += units[i][3] + (0 if kind == "misaligned"
                              else int(rng.integers(0, 70)))
    nwords = bit // 32 + compact.WREF + 128
    if kind == "past nwords":
        nwords = int(np.median([r[4] for r in rows])) // 32
    meta = []
    for row, elen, p, cnt, ub in rows:
        ws = (ub >> 5) & ~127
        if kind != "past nwords":
            ws = min(ws, (nwords - pc.WREF) // 128 * 128)
        meta.append([row, elen, p, ws, ub - 32 * ws, 0, cnt, 0])
    if kind == "prior ones":
        words = np.full(nwords, -1, np.int32)
    else:
        words = rng.integers(-2**31, 2**31, nwords).astype(np.int32)
    return vmag, np.asarray(meta, np.int32), words


@pytest.fixture
def small_encoder(small_units):
    """The port's encoder with the small units of ``small_units`` (both
    packages' E, WREF), its segmentation rebuilt before and after."""
    from dwt_tpu_torch.codec import stage1

    stage1.segs_for.cache_clear()
    yield small_units
    stage1.segs_for.cache_clear()


def _encoder_drive(img):
    """(vmag, kernel B's meta, the packed words before kernel B, the unit
    table, kernel A's meta) of a CPU encode."""
    from dwt_tpu_torch.codec import emit, encoder, stage1, tokens

    h, w, c = img.shape
    enc = encoder.Encoder(w, h, c, device="cpu")
    lin, stats = stage1._transform_and_stats(torch.as_tensor(img)[None],
                                             enc.pyr, c, c == 1, enc._src)
    padded_T = encoder._bucket(int(stats["T"][0]))
    segs = stage1.segs_for(enc.pyr, lin.device)
    tv, tr, tf, orders, vmag, com = tokens._stage2_tokens(lin, stats, enc.pyr,
                                                          c, padded_T)
    nwords = emit._stream_words(enc.pyr, c, padded_T)
    words, (refstart, *_) = emit._pack_bits(stats, tv, tr, tf, orders, com,
                                            enc.pyr, padded_T, nwords)
    meta_b = emit._kernel_b_meta(stats, segs, com, refstart, enc.pyr,
                                 padded_T, nwords)
    _, meta_a, _ = tokens._unit_tables(stats, segs, padded_T)
    return (vmag.numpy(), meta_b.numpy(), words[0].numpy(),
            com["table"].numpy(), meta_a.numpy())


CASES = ["kernels drive", "shared", "cut", "misaligned", "past nwords",
         "prior ones", "encoder"]
# The Pallas kernel writes every refined element of a live unit into its
# window: counts cut short and bits past the buffer hold against the
# plain version alone.
PLAIN_ONLY = ("cut", "past nwords")


@pytest.mark.parametrize("case", CASES)
def test_scatter_replay_equals_plain_and_pallas(small_encoder, case):
    """The replayed decomposition at several sub-range sizes, over the
    table the wrapper derives (and the encoder's own), equals the plain
    version and the JAX package's kernel B; the words it stores plainly
    belong to one run each, and each run adds at most two edge words
    atomically."""
    from dwt_tpu_torch.ops import compact

    E = small_encoder
    rng = np.random.default_rng(CASES.index(case) + 80)
    tables = []
    if case == "kernels drive":
        vmag, meta, words = _kernels_drive(rng, E)
    elif case == "encoder":
        img = random_image(np.random.default_rng(4), 96, 80, 3, "mixed")
        vmag, meta, words, table, _ = _encoder_drive(img)
        tables.append(table)
    else:
        vmag, meta, words = _shared_drive(rng, E, case)
    tables.append(compact.unit_table(torch.as_tensor(meta)).numpy())
    want = compact.scatter_refbits_plain(
        torch.as_tensor(vmag), torch.as_tensor(meta),
        torch.as_tensor(words.copy())).numpy()
    assert (want != words).sum() > 50
    if case not in PLAIN_ONLY:
        assert np.array_equal(_pallas(vmag, meta, words), want)
    plain_words = 0
    for table in tables:
        for sublen in SUBLENS:
            hist = _count(vmag, meta, table, sublen, E)
            got, stats = _scatter(vmag, meta, words, table, hist, sublen, E)
            assert np.array_equal(got, want), sublen
            plain_words += stats["plain"]
    assert plain_words > 0


def _spy_encode(monkeypatch, run):
    """Kernel A's and kernel B's arguments in every emit of ``run()``."""
    from dwt_tpu_torch.codec import emit, tokens

    calls = {"a": [], "b": []}
    real_a, real_b = tokens.compact_tokens, emit.scatter_refbits

    def spy_a(*args):
        calls["a"].append(args)
        return real_a(*args)

    def spy_b(vmag, meta, words, *rest):
        calls["b"].append((vmag, meta, words.clone(), *rest))
        return real_b(vmag, meta, words, *rest)

    monkeypatch.setattr(tokens, "compact_tokens", spy_a)
    monkeypatch.setattr(emit, "scatter_refbits", spy_b)
    run()
    assert len(calls["a"]) == len(calls["b"]) > 0
    return zip(calls["a"], calls["b"])


def _live_b_units(monkeypatch, run):
    """Kernel B's live units in every emit of ``run()``, after checking
    that each group live for B was counted by kernel A's count launch and
    that B over those histograms equals its plain version."""
    from dwt_tpu_torch.ops import compact

    live = 0
    for (vmag, meta_a, _, table_a, hist_a), (vb, meta_b, words, table,
                                              hist) in _spy_encode(
                                                  monkeypatch, run):
        assert vb is vmag and table is table_a and hist is hist_a
        ma, mb, t = meta_a.numpy(), meta_b.numpy(), table.numpy()
        for g in range(t.shape[0]):
            if _live_rows(mb, t[g]):
                assert _live_rows(ma, t[g]), g
        live += int((mb[:, 6] > 0).sum())
        want = compact.scatter_refbits_plain(vmag, meta_b, words.clone())
        h = _count(vmag.numpy(), ma, t, compact.SUBLEN, compact.E)
        got, _ = _scatter(vmag.numpy(), mb, words.numpy(), t, h,
                          compact.SUBLEN, compact.E)
        assert np.array_equal(got, want.numpy())
    return live


@pytest.mark.parametrize("path", ["single stream", "tiled"])
def test_b_reuses_a_histograms(monkeypatch, path):
    """The encoder hands kernel B the unit table and the histogram buffer
    of kernel A's count launch.  On lossless and cut encodes (a byte
    capacity; a tiled budget, whose layer cap masks schedule suffixes)
    every group with a live B unit has a live A unit, so A's launch
    counted it, and B replayed over the histograms counted on A's meta
    (uncounted rows marked) equals the plain version."""
    from dwt_tpu_torch.codec import encoder, tiled

    img = random_image(np.random.default_rng(6), 130, 70, 3, "mixed")
    if path == "single stream":
        full = encoder.encode(img, device="cpu")

        def run(cap):
            return lambda: encoder.Encoder(130, 70, 3,
                                           device="cpu").encode(img, cap)
    else:
        full = tiled.encode_tiled(img, tile=(64, 64), device="cpu")

        def run(cap):
            return lambda: tiled.encode_tiled(img, tile=(64, 64), budget=cap,
                                              device="cpu")
    lossless = _live_b_units(monkeypatch, run(0))
    monkeypatch.undo()
    assert 0 < _live_b_units(monkeypatch, run(len(full) // 3)) < lossless


def test_scatter_refbits_checks_table_and_hist():
    """Histograms need the table they were counted over, in its shape; on
    CPU tensors the wrapper runs the plain version, table and histograms
    or not."""
    from dwt_tpu_torch.ops import compact

    rng = np.random.default_rng(7)
    vmag = torch.as_tensor(_elements(rng, 1, compact.E, compact.SUBB))
    meta = torch.tensor([[0, compact.E, 1, 0, 5, 0, compact.E, 0]],
                        dtype=torch.int32)
    words = torch.zeros(compact.E // 32 + 64, dtype=torch.int32)
    table = compact.unit_table(meta)
    hist = compact.hist_for(table)
    with pytest.raises(ValueError, match="needs the table"):
        compact.scatter_refbits(vmag, meta, words.clone(), hist=hist)
    with pytest.raises(ValueError, match="does not fit"):
        compact.scatter_refbits(vmag, meta, words.clone(), table, hist[:, 1:])
    with pytest.raises(ValueError, match="planes"):
        compact.scatter_refbits(vmag, meta, words.clone(),
                                torch.zeros((1, 31), dtype=torch.int32))
    want = compact.scatter_refbits_plain(vmag, meta, words.clone())
    assert int((want != 0).sum()) > 100
    for extra in ((), (table,), (table, hist)):
        got = compact.scatter_refbits(vmag, meta, words.clone(), *extra)
        assert torch.equal(got, want)
