"""Kernel A's chunk-major decomposition, held on the CPU (its CUDA code
runs only on the card: tests/test_torch_card.py, chip_smoke.py).

The CUDA kernel groups the units of one chunk through a (G, P) unit table
(slot q: the meta row of plane q) and runs two launches over G chunks x
sub-ranges: key histograms of each sub-range and of its warps' segments
(key = the magnitude's bit length), then ranks and zero prefixes from the
histograms of the earlier sub-ranges and segments plus the ranks inside
a segment.  ``_count_then_place``
below replays that decomposition in plain PyTorch; it must equal
``compact_tokens_plain`` and the JAX package's Pallas kernel (interpret
mode), and the encoder's table must equal a numpy reference.  Exact.
"""

import numpy as np
import pytest
import torch

from conftest import random_image
from test_torch_kernels import _elements, _unit_rows, small_units  # noqa: F401

torch.set_num_threads(1)

PAD_KEY = 31


def _keys(v):
    """Bit length of each element's magnitude; PAD_KEY for padding."""
    from dwt_tpu_torch.ops.compact import MAGMASK

    mag = v & MAGMASK
    b = sum(((mag >> i) != 0).long() for i in range(30))
    return torch.where(v < 0, PAD_KEY, b)


def _count_then_place(vmag, meta, npairs, table, sublen, warps=8):
    """The CUDA kernel's two launches, replayed.  Count: for each (chunk,
    sub-range) the histogram of its keys (row 0) and, for each of its
    ``warps`` segments, the histogram of the segments before it (row 1 +
    w).  Place: each segment starts from the earlier sub-ranges' and
    segments' counts and ranks its own elements."""
    from dwt_tpu_torch.ops.compact import E, NBIN, SUBA

    flat, m = vmag.reshape(-1).long(), meta.long()
    G, U = table.shape[0], m.shape[0]
    nsub, wseg = -(-E // sublen), sublen // warps
    out = torch.zeros(npairs, dtype=torch.int64)
    hist = torch.zeros((G, nsub, 1 + warps, NBIN), dtype=torch.int64)
    chunks = []
    for g in range(G):  # count launch
        live = [(q, r) for q, r in enumerate(table[g].tolist())
                if 0 <= r < U and m[r, 6] > 0]
        if not live:
            chunks.append(None)
            continue
        r0 = live[0][1]
        el0, ln = int(m[r0, 0]) * SUBA, max(0, min(int(m[r0, 1]), E))
        keys = _keys(flat[el0:el0 + ln])
        for s in range(nsub):
            for w in range(warps):
                seg = keys[s * sublen + w * wseg:s * sublen + (w + 1) * wseg]
                cnt = torch.bincount(seg, minlength=NBIN)
                hist[g, s, 1 + w + 1:] += cnt
                hist[g, s, 0] += cnt
        chunks.append((el0, ln, live))
    for g, chunk in enumerate(chunks):  # place launch
        if chunk is None:
            continue
        el0, ln, live = chunk
        for s in range(-(-ln // sublen)):
            for w in range(warps):
                lo = s * sublen + w * wseg
                v = flat[el0 + lo:el0 + min(ln, lo + wseg)]
                if not v.numel():
                    continue
                key = _keys(v)
                before = hist[g, :s, 0].sum(0) + hist[g, s, 1 + w]
                below = torch.cumsum(before, 0) - before  # smaller keys
                onehot = torch.nn.functional.one_hot(key, NBIN)
                same = torch.cumsum(onehot, 0) - onehot   # earlier, by key
                smaller = torch.cumsum(same, 1) - same    # earlier, keys below
                rank_in = same.gather(1, key[:, None])[:, 0]
                zeros_in = smaller.gather(1, key[:, None])[:, 0]
                for q, r in live:  # slot q: plane q, key q + 1
                    sel = key == q + 1
                    rank = before[q + 1] + rank_in[sel]
                    zeros = m[r, 5] + below[q + 1] + zeros_in[sel]
                    slot = m[r, 3] + m[r, 4] + rank
                    keep = (rank < m[r, 6]) & (slot >= 0) & (slot < npairs)
                    val = (zeros << 1) | ((v[sel] >> 30) & 1)
                    out[slot[keep]] = val[keep]
    out &= 0xFFFFFFFF
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def _pallas(vmag, meta, pairbuf):
    import jax.numpy as jnp

    from dwt_tpu.ops import pallas_compact as pc

    return np.asarray(pc.compact_tokens_pallas(
        jnp.asarray(vmag), jnp.asarray(meta),
        jnp.zeros((1, pairbuf), jnp.int32), interpret=True))[0]


def _windows(upair0, pairbuf):
    """Window starts and offsets as the encoder and the TPU kernel take
    them (128-aligned, clipped to the buffer)."""
    from dwt_tpu.ops import pallas_compact as pc

    ws = min(upair0 & ~127, (pairbuf - pc.WTOK_BIG) // 128 * 128)
    return ws, upair0 - ws


def _unit_fixture(rng, E, sub):
    """tests/test_torch_kernels.py's kernel-A drive: one unit a chunk."""
    from dwt_tpu_torch.ops import compact

    vmag = _elements(rng, 9, E, sub)
    rows, u0 = [], 5
    for row, elen, p, cnt in _unit_rows(rng, vmag, E, sub, 1):
        u0 += int(rng.integers(0, 40))
        rows.append((row, elen, p, u0, cnt))
        u0 += cnt
    pairbuf = u0 + compact.WTOK_BIG + 256
    meta = []
    for row, elen, p, upair0, cnt in rows:
        meta.append([row, elen, p, *_windows(upair0, pairbuf),
                     int(rng.integers(0, 1000)), cnt, 0])
    return vmag, np.asarray(meta, np.int32), pairbuf


def _shared_fixture(rng, E, sub, cut=False, nchunk=5, planes=10):
    """Units of planes 0..planes-1 sharing each chunk, their rows shuffled
    (as the schedule order gives them): ragged valid lengths (col 1 < E),
    random zero carries, one chunk with no live unit; with ``cut``, some
    counts below the true count (the TPU kernel writes every newly
    significant element into its window, so those hold only against the
    plain version)."""
    from dwt_tpu_torch.ops import compact

    vmag = _elements(rng, nchunk, E, sub)
    flat = vmag.reshape(-1)
    units = []
    for k in range(nchunk):
        elen = E - int(rng.integers(1, 500)) if k % 2 else E
        el = flat[k * E:k * E + elen]
        for p in range(planes):
            true = int(((el >= 0) & (((el & compact.MAGMASK) >> p) == 1)).sum())
            cnt = 0 if k == 3 else true
            if cut and cnt and rng.random() < 0.3:
                cnt = int(rng.integers(0, cnt))  # below the true count
            units.append((k * E // sub, elen, p, cnt))
    order = rng.permutation(len(units))
    rows, u0 = [], 3
    for i in order:
        row, elen, p, cnt = units[i]
        u0 += int(rng.integers(0, 40))
        rows.append((row, elen, p, u0, cnt))
        u0 += cnt
    pairbuf = u0 + compact.WTOK_BIG + 256
    meta = []
    for row, elen, p, upair0, cnt in rows:
        meta.append([row, elen, p, *_windows(upair0, pairbuf),
                     int(rng.integers(0, 5000)), cnt, 0])
    return vmag, np.asarray(meta, np.int32), pairbuf


@pytest.mark.parametrize("fixture,sublen", [
    ("units", 256), ("units", 2048), ("shared", 256), ("shared", 512),
    ("shared", 4096)])
def test_count_then_place_equals_plain_and_pallas(small_units, fixture,
                                                  sublen):
    """On the drive of tests/test_torch_kernels.py:64 (one unit a chunk)
    and on units that share chunks: the replayed decomposition, the plain
    version and the JAX kernel agree, over the table that the wrapper
    derives, at several sub-range sizes."""
    from dwt_tpu_torch.ops import compact

    E = small_units
    rng = np.random.default_rng(21)
    make = _unit_fixture if fixture == "units" else _shared_fixture
    vmag, meta, pairbuf = make(rng, E, compact.SUBA)
    table = compact.unit_table(torch.as_tensor(meta))
    if fixture == "shared":  # 5 chunks, one with no live unit
        assert table.shape[0] == 4 and (table[:, :10] >= 0).sum() > 30
    want = _pallas(vmag, meta, pairbuf)
    plain = compact.compact_tokens_plain(torch.as_tensor(vmag),
                                         torch.as_tensor(meta), pairbuf)
    got = _count_then_place(torch.as_tensor(vmag), torch.as_tensor(meta),
                            pairbuf, table, sublen)
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(got.numpy(), want)
    assert (want != 0).sum() > 200


@pytest.mark.parametrize("sublen", [256, 1024])
def test_count_then_place_caps_counts_and_drops_slots(small_units, sublen):
    """Counts below the true count stop a unit's placing, and slots past
    npairs (the buffer cut short of the last units' pairs) are dropped, as
    in the plain version."""
    from dwt_tpu_torch.ops import compact

    rng = np.random.default_rng(5)
    vmag, meta, _ = _shared_fixture(rng, small_units, compact.SUBA, cut=True)
    npairs = int(np.median(meta[:, 3] + meta[:, 4]))
    v, m = torch.as_tensor(vmag), torch.as_tensor(meta)
    want = compact.compact_tokens_plain(v, m, npairs)
    got = _count_then_place(v, m, npairs, compact.unit_table(m), sublen)
    assert torch.equal(got, want) and int((want != 0).sum()) > 100


@pytest.fixture
def small_chunks(monkeypatch):
    """The port's encoder with 2048-element chunks (several a level at
    small sizes), its segmentation rebuilt before and after."""
    from dwt_tpu_torch.codec import stage1
    from dwt_tpu_torch.ops import compact

    stage1.segs_for.cache_clear()
    monkeypatch.setattr(compact, "E", 2048)
    yield 2048
    stage1.segs_for.cache_clear()


def _encode_units(img):
    """(vmag, meta, pair-buffer size, unit table, com) of a CPU encode."""
    from dwt_tpu_torch.codec import encoder, stage1, tokens

    h, w, c = img.shape
    enc = encoder.Encoder(w, h, c, device="cpu")
    lin, stats = stage1._transform_and_stats(torch.as_tensor(img)[None],
                                             enc.pyr, c, c == 1, enc._src)
    padded_T = encoder._bucket(int(stats["T"][0]))
    segs = stage1.segs_for(enc.pyr, lin.device)
    com, meta, pairbuf = tokens._unit_tables(stats, segs, padded_T)
    vmag = tokens._packed_elems(lin, segs)
    return vmag, meta, pairbuf, com["table"], segs


@pytest.mark.parametrize("w,h,c", [(96, 80, 3), (64, 48, 1), (9, 8, 3)])
def test_encoder_unit_table_equals_numpy(small_chunks, w, h, c):
    """The encoder's table (the inverse of flat_ck) against a numpy
    reference built from the meta table alone: groups in order of their
    first row, slot = plane; every group's units share first row and
    valid length; and the table the wrapper derives from the meta keeps
    the same rows for the live units."""
    from dwt_tpu_torch.codec.stage1 import PMAX
    from dwt_tpu_torch.ops import compact

    img = random_image(np.random.default_rng(3), w, h, c, "mixed")
    _, meta, _, table, segs = _encode_units(img)
    m = meta.numpy()
    starts = np.unique(m[:, 0])
    ref = np.full((starts.shape[0], PMAX), -1, np.int32)
    ref[np.searchsorted(starts, m[:, 0]), m[:, 2]] = np.arange(m.shape[0])
    assert table.shape == (c * segs.nchunk, PMAX)
    assert np.array_equal(table.numpy(), ref)
    assert segs.nchunk > segs.L  # several chunks a level
    for k in (0, 1):  # a group's first row and valid length
        assert (m[ref, k] == m[ref[:, :1], k]).all()
    live = (m[:, 6] > 0)[ref]
    derived = compact.unit_table(meta).numpy()
    want = np.where(live, ref, -1)[live.any(1)]
    assert np.array_equal(derived[:, :PMAX], want)
    assert (derived[:, PMAX:] == -1).all()


@pytest.mark.parametrize("sublen", [512, 4096])
def test_count_then_place_equals_plain_on_an_encode(small_chunks, sublen):
    """The replay over the encoder's own table and meta equals the plain
    version, which the encoder's parity tests hold to the JAX package."""
    from dwt_tpu_torch.ops import compact

    img = random_image(np.random.default_rng(4), 96, 80, 3, "mixed")
    vmag, meta, pairbuf, table, _ = _encode_units(img)
    want = compact.compact_tokens_plain(vmag, meta, pairbuf)
    got = _count_then_place(vmag, meta, pairbuf, table, sublen)
    assert torch.equal(got, want) and int((want != 0).sum()) > 1000
    # The wrapper on CPU tensors runs the plain version, table or not.
    assert torch.equal(compact.compact_tokens(vmag, meta, pairbuf, table),
                       want)


def test_unit_table_groups():
    """Dead units, lengths <= 0 and planes past PLANES stay out; a second
    unit of one chunk and plane opens a group of its own; a negative
    plane of a live unit is refused."""
    from dwt_tpu_torch.ops import compact

    meta = torch.tensor([
        [4, 100, 2, 0, 0, 0, 5, 0],      # 0: chunk 4, plane 2
        [0, 100, 1, 0, 0, 0, 5, 0],      # 1: chunk 0, plane 1
        [4, 100, 3, 0, 0, 0, 0, 0],      # 2: dead
        [4, 100, 2, 0, 0, 0, 5, 0],      # 3: chunk 4, plane 2 again
        [4, 100, 0, 0, 0, 0, 5, 0],      # 4: chunk 4, plane 0
        [8, 0, 0, 0, 0, 0, 5, 0],        # 5: no elements
        [8, 100, compact.PLANES, 0, 0, 0, 5, 0],  # 6: no plane to place
        [4, 90, 5, 0, 0, 0, 5, 0],       # 7: chunk 4, another length
    ], dtype=torch.int32)
    t = compact.unit_table(meta)
    assert t.shape == (4, compact.PLANES)
    groups = [{q: r for q, r in enumerate(row) if r >= 0} for row in t.tolist()]
    assert groups == [{1: 1}, {5: 7}, {0: 4, 2: 0}, {2: 3}]
    meta[2, 2], meta[2, 6] = -1, 5
    with pytest.raises(ValueError, match="negative plane"):
        compact.unit_table(meta)
