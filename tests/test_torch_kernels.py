"""The plain PyTorch versions of the port's four kernels against the JAX
package's Pallas kernels (interpret mode, shrunk unit and block sizes as in
tests/test_pallas_compact.py) and their XLA/numpy oracles.  Exact.

On the CPU each kernel wrapper runs its plain version; the CUDA kernels
are held against the same plain versions on the card
(tests/test_torch_card.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def small_units(monkeypatch):
    """Shrink the compaction units in both packages alike (the values of
    tests/test_pallas_compact.py's small_kernels fixture)."""
    from dwt_tpu.ops import pallas_compact as pc
    from dwt_tpu_torch.ops import compact

    E = 2048
    for mod in (pc, compact):
        monkeypatch.setattr(mod, "E", E)
        monkeypatch.setattr(mod, "WTOK_BIG", E + pc.ADIRECT[-1] + 128)
        monkeypatch.setattr(mod, "WREF", E // 32 + 448)
    monkeypatch.setattr(pc, "WTOK_SMALL", max(E, pc.ADIRECT[-1]))
    monkeypatch.setattr(pc, "INTERPRET", True)
    return E


def _elements(rng, nunits, E, sub):
    """Packed sign|magnitude rows for nunits E-element units (+ E slack),
    magnitudes spread over planes 0..12, a few -1 pads."""
    n = (nunits + 1) * E
    mag = np.where(rng.random(n) < 0.35, 0,
                   (1 << rng.integers(0, 13, n)) + rng.integers(0, 64, n))
    v = (mag | (rng.integers(0, 2, n) << 30)).astype(np.int64)
    v[rng.random(n) < 0.02] = -1
    return v.astype(np.int32).reshape(-1, sub)


def _unit_rows(rng, vmag, E, sub, cls):
    """(u, 8) metadata rows in stream order: (row, elen, plane, count) with
    counts equal to the true number of outputs; cls picks newly
    significant (1) or refined (2) elements."""
    flat = vmag.reshape(-1)
    rows = []
    for u in range(vmag.shape[0] * sub // E - 1):
        elen = E - int(rng.integers(0, 300)) if u % 3 else E
        p = int(rng.integers(0, 8))
        el = flat[u * E : u * E + elen]
        sh = (el & ((1 << 30) - 1)) >> p
        ok = el >= 0
        cnt = int((ok & ((sh == 1) if cls == 1 else (sh > 1))).sum())
        if u % 5 == 4:
            cnt = 0  # a skipped unit
        rows.append((u * E // sub, elen, p, cnt))
    return rows


def test_compact_tokens_plain_equals_pallas(small_units):
    import jax.numpy as jnp

    from dwt_tpu.ops import pallas_compact as pc
    from dwt_tpu_torch.ops import compact

    E = small_units
    rng = np.random.default_rng(21)
    vmag = _elements(rng, 9, E, compact.SUBA)
    meta, u0 = [], 5
    for row, elen, p, cnt in _unit_rows(rng, vmag, E, compact.SUBA, 1):
        u0 += int(rng.integers(0, 40))
        meta.append((row, elen, p, u0, cnt))
        u0 += cnt
    pairbuf = u0 + compact.WTOK_BIG + 256
    table = []
    for row, elen, p, upair0, cnt in meta:
        ws = min(upair0 & ~127, (pairbuf - pc.WTOK_BIG) // 128 * 128)
        table.append([row, elen, p, ws, upair0 - ws,
                      int(rng.integers(0, 1000)), cnt, 0])
    table = np.asarray(table, np.int32)
    want = np.asarray(pc.compact_tokens_pallas(
        jnp.asarray(vmag), jnp.asarray(table),
        jnp.zeros((1, pairbuf), jnp.int32), interpret=True))[0]
    got = compact.compact_tokens(torch.as_tensor(vmag),
                                 torch.as_tensor(table), pairbuf)
    assert got.dtype == torch.int32 and got.shape == (pairbuf,)
    assert np.array_equal(got.numpy(), want)
    assert (want != 0).sum() > 200  # the drive places many pairs


def test_scatter_refbits_plain_equals_pallas(small_units):
    import jax.numpy as jnp

    from dwt_tpu.ops import pallas_compact as pc
    from dwt_tpu_torch.ops import compact

    E = small_units
    rng = np.random.default_rng(22)
    vmag = _elements(rng, 9, E, compact.SUBB)
    rows = _unit_rows(rng, vmag, E, compact.SUBB, 2)
    bit0 = 37  # word-misaligned
    starts = []
    for *_, cnt in rows:
        starts.append(bit0)
        bit0 += cnt + int(rng.integers(0, 70))
    nwords = bit0 // 32 + compact.WREF + 128
    table = []
    for (row, elen, p, cnt), ub in zip(rows, starts):
        ws = min((ub >> 5) & ~127, (nwords - pc.WREF) // 128 * 128)
        table.append([row, elen, p, ws, ub - 32 * ws, 0, cnt, 0])
    table = np.asarray(table, np.int32)
    words0 = rng.integers(0, 2**32, nwords, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(pc.scatter_refbits_pallas(
        jnp.asarray(vmag), jnp.asarray(table),
        jnp.asarray(words0).reshape(1, -1), interpret=True))[0]
    words = torch.as_tensor(words0.view(np.int32).copy())
    got = compact.scatter_refbits(torch.as_tensor(vmag),
                                  torch.as_tensor(table), words)
    assert got is words  # in place
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert not np.array_equal(want, words0)


def test_pack_words_plain_equals_pallas_and_scatter_add(monkeypatch):
    import jax.numpy as jnp

    from dwt_tpu.ops import pallas_pack as pp
    from dwt_tpu_torch.ops import pack

    monkeypatch.setattr(pp, "INTERPRET", True)
    rng = np.random.default_rng(23)
    n = pp.BLOCKN + 300  # one partial group of blocks
    widx = np.cumsum(rng.integers(0, 3, n)).astype(np.int32)
    c0, c1, c2 = (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
                  for _ in range(3))
    c2[rng.random(n) < 0.8] = 0
    nwords = int(widx[-1]) + pp._win() + pp._win1() + 520
    assert (pp._win(), pp._win1()) == (pack._win(), pack._win1())
    want = np.asarray(pp.pack_words_pallas(
        jnp.asarray(widx), jnp.asarray(c0), jnp.asarray(c1), jnp.asarray(c2),
        nwords, interpret=True))
    assert not np.asarray(pp.wild_blocks(jnp.asarray(
        np.concatenate([widx, np.full((-n) % (pp.KGRP * pp.BLOCKN),
                                      widx[-1], np.int32)])))).any()
    oracle = np.zeros(nwords, np.uint32)  # the XLA scatter-adds' function
    for k, c in enumerate((c0, c1, c2)):
        np.add.at(oracle, widx + k, c)
    got = pack.pack_words(*(torch.as_tensor(a.view(np.int32)) for a in
                            (widx, c0, c1, c2)), nwords)
    assert got.dtype == torch.int32 and got.shape == (nwords,)
    got = got.numpy().view(np.uint32)
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle)


@pytest.mark.parametrize("wh,c", [((64, 48), 3), ((96, 80), 1)])
def test_hilbert_gather_plain_equals_pallas(wh, c):
    import jax.numpy as jnp

    from dwt_tpu.codec.encoder import ALIGN
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu.hilbert import padded_layout, tile_plan
    from dwt_tpu.ops.pallas_hilbert import hilbert_gather_pallas
    from dwt_tpu_torch import geometry
    from dwt_tpu_torch.codec.stage1 import gather_source
    from dwt_tpu_torch.ops.hilbert_gather import hilbert_gather

    W, H = wh
    rng = np.random.default_rng(24)
    co = rng.integers(-2**20, 2**20, (H, W, c)).astype(np.int32)
    pyr = compute_pyramid(W, H)
    perm, valid, sizes = padded_layout(pyr, ALIGN)
    want = np.asarray(hilbert_gather_pallas(
        jnp.asarray(co), tile_plan(pyr, ALIGN), perm.shape[0], c,
        interpret=True))
    src = gather_source(geometry.compute_pyramid(W, H))
    got = hilbert_gather(torch.as_tensor(co), torch.as_tensor(src)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)
    # The XLA oracle (encoder.py:352) on every detail slot it fills.
    m = valid.copy()
    m[: sizes[0]] = False
    assert np.array_equal(got[:, m], co.reshape(-1, c)[perm].T[:, m])
    assert not got[:, ~m].any()
