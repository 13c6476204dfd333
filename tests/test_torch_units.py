"""Kernel 15, kernel A's unit tables (``dwt_tpu_torch/ops/units.py``,
``csrc/units.cu``), on the CPU.

* Its plain version against the JAX package's ``_unit_common`` and
  ``_kernel_a_meta`` on the same stats: the six unit columns and the meta
  rows exactly (frame f's element rows and pair windows offset by the
  earlier frames'), at two token buckets, one frame and three; its table
  is the inverse of the units' (frame, channel, chunk, plane) index.
* Stage 1's ``ubase_sched`` against the unit bases of the JAX package's
  ``_unit_common``.
* The kernel's plan replayed in numpy: the staging of a row (one bulk
  copy of its whole 16-byte words, plain loads around them) at every
  row start, each unit's step by a binary search of the staged bases.
* The wrapper's one allocation and its checks.

The kernel runs only on the card: ``tests/test_torch_card.py`` holds it
against this plain version there.
"""

import numpy as np
import pytest
import torch

from imagegen import random_image

PMAX = 29


def _port(w, h, c, n, seed):
    from dwt_tpu_torch.codec import encoder, stage1

    rng = np.random.default_rng(seed)
    frames = np.stack([random_image(rng, w, h, c, ("mixed", "noise", "flat")[
        i % 3]) for i in range(n)])
    enc = encoder.Encoder(w, h, c, device="cpu")
    lin, stats = enc.stage1_frames(frames)
    return enc, stats, stage1.segs_for(enc.pyr, lin.device)


@pytest.mark.parametrize("w,h,c,n", [(96, 80, 3, 1), (64, 48, 1, 3),
                                     (16, 16, 3, 3)])
@pytest.mark.parametrize("scale", [1, 4])
def test_unit_tables_plain_equals_jax(monkeypatch, w, h, c, n, scale):
    import jax.numpy as jnp

    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu_torch.codec import encoder, tokens
    from dwt_tpu_torch.ops import compact, units

    monkeypatch.setattr(je, "_use_pallas", lambda: False)
    enc, stats, segs = _port(w, h, c, n, w + n)
    padded_T = encoder._bucket(int(stats["T_host"].max())) * scale
    com, meta, pairbuf = tokens._unit_tables(stats, segs, padded_T)
    U = c * PMAX * segs.nchunk
    assert meta.shape == (n * U, 8) and meta.dtype == torch.int32
    pyr = compute_pyramid(w, h)
    jsegs = je._Segs(pyr)
    for f in range(n):
        js = {k: jnp.asarray(stats[k][f].numpy()) for k in (
            "order", "valid_sched", "step_base", "nS_ck", "nZ_ck")}
        want = je._unit_common(js, jsegs, pyr, c)
        for k in units.COM_KEYS:
            g, w_ = com[k][f].numpy(), np.asarray(want[k])
            assert g.dtype == w_.dtype and np.array_equal(g, w_), k
        wmeta, wbuf = je._kernel_a_meta(js, jsegs, want, padded_T)
        assert pairbuf == wbuf
        g = meta[f * U:(f + 1) * U].numpy().copy()
        g[:, 0] -= f * c * segs.n // compact.SUBA
        g[:, 3] -= f * pairbuf
        assert np.array_equal(g, np.asarray(wmeta))
    # the table is the inverse of flat_ck, frame f's units from f * U
    flat = (com["flat_ck"].long()
            + torch.arange(n)[:, None] * U).reshape(-1)
    table = com["table"]
    assert table.shape == (n * c * segs.nchunk, PMAX)
    assert torch.equal(table.reshape(-1)[flat],
                       torch.arange(n * U, dtype=torch.int32))
    assert torch.equal(torch.sort(table.reshape(-1)).values,
                       torch.arange(n * U, dtype=torch.int32))


def _args(stats, segs, padded_T) -> list:
    """The arguments of ``unit_tables`` from stage 1's stats."""
    return [stats["order"], stats["ubase_sched"], stats["valid_sched"],
            stats["step_base"], stats["nS_ck"], stats["scar_ck"],
            stats["zcar_ck"], segs.level_chunk_base_t, segs.ch_start_t,
            segs.ch_len_t, segs.n, padded_T]


@pytest.mark.parametrize("w,h,c,n", [(96, 80, 3, 1), (64, 48, 1, 3),
                                     (16, 16, 3, 3), (8, 8, 1, 1)])
def test_ubase_sched_equals_jax(monkeypatch, w, h, c, n):
    """Stage 1's ``ubase_sched`` (the plain version's) is the ``ubase`` of
    the JAX package's ``_unit_common``: each step's first unit, read off
    its units' steps (every step has a unit); and the unit columns read
    from it equal ``_unit_common``'s."""
    import jax.numpy as jnp

    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu_torch.ops import units

    monkeypatch.setattr(je, "_use_pallas", lambda: False)
    enc, stats, segs = _port(w, h, c, n, 3 * w + n)
    assert stats["ubase_sched"].dtype == torch.int32
    pyr = compute_pyramid(w, h)
    jsegs = je._Segs(pyr)
    com = dict(zip(units.OUT_KEYS, units.unit_tables_plain(
        *_args(stats, segs, 1 << 13))))
    for f in range(n):
        js = {k: jnp.asarray(stats[k][f].numpy()) for k in (
            "order", "valid_sched", "step_base", "nS_ck", "nZ_ck")}
        want = je._unit_common(js, jsegs, pyr, c)
        flat_step = np.asarray(want["flat_step"])
        first = {}
        for u, st in enumerate(flat_step):
            first.setdefault(int(st), u)
        order = stats["order"][f].numpy()
        assert np.array_equal(stats["ubase_sched"][f].numpy(),
                              [first[int(st)] for st in order])
        for k in units.COM_KEYS:
            assert np.array_equal(com[k][f].numpy(), np.asarray(want[k])), k


@pytest.mark.parametrize("N,C,nchunk", [(1, 3, 136), (7, 3, 39), (3, 1, 2),
                                        (0, 3, 2)])
def test_unit_tables_arena_layout(monkeypatch, N, C, nchunk):
    """Kernel 15's one allocation a call: its outputs as disjoint views at
    256-byte offsets, of the plain version's dtypes and shapes, in the C
    source's order; two calls never share it; the wrapper passes the
    allocation and the offsets to its entry point."""
    from test_torch_schedule import _arena_checks, _enum, _fake_library

    from dwt_tpu_torch.ops import _launch, units

    _enum("units.cu", units.OUT_KEYS)
    nbytes, views, offsets = units._layout(N, C, nchunk)
    offs = list(offsets.at)
    outs = _launch.carve(nbytes, views, "cpu")
    _arena_checks(outs, nbytes, offs)
    U = C * PMAX * nchunk
    assert [(t.dtype, tuple(t.shape)) for t in outs] == (
        [(torch.int32, (N, U))] * 5 + [(torch.bool, (N, U)),
                                       (torch.int32, (N * U, 8)),
                                       (torch.int32, (N * C * nchunk, PMAX))])
    if N == 0:
        return
    enc, stats, segs = _port(64, 48, 3, N, N)
    args = _args(stats, segs, 1 << 13)
    nbytes, views, offsets = units._layout(N, 3, segs.nchunk)
    calls = []
    _fake_library(monkeypatch, "dwt_unit_tables", calls)
    monkeypatch.setattr(units, "_check", lambda *a: True)
    before = units.unit_tables.launches
    got = units.unit_tables(*args)
    again = units.unit_tables(*args)
    assert units.unit_tables.launches == before + 2 and len(calls) == 2
    want = units.unit_tables_plain(*args)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
    assert calls[0][-3] == got[0].data_ptr()
    assert list(calls[0][-2].at) == list(offsets.at)
    assert calls[0][10:16] == (N, 3, enc.pyr.levels, segs.nchunk, segs.n,
                               1 << 13)
    assert (again[0].untyped_storage().data_ptr()
            != got[0].untyped_storage().data_ptr())


def _stage_plan(a: int, S: int) -> tuple:
    """units_kernel's staging of a row of S ints at byte address ``a`` (a
    multiple of 4): (head, the bulk copy's (source, shared-memory int
    index, bytes) or None, the ints loaded plainly)."""
    e = a + 4 * S
    lo, hi = (a + 15) & ~15, e & ~15
    head = (a & 15) >> 2
    bulk = hi > lo
    plain = [j for j in range(S) if not bulk or a + 4 * j < lo
             or a + 4 * j >= hi]
    copy = (lo, head + (lo - a) // 4, hi - lo) if bulk else None
    return head, copy, plain


@pytest.mark.parametrize("S", [1, 3, 4, 5, 58, 783, 1856, 2048])
def test_unit_staging_covers_each_int_once(S):
    """The staged row: at every row start (mod 16), the bulk copy (16-byte
    source, destination and size) and the plain loads put each int j of
    the row at head + j, once, inside the buffer of MAX_STEPS + 4 ints."""
    for a in range(4096, 4096 + 64, 4):
        head, copy, plain = _stage_plan(a, S)
        got = [0] * (S + head)
        for j in plain:
            got[head + j] += 1
        if copy:
            src, at, nbytes = copy
            assert src % 16 == 0 and at % 4 == 0 and nbytes % 16 == 0
            assert src == a + 4 * (at - head)
            for q in range(at, at + nbytes // 4):
                got[q] += 1
        assert got[head:] == [1] * S and head + S <= 2048 + 4
        assert len(plain) <= (6 if copy else S)


def _replay_steps(ubase, U):
    """units_kernel's step of each of U units, a unit a thread: a binary
    search of the staged bases for the last at most u."""
    S = ubase.shape[0]
    steps = []
    for u in range(U):
        lo, hi = 0, S
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            lo, hi = (mid, hi) if ubase[mid] <= u else (lo, mid)
        steps.append((lo, u - int(ubase[lo])))
    return steps


def test_unit_plan_replayed():
    """The replayed step search over stage 1's ``ubase_sched`` gives each
    unit the step and chunk that the plain version's searchsorted does, on
    a 3-frame sub-batch, every unit of a frame found (one block a 256
    units, a unit a thread)."""
    from dwt_tpu_torch.codec import tokens

    enc, stats, segs = _port(64, 48, 3, 3, 5)
    com, _, _ = tokens._unit_tables(stats, segs, 1 << 14)
    lnc = np.asarray(segs.level_nchunk)
    lcb = np.asarray(segs.level_chunk_base)
    L = enc.pyr.levels
    U = 3 * PMAX * segs.nchunk
    for f in range(3):
        order = stats["order"][f].numpy()
        ubase = stats["ubase_sched"][f].numpy()
        assert ubase[-1] + lnc[(order[-1] // PMAX) % L] == U
        steps = _replay_steps(ubase, U)
        ords = np.asarray([order[s] for s, _ in steps])
        chunk = np.asarray([lcb[(order[s] // PMAX) % L] + k
                            for s, k in steps])
        c, p = ords // (L * PMAX), ords % PMAX
        assert np.array_equal(com["flat_step"][f].numpy(), ords)
        assert np.array_equal(com["flat_ck"][f].numpy(),
                              (c * segs.nchunk + chunk) * PMAX + p)
        valid = stats["valid_sched"][f].numpy()[[s for s, _ in steps]]
        assert np.array_equal(com["valid"][f].numpy(), valid)


@pytest.mark.parametrize("case", ["order dtype", "valid dtype",
                                  "chunk tables", "chunk starts", "device"])
def test_unit_tables_checks(case):
    """The wrapper raises on what kernel 15 does not take."""
    from dwt_tpu_torch.ops import units

    enc, stats, segs = _port(16, 16, 3, 2, 1)
    args = _args(stats, segs, 1 << 13)
    assert units.unit_tables(*args) and units.unit_tables_plain(*args)
    if case == "order dtype":
        args[0] = args[0].long()
    elif case == "valid dtype":
        args[2] = args[2].to(torch.int32)
    elif case == "chunk tables":
        args[5] = args[5][:1]
    elif case == "chunk starts":
        args[8] = args[8][:-1]
    else:
        args[6] = torch.empty(args[6].shape, dtype=torch.int32,
                              device="meta")
    with pytest.raises(ValueError):
        units.unit_tables(*args)
