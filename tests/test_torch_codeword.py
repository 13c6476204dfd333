"""The codeword pieces (kernel 11, ``dwt_tpu_torch/ops/codeword.py``)
against the JAX package's ``_codeword_contribs`` and ``_bit_partials``.

Seeded token arrays made with numpy go through both: off, widx, the three
pieces (as uint32), each step's first refinement-bit position and the
bit partials must be equal, exactly, at the edges of the codeword
arithmetic (s + k = 30, 0-bit raw slots, bit shifts 0 and 31), of the
injections (several steps on one site, sites at 0, at and past T, at the
kernel's tile edges) and for a batch of frames whose rows lie at stride
T + 1, as the token finisher leaves them.  The kernel's plan (striped
loads, rows of 16 slots, the per-thread, warp and tile scans, the
injections, the two chunk sums a tile, the decoupled look-back) is
replayed in numpy with tiles finishing in every order.  On the CPU the
wrapper runs its plain version.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dwt_tpu.codec import encoder as je
from dwt_tpu_torch.codec import emit
from dwt_tpu_torch.ops import codeword

C, L, PMAX = 3, 2, 29
S = C * L * PMAX
M32 = 0xFFFFFFFF


def _tokens(rng, n, T, stride=0):
    """(n, T) int32 values, raw lengths, orders and bool VLI flags (rows
    at ``stride`` when given): VLI values of any order with s + k <= 30,
    the largest and smallest values at s + k = 30 among them, raw tokens
    of 0-31 bits (0-bit slots hold 0)."""
    W = stride or T
    vli = rng.random((n, W)) < 0.55
    s = rng.integers(0, 31, (n, W))
    top = (1 << 31) - (1 << s)  # v + 2^s < 2^31 <=> s + k <= 30
    e = rng.integers(0, 32, (n, W))
    v = np.minimum(rng.integers(0, 1 << 31, (n, W)) >> (31 - np.minimum(
        e, 31)), top - 1)
    edge = rng.random((n, W))
    v = np.where(edge < 0.03, top - 1, np.where(
        edge < 0.06, (1 << 30) - (1 << s), v))
    raw = rng.integers(0, 32, (n, W))
    rv = rng.integers(0, 1 << 31, (n, W)) >> (31 - raw)
    raw[rng.random((n, W)) < 0.1] = 0
    rv = np.where(raw == 0, 0, rv)
    val = np.where(vli, v, rv).astype(np.int32)
    raw = np.where(vli, 0, raw).astype(np.int32)
    return (val[:, :T].copy() if not stride else val, raw if stride else
            raw[:, :T].copy(), s.astype(np.int32), vli)


def _steps(rng, T):
    """One frame's (C, L, PMAX) step tables: sites anywhere in [-5, T + 5]
    with the edges forced (0, T, past T, below 0, the kernel's tile edges,
    several steps on one site)."""
    site = rng.integers(-5, T + 6, S)
    forced = [0, T, T + 3, -2, 4095, 4096, 4097, 8191, 8192, 2047, 2048,
              T - 1, 17, 17, 17, 4096]
    site[:len(forced)] = forced
    site = rng.permutation(site)
    return dict(
        valid=(rng.random(S) < 0.85).reshape(C, L, PMAX),
        nRef=rng.integers(0, 5000, S).astype(np.int32).reshape(C, L, PMAX),
        inj_pos=site.astype(np.int32).reshape(C, L, PMAX),
        step_end=rng.integers(-3, T + 4, S).astype(np.int32).reshape(
            C, L, PMAX),
        refpfx=rng.integers(0, 1000, S).astype(np.int32).reshape(C, L, PMAX))


def _jax(stats, val, raw, vli, orders, T, monkeypatch):
    """The JAX package's _codeword_contribs and _bit_partials on one frame,
    as numpy: (off, widx, c0, c1, c2, refstart, bits_parts)."""
    monkeypatch.setattr(je, "_use_pallas", lambda: False)

    def run(stats, val, raw, vli, orders):
        nbits, nref, off, refstart, widx, c0, c1, c2 = je._codeword_contribs(
            stats, val, raw, vli, orders, T)
        return off, widx, c0, c1, c2, refstart, je._bit_partials(nbits, nref)

    out = jax.jit(run)({k: jnp.asarray(v) for k, v in stats.items()},
                       *(jnp.asarray(a) for a in (val, raw, vli, orders)))
    return [np.asarray(x) for x in out]


def _port(stats_list, val, raw, vli, orders, T, nwords):
    """emit._codeword_contribs on the frames (numpy stats stacked), the
    pieces as uint32, and codeword_pieces_plain's outputs beside them."""
    st = {k: torch.as_tensor(np.stack([s[k] for s in stats_list]))
          for k in stats_list[0]}
    tv, tr, tf, to = (torch.as_tensor(a) for a in (val, raw, vli, orders))
    tv, tr, tf, to = (t[:, :T] for t in (tv, tr, tf, to))
    chunks, nref, off, refstart, widx, c0, c1, c2 = emit._codeword_contribs(
        st, tv, tr, tf, to, T, nwords)
    inj = st["inj_pos"].reshape(len(stats_list), -1).clamp(0, T)
    plain = codeword.codeword_pieces_plain(tv, tr, tf, to, inj, nref, nwords)
    for a, b in zip(plain, (off, widx, c0, c1, c2, chunks)):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
    u32 = [c.numpy().view(np.uint32) for c in (c0, c1, c2)]
    return (off.numpy(), widx.numpy(), *u32, refstart.numpy(),
            emit._bit_partials(chunks, nref).numpy())


NAMES = ("off", "widx", "c0", "c1", "c2", "refstart", "bits_parts")


@pytest.mark.parametrize("T", [3 * 4096 + 100, 2048, 3 * 2048])
def test_pieces_equal_jax(monkeypatch, T):
    """One frame: every output equal to the JAX package's, the edges of
    the data present (s + k = 30, shifts 0 and 31, 0-bit raw slots)."""
    rng = np.random.default_rng(T)
    val, raw, orders, vli = _tokens(rng, 1, T)
    stats = _steps(rng, T)
    want = _jax(stats, val[0], raw[0], vli[0], orders[0], T, monkeypatch)
    got = _port([stats], val, raw, vli, orders, T, nwords=7)
    for name, g, w in zip(NAMES, got, want):
        assert g[0].shape == w.shape and g[0].dtype == w.dtype, name
        assert np.array_equal(g[0], w), name
    sh = set((got[0][0] & 31).tolist())
    assert {0, 31} <= sh
    v, s, f = val[0].astype(np.int64), orders[0].astype(np.int64), vli[0]
    k = np.where(f, np.frexp(v + (1 << s))[1] - 1 - s, 0)
    assert ((s + k == 30) & f).sum() > 10
    assert ((raw[0] == 0) & ~f).sum() > 10


def test_batch_at_row_stride_equals_jax_frame_by_frame(monkeypatch):
    """Three frames whose token rows lie at stride T + 1: frame f's
    outputs equal the JAX package's on that frame, its word indices
    offset by f * nwords."""
    T, n, nwords = 2 * 4096 + 2048, 3, 123_457
    rng = np.random.default_rng(5)
    val, raw, orders, vli = _tokens(rng, n, T, stride=T + 1)
    stats = [_steps(rng, T) for _ in range(n)]
    tv = torch.as_tensor(val)[:, :T]
    assert tv.stride(0) == T + 1
    got = _port(stats, val, raw, vli, orders, T, nwords)
    for f in range(n):
        want = _jax(stats[f], val[f, :T], raw[f, :T], vli[f, :T],
                    orders[f, :T], T, monkeypatch)
        want[1] = want[1] + f * nwords
        for name, g, w in zip(NAMES, got, want):
            assert np.array_equal(g[f], w), (f, name)


def _slot_math(val, raw, vli, orders):
    """The kernel's per-slot arithmetic in int32 and uint32, as it writes
    it (k from the bit length of v + 2^s, wrapped to int32): (nbits, lo,
    hi) as int64 arrays of uint32 values."""
    v = val.astype(np.int64)
    s = orders.astype(np.int64)
    u = (v + (1 << s)) & M32
    u = np.where(u >= 2**31, u - 2**32, u)
    lg = np.where(u < 0, 31, np.where(u == 0, -1, np.frexp(u)[1] - 1))
    k = np.maximum(lg - s, 0)
    payload = (v - ((1 << (s + k)) - (1 << s))) & M32
    lo = np.where(vli, ((1 << k) | (payload << (k + 1))) & M32, v & M32)
    hi = np.where(vli, payload >> (31 - k), 0)
    nbits = np.where(vli, 2 * k + s + 1, raw)
    return nbits, lo, hi


def _replay(val, raw, vli, orders, site, nref, nwords, threads, items,
            lanes, schedule, rng):
    """The kernel's plan in numpy, its tiles run under ``schedule``:
    "sequential" (a tile ends before the next starts), "aggregates first"
    (every tile publishes its aggregate before any look-back), "newest
    first" or "random" (any tile that can move does, chosen by ``rng``).
    Returns (off, widx, c0, c1, c2, half-tile sums of nbits)."""
    N, T = val.shape
    tile = threads * items
    per = -(-T // tile)
    nbits, lo, hi = _slot_math(val, raw, vli, orders)
    pad = per * tile - T
    nbits, lo, hi = (np.pad(a, ((0, 0), (0, pad))) for a in (nbits, lo, hi))
    outs = [np.zeros((N, T), np.int64) for _ in range(5)]
    halves = np.zeros((N, 2 * per), np.int64)

    def block(tid):
        """A tile's work before its look-back: (aggregate, each slot's
        inclusive sum within the tile)."""
        f, j = divmod(tid, per)
        t0, n = j * tile, min(tile, T - j * tile)
        x = np.arange(tile)
        # striped: slot i * threads + t is thread t's item i, stored in
        # thread x // items's row
        length = np.where(x < n, nbits[f, t0:t0 + tile], 0) & M32
        for q in range(site.shape[1]):
            p = min(max(int(site[f, q]), 0), T) - t0
            if 0 <= p < n:
                length[p] = (length[p] + int(nref[f, q])) & M32
        rows = length.reshape(threads, items)
        acc = np.cumsum(rows, axis=1) & M32
        run = acc[:, -1]
        inc = run.copy()
        w = min(lanes, threads)
        lane = np.arange(threads) % w
        d = 1
        while d < w:  # shuffle-up scan within each warp
            up = np.roll(inc, d)
            inc = np.where(lane >= d, (inc + up) & M32, inc)
            d *= 2
        wsum = inc[w - 1::w]
        wpre = np.repeat(np.concatenate([[0], np.cumsum(wsum)[:-1]]), w)
        tpre = (wpre + inc - run) & M32
        halves[f, 2 * j:2 * j + 2] = nbits[f, t0:t0 + tile].reshape(
            2, -1).sum(axis=1) * (np.arange(2) * tile // 2 < n)
        return int(wsum.sum() & M32), ((tpre[:, None] + acc) & M32).reshape(
            -1), f, j, t0, n

    AGG, INC = 1, 2
    status = [None] * (N * per)
    state = {}

    def step(tid):
        """Moves tile ``tid`` one event on; False when it has to wait."""
        st = state[tid]
        if st["phase"] == "block":
            st["agg"], st["incl"], f, j, st["t0"], st["n"] = block(tid)
            st["f"], st["j"] = f, j
            status[tid] = (INC, st["agg"]) if j == 0 else (AGG, st["agg"])
            st["excl"], st["q0"] = 0, tid - 1
            st["phase"] = "done" if j == 0 else "look"
            return True
        first = tid - st["j"]
        window = []
        for lane in range(lanes):
            q = st["q0"] - lane
            if q < first:
                window.append((INC, 0))
            elif status[q] is None:
                return False
            else:
                window.append(status[q])
        incs = [i for i, (kind, _) in enumerate(window) if kind == INC]
        stop = incs[0] if incs else lanes - 1
        st["excl"] = (st["excl"] + sum(v for _, v in window[:stop + 1])) \
            & M32
        if incs:
            status[tid] = (INC, (st["excl"] + st["agg"]) & M32)
            st["phase"] = "done"
        else:
            st["q0"] -= lanes
        return True

    started, done = 0, 0
    if not isinstance(schedule, str):  # every tile started, then by rank
        rank = {t: i for i, t in enumerate(schedule)}
        state.update((t, {"phase": "block"}) for t in range(N * per))
        started = N * per
    while done < N * per:
        live = [t for t in state if state[t]["phase"] != "done"]
        if not isinstance(schedule, str):
            pick = next(t for t in sorted(live, key=rank.get) if step(t))
        elif schedule == "sequential":
            pick = live[0] if live else None
        elif schedule == "aggregates first":
            fresh = [t for t in live if state[t]["phase"] == "block"]
            pick = (None if started < N * per else
                    fresh[0] if fresh else rng.choice(live))
        elif schedule == "newest first":
            pick = live[-1] if live and rng.random() < 0.7 else None
        else:
            pick = rng.choice(live) if live and rng.random() < 0.6 else None
        if pick is None and started < N * per:
            state[started] = {"phase": "block"}
            started += 1
            continue
        if pick is None:
            pick = live[0]
        if isinstance(schedule, str) and not step(pick):
            continue  # it waits on a predecessor
        if state[pick]["phase"] == "done":
            st = state[pick]
            done += 1
            f, t0, n = st["f"], st["t0"], st["n"]
            incl = (st["excl"] + st["incl"][:n]) & M32
            o = (incl - nbits[f, t0:t0 + n]) & M32
            oi = np.where(o >= 2**31, o - 2**32, o)
            sh = o & 31
            outs[0][f, t0:t0 + n] = oi
            outs[1][f, t0:t0 + n] = (oi >> 5) + f * nwords
            outs[2][f, t0:t0 + n] = (lo[f, t0:t0 + n] << sh) & M32
            outs[3][f, t0:t0 + n] = (((lo[f, t0:t0 + n] >> 1) >> (31 - sh))
                                     | (hi[f, t0:t0 + n] << sh)) & M32
            outs[4][f, t0:t0 + n] = (hi[f, t0:t0 + n] >> 1) >> (31 - sh)
    return outs + [halves]


def _replay_inputs(seed, n, T, S_):
    rng = np.random.default_rng(seed)
    val, raw, orders, vli = _tokens(rng, n, T)
    site = rng.integers(-3, T + 4, (n, S_))
    site[:, :4] = [0, T, T - 1, 5]
    nref = rng.integers(0, 3000, (n, S_))
    return val, raw, vli, orders, site.astype(np.int32), nref.astype(
        np.int32)


def _held(outs, inputs, nwords, half):
    val, raw, vli, orders, site, nref = inputs
    want = codeword.codeword_pieces_plain(
        *(torch.as_tensor(a) for a in (val, raw, vli, orders, site, nref)),
        nwords)
    for i in range(2):
        assert np.array_equal(outs[i], want[i].numpy().astype(np.int64))
    for i in range(2, 5):
        assert np.array_equal(outs[i], want[i].numpy().view(
            np.uint32).astype(np.int64))
    nb = _slot_math(val, raw, vli, orders)[0]
    r = (-nb.shape[1]) % half
    sums = np.pad(nb, ((0, 0), (0, r))).reshape(nb.shape[0], -1,
                                                half).sum(axis=2)
    assert np.array_equal(outs[5][:, :sums.shape[1]], sums)


@pytest.mark.parametrize("schedule", ["sequential", "aggregates first",
                                      "newest first", "random"])
def test_kernel_plan_replayed(schedule):
    """The plan at a small tile (8 threads of 4 slots, look-back windows of
    4 tiles: three frames of 37 tiles, the last one ragged) under each
    schedule, 25 random ones, equal to the plain version; the real tile
    (256 threads of 16 slots, windows of 32) once, whose half-tile sums
    are the plain version's 2048-slot chunks."""
    inputs = _replay_inputs(1, 3, 37 * 32 - 5, 40)
    for seed in range(25 if schedule == "random" else 1):
        outs = _replay(*inputs, 1000, 8, 4, 4, schedule,
                       np.random.default_rng(seed))
        _held(outs, inputs, 1000, 16)
    real = _replay_inputs(2, 2, 3 * codeword.TILE + 100, S)
    outs = _replay(*real, 99, codeword.THREADS, codeword.ITEMS, 32,
                   schedule, np.random.default_rng(7))
    _held(outs, real, 99, codeword.CHUNK)
    chunks = codeword.codeword_pieces_plain(
        *(torch.as_tensor(a) for a in real), 99)[5]
    assert np.array_equal(outs[5][:, :chunks.shape[1]], chunks.numpy())


def test_replay_takes_every_finishing_order():
    """Five tiles of one frame, all started, moved in each of the 120
    orders of rank (the first tile of the order that can move does: a
    tile whose look-back window holds an unpublished predecessor waits),
    with look-back windows of 2 tiles."""
    inputs = _replay_inputs(3, 1, 5 * 8 - 3, 6)
    for order in itertools.permutations(range(5)):
        outs = _replay(*inputs, 50, 2, 4, 2, order, None)
        _held(outs, inputs, 50, 4)


class _Record(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.shapes.append((str(func), tuple(o.shape)))
        return out


def test_contribs_run_nothing_over_the_slots_but_the_kernel(monkeypatch):
    """Around the kernel's one call, ``emit._codeword_contribs`` makes no
    tensor with a slot axis: only (N, S) step tables and chunk sums."""
    T, n = 3 * 4096, 2
    rng = np.random.default_rng(9)
    val, raw, orders, vli = _tokens(rng, n, T)
    st = [_steps(rng, T) for _ in range(n)]
    stats = {k: torch.as_tensor(np.stack([s[k] for s in st])) for k in st[0]}
    real = emit.codeword_pieces
    calls = []

    def opaque(*args):
        calls.append(args)
        with torch.utils._python_dispatch._disable_current_modes():
            return real(*args)

    monkeypatch.setattr(emit, "codeword_pieces", opaque)
    toks = [torch.as_tensor(a) for a in (val, raw, vli, orders)]
    rec = _Record()
    with rec:
        emit._codeword_contribs(stats, *toks, T, 11)
    assert len(calls) == 1
    assert rec.shapes and not [s for s in rec.shapes if T in s[1]], \
        rec.shapes


def _args():
    T = 64
    t = [torch.zeros((2, T), dtype=torch.int32) for _ in range(3)]
    return [t[0], t[1], torch.zeros((2, T), dtype=torch.bool), t[2],
            torch.zeros((2, 5), dtype=torch.int32),
            torch.zeros((2, 5), dtype=torch.int32), 100]


@pytest.mark.parametrize("bad,match", [
    (lambda a: a.__setitem__(0, a[0].long()), "tok_val"),
    (lambda a: a.__setitem__(2, a[2].to(torch.int32)), "tok_vli"),
    (lambda a: a.__setitem__(3, a[3][0]), "orders"),
    (lambda a: a.__setitem__(1, a[1][:, :32]), "differ in shape"),
    (lambda a: a.__setitem__(0, torch.zeros((64, 2), dtype=torch.int32).T),
     "unit stride"),
    (lambda a: a.__setitem__(3, torch.zeros(96, dtype=torch.int32)
                             .as_strided((2, 64), (32, 1))), "overlap"),
    (lambda a: a.__setitem__(4, torch.zeros((5, 2), dtype=torch.int32).T),
     "contiguous"),
    (lambda a: a.__setitem__(5, torch.zeros((3, 5), dtype=torch.int32)),
     "step tables"),
    (lambda a: a.__setitem__(6, 2**30), "int32 word"),
    (lambda a: a.__setitem__(4, a[4].to("meta")), "several devices"),
])
def test_wrapper_refuses_layouts(bad, match):
    """The wrapper's checks, the same on the CPU as on the card."""
    args = _args()
    bad(args)
    with pytest.raises(ValueError, match=match):
        codeword.codeword_pieces(*args)


def test_wrapper_takes_rows_at_any_stride_on_the_cpu():
    """Rows at stride T + 1 give the contiguous rows' outputs; an empty
    call gives empty outputs."""
    rng = np.random.default_rng(4)
    val, raw, orders, vli = _tokens(rng, 2, 100, stride=101)
    args = [torch.as_tensor(a) for a in (val, raw, vli, orders)]
    site = torch.as_tensor(rng.integers(0, 101, (2, 7)).astype(np.int32))
    nref = torch.as_tensor(rng.integers(0, 9, (2, 7)).astype(np.int32))
    strided = codeword.codeword_pieces(*(a[:, :100] for a in args), site,
                                       nref, 10)
    dense = codeword.codeword_pieces(*(a[:, :100].contiguous()
                                       for a in args), site, nref, 10)
    for a, b in zip(strided, dense):
        assert torch.equal(a, b)
    assert strided[5].shape == (2, 1)
    empty = codeword.codeword_pieces(*(a[:, :0] for a in args),
                                     site[:, :0], nref[:, :0], 10)
    assert [tuple(e.shape) for e in empty] == [(2, 0)] * 5 + [(2, 0)]
    assert codeword.codeword_pieces.launches == 0
