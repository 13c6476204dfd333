"""The codeword pieces (kernel 11, ``dwt_tpu_torch/ops/codeword.py``)
against the JAX package's ``_codeword_contribs`` and ``_bit_partials``.

Seeded token arrays made with numpy go through both: off, widx, the three
pieces (as uint32), each step's first refinement-bit position and the
bit partials must be equal, exactly, at the edges of the codeword
arithmetic (s + k = 30, 0-bit raw slots, bit shifts 0 and 31), of the
injections (several steps on one site, sites at 0, at and past T, at the
kernel's tile edges) and for a batch of frames whose rows lie at stride
T + 1, as the token finisher leaves them.  The kernel's plan (persistent
blocks taking tiles by ticket, the next tile's rows staged as 16-byte
windows kept inside their storages, the step table staged once a frame,
groups of 4 slots striped across the block, the warp and tile scans, the
injections, the chunk sum a tile, the decoupled look-back, the next
tile's status published during it, inclusive sums carried forward) is
replayed in numpy, block by block, under many schedules and every
interleaving of two blocks' events; the wrapper's launch plan and
scratch sizing are checked too.  On the CPU the wrapper runs its plain
version.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dwt_tpu.codec import encoder as je
from dwt_tpu_torch.codec import emit
from dwt_tpu_torch.ops import codeword, emit_tables

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
    chunks, nref, inj, off, widx, c0, c1, c2 = emit._codeword_contribs(
        st, tv, tr, tf, to, T, nwords)
    assert torch.equal(
        inj, st["inj_pos"].reshape(len(stats_list), -1).clamp(0, T))
    plain = codeword.codeword_pieces_plain(tv, tr, tf, to, inj, nref, nwords)
    # the first refinement bits: the plain version of kernel 17's
    refstart = emit_tables.refstart_plain(off, nref, inj, st["step_end"],
                                          st["refpfx"])
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


class _Memory:
    """Byte storages at addresses, as the kernel sees the card's memory:
    a read that leaves every storage fails."""

    SPACING = 1 << 24

    def __init__(self):
        self.spans = []

    def place(self, data: np.ndarray, origin: int = 0, lead: int = 0):
        """``data``'s bytes after ``lead`` bytes, in a storage that starts
        ``origin`` bytes past a 16-byte word: (address of the data, first
        and past-the-last byte of the storage)."""
        lo = self.SPACING * (len(self.spans) + 1) + origin
        raw = np.concatenate([np.full(lead, 0xEE, np.uint8),
                              np.ascontiguousarray(data).view(
                                  np.uint8).reshape(-1)])
        self.spans.append((lo, raw))
        return lo + lead, lo, lo + raw.size

    def read(self, addr: int, n: int) -> np.ndarray:
        for lo, raw in self.spans:
            if lo <= addr and addr + n <= lo + raw.size:
                return raw[addr - lo:addr - lo + n]
        raise AssertionError(f"{n} bytes at {addr:#x} outside every storage")


def _layout(mem, val, raw, vli, orders, site, nref, origins=(0,) * 6,
            leads=(0,) * 6):
    """The kernel's view of the inputs laid out in ``mem`` (``origins``
    and ``leads`` in the order val, raw, ord, flags, site, nref): the
    token rows (val, raw, ord, flags) as (address, row stride, storage
    first byte, past-the-last byte), the step tables as (address, first,
    past)."""
    arrays = [val, raw, orders, vli.astype(np.uint8), site, nref]
    placed = [mem.place(a, o, l) for a, o, l in zip(arrays, origins, leads)]
    rows = [(p[0], a.shape[1], p[1], p[2])
            for p, a in zip(placed[:4], arrays[:4])]
    return rows, placed[4:]


AGG, INC = 1, 2


class _Kernel:
    """codeword_kernel's plan (csrc/codeword.cu) in numpy, block by block:
    ``blocks`` persistent blocks of ``threads`` threads, tiles of ``tile``
    slots taken by ticket, warps (and look-back windows) of ``lanes``.  A
    block holds its current tile and the next one, whose ticket it took
    once the tile before had looked back: the next tile's rows are staged
    (as the 16-byte windows of its rows kept inside their storages, plain
    bytes outside them) at the top of the turn, its frame's step table
    (only at a frame change) once the current tile's injections are in,
    and its status is published, from its staged rows and table, while
    the current tile looks back.  A block moves one event at a time
    (events that touch nothing another block reads go with the next one
    that does): "start" (its first ticket staged, its next ticket taken,
    then its first "top"), then each turn: "top" (the next tile staged,
    the current tile's injections, pass 1, the scans, the tile's status
    unless published early), in any order "look" (one look-back window;
    it waits while a status nearer than the window's nearest inclusive
    one is not published) and "early" (the next tile's status), and
    "store" (the ticket of the tile after the next, the inclusive sum
    carried forward, pass 2, then the next "top", or the exit, where the
    last block clears the scratch).  Every status published is checked
    against the frame's true sums.
    """

    def __init__(self, mem, rows, tabs, N, T, S, nwords, threads, tile,
                 lanes, blocks, rng, truth):
        self.mem, self.rows, self.tabs = mem, rows, tabs
        self.N, self.T, self.S, self.nwords = N, T, S, nwords
        self.threads, self.tile, self.lanes = threads, tile, lanes
        self.groups = tile // 4
        self.rounds = self.groups // threads
        assert self.rounds * threads == self.groups and threads % lanes == 0
        self.wrow, self.frow = 4 * tile + 32, tile + 48
        self.trow = (4 * S + 24 + 15) & ~15
        self.per = -(-T // tile)
        self.tiles = N * self.per
        self.agg_true, self.inc_true = truth
        self.ctr = [0, 0]
        self.status = [None] * self.tiles
        self.outs = [np.full((N, T), -1, np.int64) for _ in range(5)]
        self.writes = np.zeros((N, T), np.int64)
        self.chunks = np.full((N, self.per), -1, np.int64)
        self.waits = 0  # look-backs that waited on a predecessor
        self.waits_holding = 0  # ... while their block held a later ticket
        self.blocks = []
        for _ in range(blocks):
            stale = lambda k: rng.integers(0, 256, k, dtype=np.uint8)
            self.blocks.append(dict(
                phase="start", it=0, tile=[None, None], pending=None,
                head=[[0] * 4, [0] * 4], tab_head=[0, 0], tab_frame=-1,
                stg=[[stale(self.wrow) for _ in range(3)]
                     + [stale(self.frow)] for _ in range(2)],
                tab=[stale(self.trow), stale(self.trow)], tab_tag=None,
                early=[False, False], inj=np.zeros(tile, np.int64),
                frames=[], reloads=0))

    # -- statuses -----------------------------------------------------------
    def _set(self, q, kind, value):
        """Publishes tile q's status: an aggregate only over nothing, an
        inclusive sum over nothing, its aggregate or the same sum; each
        equal to the frame's true sums."""
        old = self.status[q]
        if kind == AGG:
            assert old is None and value == self.agg_true[q]
        else:
            assert value == self.inc_true[q]
            assert old is None or old[0] == AGG or old == (INC, value)
        self.status[q] = (kind, value)

    # -- staging (warp 0) ---------------------------------------------------
    def _stage_row(self, dst, s, n, lo, hi):
        e, base = s + n, s & ~15
        lo16, hi16 = (lo + 15) & ~15, hi & ~15
        a, b = max(base, lo16), min((e + 15) & ~15, hi16)
        if b <= a:
            a = b = s
        if b > a:  # the bulk copy: whole 16-byte words of the storage
            assert a % 16 == 0 and (b - a) % 16 == 0 and b - base <= dst.size
            dst[a - base:b - base] = self.mem.read(a, b - a)
        for p in list(range(s, min(e, a))) + list(range(max(b, s), e)):
            dst[p - base] = self.mem.read(p, 1)[0]
        return s - base

    def _stage_rows(self, bk, tk, st):
        f, j = divmod(tk, self.per)
        t0 = j * self.tile
        n = min(self.tile, self.T - t0)
        for r, (addr, row, lo, hi) in enumerate(self.rows):
            es = 4 if r < 3 else 1
            bk["head"][st][r] = self._stage_row(
                bk["stg"][st][r], addr + (f * row + t0) * es, n * es, lo, hi)
        bk["tile"][st] = tk

    def _stage_table(self, bk, f, table):
        if table and self.S > 0:
            for r, (addr, lo, hi) in enumerate(self.tabs):
                bk["tab_head"][r] = self._stage_row(
                    bk["tab"][r], addr + f * self.S * 4, self.S * 4, lo, hi)
            bk["tab_tag"] = f
            bk["reloads"] += 1

    def _take(self):
        self.ctr[0] += 1
        return self.ctr[0] - 1

    # -- a tile's slots, read back from the stage ---------------------------
    def _group4(self, row, head):
        w = row.view("<i4").astype(np.int64)
        g4 = 4 * np.arange(self.groups)[:, None] + np.arange(4)
        a = w[g4]
        if head == 0:
            return a
        return np.concatenate([a, w[g4 + 4]], axis=1)[:, head // 4:
                                                      head // 4 + 4]

    def _flags4(self, row, head):
        u = row.view("<u4").astype(np.uint64)
        g = (head >> 2) + np.arange(self.groups)
        x = u[g]
        if head & 3:
            x = ((u[g + 1] << np.uint64(32) | x) >> np.uint64(
                8 * (head & 3))) & np.uint64(M32)
        return (x[:, None] >> np.uint64(8) * np.arange(4, dtype=np.uint64)
                & np.uint64(0xFF)) != 0

    def _slots(self, bk, st, n):
        """(nbits, lo, hi) of the tile's groups, (groups, 4); slots at or
        past n as 0-bit raw tokens."""
        stg, hd = bk["stg"][st], bk["head"][st]
        v, r, s = (self._group4(stg[i], hd[i]) for i in range(3))
        fl = self._flags4(stg[3], hd[3])
        live = 4 * np.arange(self.groups)[:, None] + np.arange(4) < n
        v, r, s = (np.where(live, a, 0) for a in (v, r, s))
        return _slot_math(v, r, fl & live, s)

    def _sites(self, bk, t0, n):
        """The staged table's sites in [t0, t0 + n): (slots, bit counts)."""
        ts = bk["tab"][0].view("<i4")[bk["tab_head"][0] // 4:][:self.S]
        tn = bk["tab"][1].view("<i4")[bk["tab_head"][1] // 4:][:self.S]
        p = np.clip(ts.astype(np.int64), 0, self.T) - t0
        hit = (p >= 0) & (p < n)
        return p[hit], tn[hit].astype(np.int64)

    # -- events -------------------------------------------------------------
    def _where(self, bk, ahead=0):
        st = (bk["it"] + ahead) & 1
        tk = bk["tile"][st]
        f, j = divmod(tk, self.per)
        return st, tk, f, j, j * self.tile, min(self.tile,
                                                self.T - j * self.tile)

    def _window(self, bk):
        """The statuses of the current look-back window up to its nearest
        inclusive one (the whole window when it has none), or the first
        tile nearer than that one whose status is not published."""
        _, tk, _, j, _, _ = self._where(bk)
        first = tk - j
        out = []
        for d in range(self.lanes):
            q = bk["q0"] - d
            if q < first:
                return out + [(INC, 0)]  # before the frame: an inclusive 0
            if self.status[q] is None:
                return q
            out.append(self.status[q])
            if self.status[q][0] == INC:
                return out
        return out

    def actions(self, b) -> list:
        """The events block ``b`` can take now: none while it waits (its
        look-back on a predecessor, with its next tile's status out)."""
        bk = self.blocks[b]
        if bk["phase"] == "gone":
            return []
        if bk["phase"] != "tail":
            return [bk["phase"]]
        out = ["early"] if bk["early_due"] else []
        if bk["look"]:
            if isinstance(self._window(bk), int):
                self.waits += 1
                self.waits_holding += bk["tile"][(bk["it"] + 1) & 1] \
                    < self.tiles
            else:
                out.append("look")
        return out

    def act(self, b, name) -> None:
        bk = self.blocks[b]
        getattr(self, "_" + name)(bk)
        if bk["phase"] == "tail" and not bk["look"] and not bk["early_due"]:
            bk["phase"] = "store"

    def _start(self, bk):
        tk = self._take()
        bk["tile"][0] = tk
        if tk < self.tiles:
            bk["tab_frame"] = tk // self.per
            self._stage_rows(bk, tk, 0)
            self._stage_table(bk, bk["tab_frame"], True)
        bk["pending"] = self._take()
        self._top(bk)

    def _top(self, bk):  # with pass 1 and the status
        st = bk["it"] & 1
        if bk["tile"][st] >= self.tiles:
            self._exit(bk)
            return
        nxt = bk["pending"]
        bk["tile"][st ^ 1] = nxt
        if nxt < self.tiles:
            self._stage_rows(bk, nxt, st ^ 1)
        st, tk, f, j, t0, n = self._where(bk)
        assert not bk["inj"].any()  # the last store pass cleared them
        assert bk["tab_tag"] == (f if self.S else None)  # the frame's table
        p, bits = self._sites(bk, t0, n)
        np.add.at(bk["inj"], p, bits)
        bk["inj"] &= M32
        bk["frames"].append(f)
        if nxt < self.tiles:  # the next frame's table, the injections in
            nf = nxt // self.per
            self._stage_table(bk, nf, nf != bk["tab_frame"])
            bk["tab_frame"] = nf
        self._publish(bk)

    def _publish(self, bk):
        st, tk, f, j, t0, n = self._where(bk)
        nb, _, _ = self._slots(bk, st, n)
        inj = bk["inj"].reshape(-1, 4)
        part = (nb + inj).sum(axis=1) & M32
        self.chunks[f, j] = nb.sum() & M32
        T_, w = self.threads, self.lanes
        lane = np.arange(T_) % w
        pre, agg = np.zeros(self.groups, np.int64), 0
        for i in range(self.rounds):  # a shuffle scan a round
            p = part[i * T_:(i + 1) * T_]
            inc, d = p.copy(), 1
            while d < w:
                inc = np.where(lane >= d, (inc + np.roll(inc, d)) & M32, inc)
                d *= 2
            wsum = inc[w - 1::w]
            below = np.repeat(np.concatenate([[0], np.cumsum(wsum)[:-1]]), w)
            pre[i * T_:(i + 1) * T_] = (agg + below + inc - p) & M32
            agg = (agg + int(wsum.sum())) & M32
        bk["pre"], bk["agg"], bk["excl"] = pre, agg, 0
        if not bk["early"][st]:
            self._set(tk, INC if j == 0 else AGG, agg)
        bk["q0"] = tk - 1
        bk["look"] = j > 0
        bk["early_due"] = bk["tile"][st ^ 1] < self.tiles
        bk["early"][st ^ 1] = bk["early_due"]
        bk["phase"] = "tail" if bk["look"] or bk["early_due"] else "store"

    def _early(self, bk):
        """The next tile's status, from its staged rows and table."""
        st, tk, f, j, t0, n = self._where(bk, 1)
        assert bk["tab_tag"] == (f if self.S else None)
        nb, _, _ = self._slots(bk, st, n)
        agg = (int(nb.sum()) + int(self._sites(bk, t0, n)[1].sum())) & M32
        self._set(tk, INC if j == 0 else AGG, agg)
        bk["early_due"] = False

    def _look(self, bk):
        window = self._window(bk)
        bk["excl"] = (bk["excl"] + sum(v for _, v in window)) & M32
        if window[-1][0] == INC:
            tk = self._where(bk)[1]
            self._set(tk, INC, (bk["excl"] + bk["agg"]) & M32)
            bk["look"] = False
        else:
            bk["q0"] -= self.lanes

    def _store(self, bk):
        st, tk, f, j, t0, n = self._where(bk)
        bk["pending"] = self._take()  # once the look-back is done
        incl = (bk["excl"] + bk["agg"]) & M32
        run = []  # the inclusive sum carried forward
        for q in range(tk + 1, min(tk + 1 + self.lanes, tk - j + self.per)):
            if self.status[q] is None or self.status[q][0] != AGG:
                break
            run.append(q)
        for q in run:
            incl = (incl + self.status[q][1]) & M32
            self._set(q, INC, incl)
        nb, lo, hi = self._slots(bk, st, n)
        inj = bk["inj"].reshape(-1, 4)
        run = (bk["excl"] + bk["pre"]) & M32
        for c in range(4):
            x = 4 * np.arange(self.groups) + c
            o = (run + inj[:, c]) & M32
            run = (o + nb[:, c]) & M32
            live = x < n
            oi = np.where(o >= 2**31, o - 2**32, o)[live]
            sh, xs = (o & 31)[live], t0 + x[live]
            l, h = lo[live, c], hi[live, c]
            self.outs[0][f, xs] = oi
            self.outs[1][f, xs] = (oi >> 5) + f * self.nwords
            self.outs[2][f, xs] = (l << sh) & M32
            self.outs[3][f, xs] = (((l >> 1) >> (31 - sh)) | (h << sh)) & M32
            self.outs[4][f, xs] = (h >> 1) >> (31 - sh)
            self.writes[f, xs] += 1
        bk["inj"][:] = 0
        bk["it"] += 1
        self._top(bk)

    def _exit(self, bk):
        self.ctr[1] += 1
        if self.ctr[1] == len(self.blocks):  # the last block clears
            assert all(s is not None and s[0] == INC for s in self.status)
            self.status = [None] * self.tiles
            self.ctr = [0, 0]
        bk["phase"] = "gone"

    def done(self) -> bool:
        return all(bk["phase"] == "gone" for bk in self.blocks)


def _events(kernel):
    return [(b, a) for b in range(len(kernel.blocks))
            for a in kernel.actions(b)]


def _replay(kernel, schedule, rng=None):
    """Moves ``kernel``'s blocks to the end: "sequential" (the lowest
    block that can move, its first event), "newest first" (the highest,
    its last event), "random" (any event, by ``rng``), or a tuple of block
    ranks (the first block in it that can move).  Fails if no block can
    move before the end (a deadlock)."""
    while not kernel.done():
        events = _events(kernel)
        assert events, "no block can move"
        if schedule == "sequential":
            ev = events[0]
        elif schedule == "newest first":
            ev = events[-1]
        elif schedule == "random":
            ev = events[rng.integers(len(events))]
        else:
            ev = next(e for b in schedule for e in events if e[0] == b)
        kernel.act(*ev)
    return kernel


def _inputs(seed, n, T, S_, strides=(0, 0, 0, 0)):
    """Seeded token rows (val, raw, flags, orders at their row strides,
    T when 0) and (n, S_) step tables, sites anywhere in [-3, T + 3]."""
    rng = np.random.default_rng(seed)
    W = max(strides) or T
    val, raw, orders, vli = _tokens(rng, n, T, stride=W)
    rows = [a[:, :(s or T)].copy() for a, s in zip(
        (val, raw, vli, orders), strides)]
    site = rng.integers(-3, T + 4, (n, S_))
    site[:, :min(4, S_)] = [0, T, T - 1, 5][:min(4, S_)]
    nref = rng.integers(0, 3000, (n, S_))
    return rows + [site.astype(np.int32), nref.astype(np.int32)]


def _truth(inputs, T, tile):
    """Each tile's true aggregate (its lengths and injected bits) and
    inclusive sum within its frame, mod 2^32, flat in ticket order."""
    val, raw, vli, orders, site, nref = (a[:, :T] if i < 4 else a
                                         for i, a in enumerate(inputs))
    n = val.shape[0]
    bits = np.zeros((n, T + 1), np.int64)
    np.add.at(bits, (np.arange(n)[:, None], np.clip(site, 0, T)), nref)
    bits = bits[:, :T] + _slot_math(val, raw, vli, orders)[0]
    r = (-T) % tile
    agg = np.pad(bits, ((0, 0), (0, r))).reshape(n, -1, tile).sum(axis=2)
    return ((agg & M32).reshape(-1).tolist(),
            (np.cumsum(agg, axis=1) & M32).reshape(-1).tolist())


def _kernel(inputs, T, nwords, threads, tile, lanes, blocks, seed=0,
            origins=(0,) * 6, leads=(0,) * 6):
    val, raw, vli, orders, site, nref = inputs
    mem = _Memory()
    rows, tabs = _layout(mem, val, raw, vli, orders, site, nref, origins,
                         leads)
    return _Kernel(mem, rows, tabs, val.shape[0], T, site.shape[1], nwords,
                   threads, tile, lanes, blocks, np.random.default_rng(seed),
                   _truth(inputs, T, tile))


def _want(inputs, T, nwords, tile):
    """The plain version's five outputs (the pieces as uint32 values) and
    the sums of the lengths over each ``tile`` slots."""
    val, raw, vli, orders, site, nref = (a[:, :T] if i < 4 else a
                                         for i, a in enumerate(inputs))
    want = codeword.codeword_pieces_plain(
        *(torch.as_tensor(np.ascontiguousarray(a))
          for a in (val, raw, vli, orders, site, nref)), nwords)
    outs = [w.numpy().astype(np.int64) for w in want[:2]] + [
        w.numpy().view(np.uint32).astype(np.int64) for w in want[2:5]]
    nb = _slot_math(val, raw, vli, orders)[0]
    r = (-T) % tile
    return outs, np.pad(nb, ((0, 0), (0, r))).reshape(
        nb.shape[0], -1, tile).sum(axis=2)


def _held(kernel, inputs, T, nwords, want=None):
    """The replayed outputs equal the plain version's, each slot written
    once, the chunk sums (a tile's) those of the lengths, the scratch
    clear, each block's step table staged once for each frame it took
    tiles of, its tiles in increasing order."""
    outs, sums = want or _want(inputs, T, nwords, kernel.tile)
    for got, w in zip(kernel.outs, outs):
        assert np.array_equal(got, w)
    assert (kernel.writes == 1).all()
    assert np.array_equal(kernel.chunks, sums)
    assert kernel.ctr == [0, 0] and kernel.status == [None] * kernel.tiles
    for bk in kernel.blocks:
        fr = bk["frames"]
        assert fr == sorted(fr)
        assert bk["reloads"] == (len(set(fr)) if kernel.S else 0)


@pytest.mark.parametrize("schedule", ["sequential", "newest first",
                                      "random", (2, 0, 1)])
def test_kernel_plan_replayed(schedule):
    """The plan at a small tile (4 threads of 2 groups of 4 slots, warps
    and look-back windows of 1, 2 and 4 lanes: three persistent blocks
    over three frames of 37 tiles at row strides T + 1 and T + 3, the
    last tile ragged) under each schedule, 10 random ones, equal to the
    plain version, every status published equal to the frame's true
    sums; the real plan (256 threads, tiles of 2,048 slots, warps of 32,
    3 blocks, 783 steps) once, over two frames of 20 tiles at stride
    T + 1."""
    T, nwords = 37 * 32 - 5, 1000
    inputs = _inputs(1, 3, T, 40, strides=(T + 1, T + 1, T + 3, T + 1))
    for seed in range(10 if schedule == "random" else 1):
        for lanes in (1, 2, 4):
            k = _replay(_kernel(inputs, T, nwords, 4, 32, lanes, 3, seed),
                        schedule, np.random.default_rng(seed))
            _held(k, inputs, T, nwords)
    T = 20 * codeword.TILE - 17
    real = _inputs(2, 2, T, S, strides=(T + 1,) * 4)
    k = _replay(_kernel(real, T, 99, codeword.THREADS, codeword.TILE, 32,
                        3), "sequential" if isinstance(schedule, tuple)
                else schedule, np.random.default_rng(7))
    _held(k, real, T, 99)
    chunks = codeword.codeword_pieces_plain(
        *(torch.as_tensor(np.ascontiguousarray(a[:, :T] if i < 4 else a))
          for i, a in enumerate(real)), 99)[5]
    assert np.array_equal(k.chunks, chunks.numpy())


@pytest.mark.parametrize("d", range(16))
def test_staged_windows_at_every_alignment(d):
    """Rows that start at every residue mod 16 (the int32 rows at strides
    T + d mod 4, the flags at T + d, storages that start off a 16-byte
    word or after a lead, step tables of S = 5 + d entries): each staged
    window is whole 16-byte words inside its storage (a read outside
    fails), the bytes outside them come plain, and the outputs equal the
    plain version's.  At d = 0 every storage ends where its last row
    does, inside a 16-byte word."""
    T, n = 91, 5
    strides = (T + d % 4, T + (d + 1) % 4, T + d, T + (d + 2) % 4)
    inputs = _inputs(100 + d, n, T, 5 + d, strides=strides)
    # (val, raw, ord, flags, site, nref): int32 storages start 4-aligned
    origins = (4 * (d % 4), 0, 4 * ((d + 1) % 4), d, 4 * (d % 4), 0)
    leads = (0, 4 * (d % 3), 0, 0, 0, 4 * (d % 2))
    k = _replay(_kernel(inputs, T, 321, 4, 32, 2, 3, d, origins, leads),
                "random", np.random.default_rng(d))
    _held(k, inputs, T, 321)


@pytest.mark.parametrize("schedule,blocks", [("sequential", 2),
                                             ("random", 8)])
def test_step_table_staged_once_a_frame(schedule, blocks):
    """Persistent blocks over nine frames of three tiles (32, 32 and 6
    slots): a block stages a frame's step table with its first tile of
    the frame and never again for it (counted in ``_held``); with two
    blocks, the first takes most tiles, three a table; with no step at
    all, no table is staged."""
    T, nwords = 70, 50
    inputs = _inputs(4, 9, T, 11, strides=(T + 1,) * 4)
    k = _replay(_kernel(inputs, T, nwords, 4, 32, 2, blocks), schedule,
                np.random.default_rng(3))
    _held(k, inputs, T, nwords)
    if blocks == 2:
        assert sum(bk["reloads"] for bk in k.blocks) < k.tiles
    none = inputs[:4] + [a[:, :0].copy() for a in inputs[4:]]
    k = _replay(_kernel(none, T, nwords, 4, 32, 2, blocks), schedule,
                np.random.default_rng(4))
    _held(k, none, T, nwords)


def _explore(kernel, leaves):
    """Every interleaving of the blocks' events from ``kernel``'s state:
    each state where no block can move before the end fails."""
    while not kernel.done():
        events = _events(kernel)
        assert events, "no block can move"
        for ev in events[1:]:
            other = copy.deepcopy(kernel, {id(kernel.mem): kernel.mem})
            other.act(*ev)
            _explore(other, leaves)
        kernel.act(*events[0])
    leaves.append(kernel)


@pytest.mark.parametrize("n,T", [(1, 60), (2, 30)])
def test_replay_takes_every_finishing_order(n, T):
    """Two persistent blocks over one frame of four tiles or two frames of
    two, look-back windows of one tile: every interleaving of their
    events (tickets, stagings, scans, look-backs, the next tiles' early
    statuses, the inclusive sums carried forward, stores, exits) ends
    with the plain version's outputs and a clear scratch, never with no
    block able to move, every status published equal to the frame's true
    sums; in the one frame, some look-backs wait on a predecessor while
    their block holds its next ticket."""
    nwords = 40
    inputs = _inputs(6, n, T, 3, strides=(T + 1,) * 4)
    want = _want(inputs, T, nwords, 16)
    leaves = []
    _explore(_kernel(inputs, T, nwords, 2, 16, 1, 2), leaves)
    assert len(leaves) > 100
    for k in leaves:
        _held(k, inputs, T, nwords, want)
    assert any(k.waits_holding for k in leaves) == (n == 1)


def test_launch_plan_and_scratch(monkeypatch):
    """The wrapper's arithmetic: a tile a 2,048 slots of a frame, no more
    persistent blocks than tiles or than the card holds; three blocks of
    the kernel's shared memory fit an H100 SM (228 KB, 1 KB reserved a
    block, the static part under 1 KB) at every step count of up to 3
    channels and 15 levels; the scratch holds a status a tile of every
    call within 2^31 slots, is made zeroed, kept, and made again, larger,
    only for a call of more tiles."""
    from dwt_tpu_torch.ops.plane_stats import PMAX

    assert codeword.launch_plan(1, 31_457_280, 132, 3) == (15_360, 396)
    assert codeword.launch_plan(7, 7_864_320, 132, 3) == (26_880, 396)
    assert codeword.launch_plan(2, 5, 132, 3) == (2, 2)
    assert codeword.launch_plan(1000, 8192, 132, 2) == (4000, 264)
    with pytest.raises(ValueError, match="fits"):
        codeword.launch_plan(1, 100, 132, 0)
    for S_ in range(0, 3 * 15 * PMAX + 1, 7):
        assert 3 * (codeword.smem_bytes(S_) + 2048) <= 228 * 1024, S_
        assert codeword.table_row(S_) >= 4 * S_ + 24
        assert codeword.table_row(S_) % 16 == 0
    assert codeword.smem_bytes(783) == 68_064
    assert codeword.MAX_TILES * codeword.TILE == 2**31
    monkeypatch.setattr(codeword, "_scratch", {})
    x = torch.zeros(1)
    buf, cap = codeword._scratch_for(x, 0, 10)
    assert cap == codeword.MAX_TILES and buf.numel() == 16 + 8 * cap
    assert not buf.any()
    assert codeword._scratch_for(x, 0, cap)[0] is buf
    monkeypatch.setattr(codeword, "MAX_TILES", 4)
    monkeypatch.setattr(codeword, "_scratch", {})
    small, cap = codeword._scratch_for(x, 0, 3)
    assert cap == 4 and codeword._scratch_for(x, 0, 4)[0] is small
    big, cap = codeword._scratch_for(x, 0, 9)
    assert cap == 9 and big.numel() == 16 + 72 and big is not small
    assert codeword._scratch_for(x, 1, 2)[0] is not big  # another stream


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
