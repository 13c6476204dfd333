"""The encoder's VLI order scan (``dwt_tpu_torch/ops/vli_scan.py``) on the
CPU, where the wrapper runs its plain PyTorch version.

Held exactly, dtype included:

- ``codec/tokens.py:_vli_orders`` (one call of ``vli_orders`` on the
  token arrays) against the JAX package's
  ``dwt_tpu.codec.encoder._vli_orders``, frame by frame, and against
  ``dwt_tpu.specmodel.VliWriter``'s order read before each VLI value it
  writes (vli.h:67-84), at 1-3 frames and token counts whose plain-scan
  blocks are 128, 64 and 16 tokens;
- edge cases: no VLI token, every token a VLI value, the largest values;
- a batch of frames against each frame's own scan, and frames read in
  place at a row stride past their length;
- the plain version's scan (``_scan_plain``) on any transition
  parameters (the order clamped at 30 included) against a numpy replay
  token by token;
- the kernel's token words (``csrc/vli_scan.cu:token_word``, ``_vli_ab``
  in int32) replayed in numpy against ``tokens._vli_ab``;
- the kernel's plan (``csrc/vli_scan.cu``: tiles of rows, each row walked
  with f(0) and f(30) two to a 32-bit word by Hopper's DPX max until they
  meet, the 31-order map of a row that never collapses, the tile's
  aggregate, a decoupled look-back over tiles that finish in a random
  order, the replay of each row's first chunks) in numpy, at the
  kernel's sizes and at small ones.  The CUDA code itself runs only on
  the card (``tests/test_torch_card.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "dwt_tpu_torch" / "csrc"
# (tokens a block, padded_T): 20, 37 and 83 blocks of a frame.
BLOCKS = ((128, 128 * 20), (64, 64 * 37), (16, 16 * 83))


def _tokens(rng, n, padded_T, kind="mixed"):
    """(n, padded_T) int32 VLI values and bool flags."""
    if kind == "largest":
        val = rng.integers(2**30, 2**31, (n, padded_T))
    else:
        val = rng.integers(0, 2**20, (n, padded_T)) \
            >> rng.integers(0, 20, (n, padded_T))
    vli = {"mixed": rng.random((n, padded_T)) < 0.6,
           "inactive": np.zeros((n, padded_T), bool)}.get(
               kind, np.ones((n, padded_T), bool))
    return val.astype(np.int32), vli


def _specmodel_orders(val, vli):
    """Each token's order before it: the reference writer's state, read
    before each VLI value it writes (a frame starts at order 0)."""
    from dwt_tpu import specmodel

    out = np.zeros(val.shape, np.int32)
    for f in range(val.shape[0]):
        w = specmodel.VliWriter(specmodel.BitWriter())
        for i in range(val.shape[1]):
            out[f, i] = w.order
            if vli[f, i]:
                w.put(int(val[f, i]))
    return out


def _port_orders(val, vli, padded_T):
    from dwt_tpu_torch.codec import tokens

    got = tokens._vli_orders(torch.from_numpy(val), torch.from_numpy(vli),
                             padded_T)
    assert got.dtype == torch.int32 and got.shape == val.shape
    return got.numpy()


def _jax_orders(val, vli, padded_T):
    import jax.numpy as jnp

    from dwt_tpu.codec import encoder as je

    return np.stack([np.asarray(je._vli_orders(
        jnp.asarray(v), jnp.asarray(f), padded_T)).astype(np.int32)
        for v, f in zip(val, vli)])


@pytest.mark.parametrize("tb,padded_T", BLOCKS)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_orders_equal_jax_and_specmodel(n, tb, padded_T):
    from dwt_tpu_torch.codec import tokens

    TB = tokens.VLI_BLOCK
    while padded_T % TB:
        TB //= 2
    assert TB == tb
    val, vli = _tokens(np.random.default_rng(n * padded_T), n, padded_T)
    got = _port_orders(val, vli, padded_T)
    assert np.array_equal(got, _jax_orders(val, vli, padded_T))
    assert np.array_equal(got, _specmodel_orders(val, vli))
    assert got.max() > 3


@pytest.mark.parametrize("kind", ["inactive", "active", "largest"])
@pytest.mark.parametrize("n", [1, 3])
def test_orders_at_the_edges(n, kind):
    """No VLI token (every order 0), every token a VLI value, and values
    of 2^30 and more (orders up to 29, the most an int32 value reaches)."""
    tb, padded_T = BLOCKS[1]
    val, vli = _tokens(np.random.default_rng(7), n, padded_T, kind)
    got = _port_orders(val, vli, padded_T)
    assert np.array_equal(got, _jax_orders(val, vli, padded_T))
    assert np.array_equal(got, _specmodel_orders(val, vli))
    if kind == "inactive":
        assert not got.any()
    if kind == "largest":
        assert got.max() == 29


@pytest.mark.parametrize("tb,padded_T", BLOCKS)
def test_batch_orders_equal_single_frames(tb, padded_T):
    """Three frames in one scan: each frame's orders equal its own scan's
    (no state carries from one frame to the next)."""
    val, vli = _tokens(np.random.default_rng(tb), 3, padded_T)
    got = _port_orders(val, vli, padded_T)
    for f in range(3):
        one = _port_orders(val[f:f + 1], vli[f:f + 1], padded_T)
        assert np.array_equal(got[f:f + 1], one)


def _replay(x, nblk):
    """Numpy, token by token: frame f's tokens are columns f * nblk ...
    of the (TB, R) parameters, each column's TB tokens in order."""
    TB, R = x.shape
    n = R // nblk
    xs = x.reshape(TB, n, nblk).astype(np.int64)
    out = np.zeros((TB, n, nblk), np.int8)
    s = np.zeros(n, np.int64)
    for i in range(nblk):
        for t in range(TB):
            out[t, :, i] = s
            v = xs[t, :, i]
            a, b = (v - 1) & 31, ((v - 1) >> 5) & 31
            ns = np.clip(np.maximum(s, a + (s >= b)) - 2, 0, 30)
            s = np.where(v > 0, ns, s)
    return out.reshape(TB, R)


def _params(rng, tb, r, kind):
    """(tb, r) int32 transition parameters: every (a, b) pair, 0, and
    values outside [0, 1024] (kind "any"), or ones that hold the order at
    30 (a = 31, b = 0)."""
    if kind == "saturating":
        x = np.where(rng.random((tb, r)) < 0.8, 32, 0)
    else:
        x = rng.integers(-3, 1026, (tb, r))
        x[rng.random((tb, r)) < 0.01] = 2**31 - 1
    return x.astype(np.int32)


@pytest.mark.parametrize("kind", ["any", "saturating"])
@pytest.mark.parametrize("tb,nblk,n", [(128, 5, 1), (64, 7, 3), (16, 19, 2),
                                       (1, 33, 2)])
def test_plain_equals_token_replay(tb, nblk, n, kind):
    """The plain version's scan over transposed blocks of parameters."""
    from dwt_tpu_torch.ops import vli_scan

    x = _params(np.random.default_rng(tb + nblk), tb, n * nblk, kind)
    got = vli_scan._scan_plain(torch.from_numpy(x), nblk)
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert np.array_equal(got.numpy(), _replay(x, nblk))
    if kind == "saturating":
        assert got.max() == 30




# --- the kernel's token words: _vli_ab in int32, replayed ------------------

def _const(name):
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / "vli_scan.cu").read_text())
    return int(m.group(1))


VLI_BIT = 1 << 11   # csrc/vli_scan.cu: VLI
IDENT = 32 << 5     # csrc/vli_scan.cu: IDENT


def _ilog2(x):
    """Floor log2 of int64 x >= 1 (31 - __clz for an int32)."""
    x = np.asarray(x, np.int64)
    r = np.zeros(x.shape, np.int64)
    for s in (16, 8, 4, 2, 1):
        m = x >= (1 << s)
        r += np.where(m, s, 0)
        x = np.where(m, x >> s, x)
    return r


def _token_words(val, vli):
    """``token_word``: A | B << 5 | VLI for a VLI token, IDENT for another,
    with the int32 wrap of (2 << A) - v (2 << 30 is -2^31)."""
    v = np.asarray(val, np.int64)
    a = np.where(v >= 1, _ilog2(np.maximum(v, 1)), 0)
    rem = ((2 << a) - v) & 0xFFFFFFFF
    rem = np.where(rem >= 2**31, rem - 2**32, rem)
    b = np.where(rem <= 1, 0, 32 - (31 - _ilog2(np.maximum(rem - 1, 1))))
    return np.where(vli, a | b << 5 | VLI_BIT, IDENT)


def _words_of_params(x):
    """The kernel's words for +1-biased parameters (``_scan_plain``'s)."""
    x = np.asarray(x, np.int64)
    p = x - 1
    return np.where(x > 0, (p & 31) | ((p >> 5) & 31) << 5 | VLI_BIT, IDENT)


@pytest.mark.parametrize("kind", ["small", "edges", "any"])
def test_token_words_equal_vli_ab(kind):
    """The kernel's words carry ``tokens._vli_ab``'s (A, B) on every int32
    value up to 2^31 - 1, negatives and the A = 30 wrap included."""
    from dwt_tpu_torch.codec import tokens

    rng = np.random.default_rng(5)
    if kind == "small":
        val = np.arange(-70, 5000)
    elif kind == "edges":
        k = np.arange(31)
        val = np.concatenate([2**k - 1, 2**k, 2**k + 1, 3 << k[:29],
                              [2**31 - 1, 2**31 - 2, -1, -2**31]])
    else:
        val = rng.integers(-2**31, 2**31, 200_000)
    val = val.astype(np.int64).clip(-2**31, 2**31 - 1).astype(np.int32)
    vli = rng.random(val.shape) < 0.7
    want = tokens._vli_ab(torch.from_numpy(val), torch.from_numpy(vli))
    w = _token_words(val, vli)
    got = np.where(vli, (w & 1023) + 1, 0)
    assert np.array_equal(got, want.numpy())
    assert (w[vli] & 31).max() <= 30 and (w[vli] >> 5 & 63).max() <= 31


# --- the kernel's plan, replayed --------------------------------------------

def _halves(w):
    """uint32 words -> their (low, high) 16-bit halves, as int64."""
    w = np.asarray(w, np.int64)
    return w & 0xFFFF, w >> 16


def vimax3_u16x2(a, b, c):
    """Hopper's DPX max of three, on each 16-bit half of uint32 words."""
    (a0, a1), (b0, b1), (c0, c1) = _halves(a), _halves(b), _halves(c)
    lo = np.maximum(np.maximum(a0, b0), c0)
    hi = np.maximum(np.maximum(a1, b1), c1)
    return lo | hi << 16


def _step(m, w2):
    """``step``: one token (its word in both halves of w2) on two orders a
    32-bit word."""
    aa = w2 & 0x001F001F
    bb = (w2 >> 5) & 0x003F003F
    dd = (w2 >> 10) & 0x00020002
    ge = ((((m | 0x80008000) - bb) & 0xFFFFFFFF) >> 15) & 0x00010001
    return (vimax3_u16x2(m, aa + ge, dd) - dd) & 0xFFFFFFFF


def _both(w):
    return w | w << 16  # lo2 / hi2: a 16-bit word in both halves


def _through(gmask, maps, s, lo, hi):
    for q in range(lo, hi):
        if gmask[q]:
            s = int(maps[q][s])
    return s


def _kernel_plan(words, threads, span, chunk, rng, schedule="random"):
    """``vli_orders_kernel`` in numpy on (N, T) token words, with
    ``threads`` rows of ``span`` tokens a tile and ``chunk`` tokens a
    shared word.  The tiles' walks end and their look-backs step in an
    order drawn from ``rng`` (any order the card may give): at random
    ("random"), every walk first ("walks first"), or one tile after
    another in ticket order ("in order")."""
    N, T = words.shape
    tile = threads * span
    per = -(-T // tile)
    nt = N * per
    W = np.full((nt, tile), IDENT, np.int64)
    for f in range(N):
        for j in range(per):
            seg = words[f, j * tile:(j + 1) * tile]
            W[f * per + j, :len(seg)] = seg
    W = W.reshape(nt, threads, span)
    # 2. the walk with f(0) and f(30)
    m = np.full((nt, threads), 30 << 16, np.int64)
    known = np.zeros((nt, threads), np.int64)
    orders = np.full((nt, threads, span), -1, np.int64)
    anyv = np.zeros((nt, threads), bool)
    for c in range(span // chunk):
        fixed = (m & 0xFFFF) == (m >> 16)
        known = np.where(fixed, known, c + 1)
        for i in range(c * chunk, (c + 1) * chunk):
            orders[..., i] = np.where(fixed, m & 0xFFFF, orders[..., i])
            m = _step(m, _both(W[..., i]))
            anyv |= (W[..., i] & VLI_BIT) > 0
    const = (m & 0xFFFF) == (m >> 16)
    cval = m & 0xFFFF
    general = ~const & anyv
    mm = np.tile(0x00010000 + 0x00020002 * np.arange(16), (nt, threads, 1))
    for i in range(span):
        mm = _step(mm, _both(W[..., i])[..., None])
    maps = np.zeros((nt, threads, 32), np.int64)
    maps[..., 0::2], maps[..., 1::2] = mm & 0xFF, (mm >> 16) & 0xFF
    # 3. each tile's aggregate F and first status, then the look-back
    F, status, H, q, e, inclusive = {}, {}, {}, {}, {}, {}
    for g in range(nt):
        cs = np.flatnonzero(const[g])
        L = int(cs[-1]) if len(cs) else -1
        F[g] = np.array([_through(general[g], maps[g],
                                  int(cval[g, L]) if L >= 0 else s,
                                  L + 1, threads) for s in range(32)])
        inclusive[g] = g % per == 0 or F[g][0] == F[g][30]
    walking, looking = set(range(nt)), set()
    while walking or looking:
        pool = sorted(walking or looking) if schedule == "walks first" \
            else sorted(walking | looking)
        g = pool[0] if schedule == "in order" else int(rng.choice(pool))
        if g in walking:  # the walk ends: the first status
            walking.remove(g)
            looking.add(g)
            ident = np.array_equal(F[g], np.arange(32))
            status[g] = ("INC", F[g][0]) if inclusive[g] else (
                ("ID", None) if ident else ("MAP", F[g]))
            H[g], q[g] = np.arange(32), g - 1
            continue
        if g % per == 0:  # the frame's first tile enters in order 0
            e[g] = 0
        elif q[g] not in status:
            continue  # the predecessor has not published yet: spin
        else:
            kind, v = status[q[g]]
            if kind == "INC":
                e[g] = int(H[g][v])
            else:
                if kind == "MAP":
                    H[g] = H[g][v]
                q[g] -= 1
                continue
        looking.remove(g)
        if not inclusive[g]:
            status[g] = ("INC", F[g][e[g]])
    # 4. each row's entry and the replay of its first chunks
    s = np.zeros((nt, threads), np.int64)
    for g in range(nt):
        for t in range(threads):
            cs = np.flatnonzero(const[g, :t])
            if len(cs):
                p = int(cs[-1])
                s[g, t] = _through(general[g], maps[g], int(cval[g, p]),
                                   p + 1, t)
            else:
                s[g, t] = _through(general[g], maps[g], e[g], 0, t)
    m = s * 0x00010001
    for i in range(span):
        todo = i < known * chunk
        orders[..., i] = np.where(todo, m & 0xFFFF, orders[..., i])
        m = np.where(todo, _step(m, _both(W[..., i])), m)
    assert (orders >= 0).all() and (orders <= 30).all()
    # 5. out: a tile's first n tokens
    flat = orders.reshape(N, per * tile)
    return flat[:, :T].astype(np.int32)


def _frame_replay(x):
    """Numpy, token by token, frame by frame: (N, T) +1-biased parameters
    -> orders."""
    x = np.asarray(x, np.int64)
    out = np.zeros(x.shape, np.int32)
    s = np.zeros(x.shape[0], np.int64)
    for i in range(x.shape[1]):
        out[:, i] = s
        v = x[:, i]
        a, b = (v - 1) & 31, ((v - 1) >> 5) & 31
        s = np.where(v > 0, np.clip(np.maximum(s, a + (s >= b)) - 2, 0, 30),
                     s)
    return out


@pytest.mark.parametrize("sizes", ["kernel", "small"])
@pytest.mark.parametrize("kind,n,tiles", [
    ("mixed", 2, 2.5), ("any", 3, 2.25), ("saturating", 2, 3),
    ("inactive", 2, 1.5), ("largest", 1, 2.75), ("sparse", 3, 4.5)])
def test_kernel_plan_equals_plain(kind, n, tiles, sizes):
    """The kernel's plan at its THREADS, SPAN and CHUNK (tiles of 16,384
    tokens) and at 4 rows of 16 tokens, on frames of a ragged number of
    tiles: encoder-like tokens, any parameters, parameters that hold the
    order at 30, no VLI token (identity tiles), values of 2^30 and more,
    and VLI tokens so sparse that rows and tiles rarely collapse (their
    31-order maps, composed in the look-back)."""
    from dwt_tpu_torch.ops import vli_scan

    threads, span, chunk = (_const("THREADS"), _const("SPAN"),
                            _const("CHUNK")) if sizes == "kernel" \
        else (4, 16, 8)
    assert (threads, span) == (vli_scan.THREADS, vli_scan.SPAN) \
        or sizes == "small"
    T = int(tiles * threads * span) + 4
    rng = np.random.default_rng(T + n)
    if kind in ("any", "saturating"):
        x = _params(rng, n, T, kind)
        words, want = _words_of_params(x), _frame_replay(x)
    else:
        val, vli = _tokens(rng, n, T, "largest" if kind == "largest"
                           else "inactive" if kind == "inactive"
                           else "mixed")
        if kind == "sparse":
            vli &= rng.random(vli.shape) < 0.02
        words = _token_words(val, vli)
        want = vli_scan.vli_orders_plain(torch.from_numpy(val),
                                         torch.from_numpy(vli)).numpy()
    got = _kernel_plan(words, threads, span, chunk, rng)
    assert np.array_equal(got, want)
    if kind == "saturating":
        assert got.max() == 30


@pytest.mark.parametrize("schedule", ["random", "walks first", "in order"])
def test_look_back_in_any_order(schedule):
    """Tiles whose maps rarely collapse (a VLI token in a hundred), many
    a frame: the look-back composes chains of predecessors' maps (every
    walk first: each tile's down to its frame's first), and the orders do
    not depend on the order in which tiles finish."""
    from dwt_tpu_torch.ops import vli_scan

    rng = np.random.default_rng(9)
    val, vli = _tokens(rng, 3, 40 * 64 + 24)
    vli &= rng.random(vli.shape) < 0.01
    want = vli_scan.vli_orders_plain(torch.from_numpy(val),
                                     torch.from_numpy(vli)).numpy()
    got = _kernel_plan(_token_words(val, vli), 4, 16, 8, rng, schedule)
    assert np.array_equal(got, want) and got.max() > 3


def test_orders_read_in_place():
    """Frames whose rows lie at a stride past their length (the token
    finisher keeps a spare slot after each) are read as they lie, and
    give the orders of contiguous copies."""
    from dwt_tpu_torch.codec import tokens
    from dwt_tpu_torch.ops import vli_scan

    val, vli = _tokens(np.random.default_rng(4), 3, 2049)
    v, f = torch.from_numpy(val), torch.from_numpy(vli)
    got = tokens._vli_orders(v[:, :2048], f[:, :2048], 2048)
    assert v[:, :2048].stride(0) == 2049
    want = vli_scan.vli_orders_plain(v[:, :2048].contiguous(),
                                     f[:, :2048].contiguous())
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert np.array_equal(got.numpy(), _specmodel_orders(val[:, :2048],
                                                         vli[:, :2048]))


def test_wrapper_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; it refuses what the kernel does not take."""
    from dwt_tpu_torch.ops import vli_scan

    assert vli_scan.TILE == _const("THREADS") * _const("SPAN")
    val, vli = _tokens(np.random.default_rng(1), 2, 100)
    v, f = torch.from_numpy(val), torch.from_numpy(vli)
    before = vli_scan.vli_orders.launches
    got = vli_scan.vli_orders(v, f)
    assert vli_scan.vli_orders.launches == before
    assert torch.equal(got, vli_scan.vli_orders_plain(v, f))
    with pytest.raises(ValueError, match="int32"):
        vli_scan.vli_orders(v.long(), f)
    with pytest.raises(ValueError, match="bool"):
        vli_scan.vli_orders(v, f.to(torch.uint8))
    with pytest.raises(ValueError, match="2-D"):
        vli_scan.vli_orders(v.reshape(-1), f.reshape(-1))
    with pytest.raises(ValueError, match="shape"):
        vli_scan.vli_orders(v[:, :50], f)
    with pytest.raises(ValueError, match="unit stride"):
        vli_scan.vli_orders(v.T.contiguous().T, f.T.contiguous().T)
    with pytest.raises(ValueError, match="device"):
        vli_scan.vli_orders(torch.zeros((2, 4), dtype=torch.int32,
                                        device="meta"),
                            torch.zeros((2, 4), dtype=torch.bool,
                                        device="meta"))


def test_kernel_names_hold_no_other():
    """The benchmark finds a kernel's profiler events by a substring of
    its name, so no kernel of ``csrc/`` may have another's name in its
    own."""
    names = set()
    for src in CSRC.glob("*.cu"):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(\w+)", src.read_text()))
    assert {"vli_orders_kernel", "transpose_kernel"} <= names
    for a in names:
        assert not [b for b in names if a != b and a in b], a
