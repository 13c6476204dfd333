"""The pack kernel's tile decomposition, held on the CPU (its CUDA code
runs only on the card: tests/test_torch_card.py, chip_smoke.py).

``csrc/pack.cu`` gives each block a tile of consecutive tokens, merges a
thread's tokens in registers, accumulates in a shared-memory window that
starts at the tile's first word (pieces past it go to global atomics),
stores the words strictly inside the tile's edges plainly and adds the
edge words atomically; each thread checks the order of its tokens and the
one before.  ``_tiled_pack`` below replays that with the kernel's sizes or
small ones, and asserts on the way that no word a tile stores is touched
by any other tile (so the stores cannot race the atomics).  It must equal
``pack_words_plain``.  Exact.
"""

from collections import defaultdict

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

KERNEL_SIZES = (256, 8, 4096)  # threads, tokens a thread, window words


def _tiled_pack(widx, c0, c1, c2, nwords, threads, items, win):
    """Returns (words as uint32, order flag)."""
    n, tile = widx.shape[0], threads * items
    words = np.zeros(max(nwords, 0), np.uint64)
    stored, added = {}, defaultdict(set)
    flag, clash = 0, False
    for t0 in range(0, n, tile):
        t1, tid = min(t0 + tile, n), t0 // tile
        wfirst, wlast = int(widx[t0]), int(widx[t1 - 1])
        nwin = max(0, min(win, wlast + 3 - wfirst))
        window = np.zeros(nwin, np.uint64)

        def put(wd, v):
            if v == 0 or wd < 0 or wd >= nwords:
                return
            if 0 <= wd - wfirst < nwin:
                window[wd - wfirst] += v
            else:
                words[wd] += v
                added[wd].add(tid)

        for i0 in range(t0, t1, items):  # one thread each
            prev = int(widx[i0 - 1]) if i0 > 0 else None
            cur, acc = None, None
            for i in range(i0, min(i0 + items, t1)):
                wk = int(widx[i])
                if prev is not None and wk < prev:
                    flag = 1
                prev = wk
                if wk < 0 or wk >= nwords:
                    continue
                p = [int(c0[i]), int(c1[i]), int(c2[i])]
                if cur is not None and 0 <= wk - cur <= 2:
                    d = wk - cur
                    for k in range(d):
                        put(cur + k, acc[k])
                    acc = acc[d:] + [0] * d
                    acc = [a + b for a, b in zip(acc, p)]
                else:
                    if cur is not None:
                        for k in range(3):
                            put(cur + k, acc[k])
                    acc = p
                cur = wk
            if cur is not None:
                for k in range(3):
                    put(cur + k, acc[k])
        for i in range(nwin):
            wd = wfirst + i
            if wd < 0 or wd >= nwords:
                continue
            if wfirst + 3 <= wd < wlast:
                clash |= wd in stored or bool(added[wd])
                stored[wd] = tid
                words[wd] = window[i]
            elif window[i]:
                words[wd] += window[i]
                added[wd].add(tid)
    if not flag:  # no other tile touches a stored word
        assert not clash
        assert not any(added[wd] - {t} for wd, t in stored.items())
    return (words & 0xFFFFFFFF).astype(np.uint32), flag


def _tokens(rng, n, jump_every=0, jump=0, start=0, step_max=3):
    steps = rng.integers(0, step_max + 1, n)
    if jump_every:
        steps[rng.random(n) < 1 / jump_every] += jump
    widx = start + np.cumsum(steps) - steps[0]
    cs = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
          for _ in range(3)]
    cs[2][rng.random(n) < 0.7] = 0
    return widx.astype(np.int32), cs


def _plain(widx, cs, nwords):
    from dwt_tpu_torch.ops import pack

    got = pack.pack_words_plain(
        *(torch.as_tensor(a.view(np.int32)) for a in (widx, *cs)), nwords)
    return got.numpy().view(np.uint32)


CASES = {  # name: (n, tokens kwargs, nwords as a function of widx[-1])
    "jumps past the window": (20000, dict(jump_every=3000, jump=100_000),
                              lambda last: last + 3),
    "all on one word": (9000, dict(step_max=0, start=7), lambda last: 20),
    "one token": (1, dict(start=5), lambda last: 9),
    "nwords below the last word": (9000, {}, lambda last: last - 50),
    "nwords 27 times the words": (9000, {}, lambda last: 27 * (last + 3)),
    "negative words first": (9000, dict(start=-300), lambda last: last + 3),
}


@pytest.mark.parametrize("sizes", [(8, 4, 16), (4, 8, 7), KERNEL_SIZES])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_pack_equals_plain(case, sizes):
    threads, items, win = sizes
    n, kw, nw = CASES[case]
    rng = np.random.default_rng(len(case))
    widx, cs = _tokens(rng, n, **kw)
    nwords = nw(int(widx[-1]))
    got, flag = _tiled_pack(widx, *cs, nwords, threads, items, win)
    assert flag == 0
    assert np.array_equal(got, _plain(widx, cs, nwords))


@pytest.mark.parametrize("n", [-1, 0, 1])
def test_tiled_pack_at_a_tile_boundary(n):
    """A tile of the kernel's size, one token fewer and one more."""
    threads, items, win = KERNEL_SIZES
    n += threads * items
    rng = np.random.default_rng(n)
    widx, cs = _tokens(rng, n, jump_every=500, jump=40)
    nwords = int(widx[-1]) + 3
    got, flag = _tiled_pack(widx, *cs, nwords, threads, items, win)
    assert flag == 0
    assert np.array_equal(got, _plain(widx, cs, nwords))


@pytest.mark.parametrize("at", [1, 4, 5, 16, 17, 40])
def test_tiled_pack_flags_a_decrease(at):
    """A step back inside a thread's tokens, at a thread's first token or
    at a tile's first token sets the flag."""
    widx = np.arange(64, dtype=np.int32)
    widx[at] = widx[at - 1] - 1
    c = np.ones(64, np.uint32)
    _, flag = _tiled_pack(widx, c, c, c, 80, 4, 4, 16)
    assert flag == 1


def test_order_flag_is_left_to_the_caller():
    """With ``order_flag`` the wrapper sets the flag instead of raising,
    and :func:`check_order` raises on it; a nondecreasing widx leaves it
    at 0."""
    from dwt_tpu_torch.ops import pack

    c = torch.ones(4, dtype=torch.int32)
    flag = torch.zeros(1, dtype=torch.int32)
    got = pack.pack_words(torch.tensor([0, 1, 1, 3], dtype=torch.int32),
                          c, c, c, 8, order_flag=flag)
    assert got.tolist() == [1, 3, 3, 3, 1, 1, 0, 0] and int(flag) == 0
    pack.check_order(flag)
    pack.pack_words(torch.tensor([0, 2, 1, 3], dtype=torch.int32), c, c, c,
                    8, order_flag=flag)
    assert int(flag) == 1
    with pytest.raises(ValueError, match="nondecreasing"):
        pack.check_order(flag)
