"""The decoder's inverse transform (kernel 16, ``csrc/lifting_inv.cu``) on
the CPU: its plain version against the JAX package, and a numpy replay of
the kernel's launch plan against the plain version.

* ``inverse_transform_plain`` (the inverse lifting, then the inverse
  colour with its clamps, the clamp to [0, 255] and the uint8 cast) equals
  the JAX package's decoder tail arithmetic, ``dwt_tpu.ops.lifting.
  dwt2d_inv``, ``dwt_tpu.ops.color.ycocg_to_rgb``, ``jnp.clip`` and the
  cast, jitted, frame by frame: even and odd sizes, grey and RGB, one and
  three frames, coefficients beyond +-255 so that every clamp acts; the
  root-only chain equals ``_tail_fn``'s root route; the int32 route and
  ``dwt2d_inv`` equal JAX's ``dwt2d_inv``.
* ``unlift_plan`` replays the launches of ``inverse_transform``
  (``unlift_plan``): ``inverse_level_kernel`` (warp strips of column
  pairs with their halo lanes, the row undone with the neighbours' values
  through the shuffles, bands of row pairs walked down with a window that
  looks one pair ahead after a prologue that reads the detail row above,
  the two ping-pong LL buffers, the colour, clamps and cast at the finest
  level) with strips and bands small enough that each test image spans
  several and a ragged edge, and ``inverse_tail_kernel`` (the root band and
  the tail levels' details loaded to their lattices, each level undone in
  place on the lattice of stride 2^(t-k)), with a tail that reaches the
  finest level, one that does not, and none at all.  Values never loaded
  are a sentinel, so a read of one shows.

Every comparison is exact: dtype, shape and every value.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SENTINEL = 1 << 40  # a value no replay may read


def _coeffs(rng, n, h, w, c, lim=700):
    return rng.integers(-lim, lim, (n, h, w, c)).astype(np.int32)


def _jax_tail(coeff, colour, to_bytes, root_only=False):
    """The JAX package's tail arithmetic on each (h, w, c) frame."""
    import jax
    import jax.numpy as jnp

    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu.ops import color as jc
    from dwt_tpu.ops import lifting as jl

    n, h, w, c = coeff.shape

    def one(x):
        if root_only:
            x = jl.cdf53_inv(jl.cdf53_inv(x, axis=0), axis=1)
        else:
            x = jl.dwt2d_inv(x, compute_pyramid(w, h))
        if colour:
            x = jc.ycocg_to_rgb(x)
        return jnp.clip(x, 0, 255).astype(jnp.uint8) if to_bytes else x

    f = jax.jit(one)
    return np.stack([np.asarray(f(jnp.asarray(x))) for x in coeff])


TAIL_CASES = [
    # (w, h, c, n)
    (8, 8, 3, 1),
    (9, 8, 1, 3),
    (17, 9, 3, 3),
    (37, 23, 1, 1),
    (70, 50, 3, 1),
    (64, 48, 1, 3),
    (49, 70, 3, 3),
]


@pytest.mark.parametrize("w,h,c,n", TAIL_CASES)
def test_inverse_plain_equals_jax(rng, w, h, c, n):
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    co = _coeffs(rng, n, h, w, c)
    chain = lifting.pyramid_chain(compute_pyramid(w, h))
    want = _jax_tail(co, c == 3, True)
    x = torch.as_tensor(co)
    for got in (lifting.inverse_transform_plain(x, chain, c == 3, True),
                lifting.inverse_transform(x, chain, c == 3, True)):
        assert got.dtype == torch.uint8 and got.shape == (n, h, w, c)
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(x.numpy(), co)  # the input is left as it was
    # The clamps acted: values outside [0, 255] before the cast.
    raw = lifting.inverse_transform_plain(x, chain, c == 3, False).numpy()
    assert raw.min() < 0 and raw.max() > 255


@pytest.mark.parametrize("w,h,c,n", [(17, 9, 3, 3), (37, 23, 1, 1),
                                     (70, 50, 3, 1)])
def test_int32_routes_equal_jax(rng, w, h, c, n):
    """The int32 route (no cast), with and without the colour, and
    ``dwt2d_inv`` on (H, W, C) and (N, H, W, C), equal JAX's."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    co = _coeffs(rng, n, h, w, c)
    pyr = compute_pyramid(w, h)
    x = torch.as_tensor(co)
    for colour in {False, c == 3}:
        want = _jax_tail(co, colour, False)
        got = lifting.inverse_transform(x, lifting.pyramid_chain(pyr),
                                        colour, False)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    want = _jax_tail(co, False, False)
    assert np.array_equal(lifting.dwt2d_inv(x, pyr).numpy(), want)
    assert np.array_equal(lifting.dwt2d_inv(x[0], pyr).numpy(), want[0])
    assert np.array_equal(lifting.dwt2d_inv_plain(x, pyr).numpy(), want)
    assert np.array_equal(x.numpy(), co)


@pytest.mark.parametrize("w,h,gray", [(313, 263, False), (40, 24, True),
                                      (64, 9, False)])
def test_root_only_chain_equals_jax_tail(rng, w, h, gray):
    """The decoder's root-only pass (decode.c:258): the chain of the root
    size alone, through ``_Tail.batch`` and ``inverse_transform``, equals
    the JAX package's ``_tail_fn`` root route."""
    import jax.numpy as jnp

    from dwt_tpu.codec import decoder as jd
    from dwt_tpu_torch.codec import decoder
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    c = 1 if gray else 3
    pyr = compute_pyramid(w, h)
    h0, w0 = pyr.heights[0], pyr.widths[0]
    co = rng.integers(-700, 700, (c, pyr.total)).astype(np.int32)
    missing = np.zeros((c, 16), np.int32)
    want = np.asarray(jd._tail_fn(w, h, 0, c, gray)(jnp.asarray(co),
                                                      jnp.asarray(missing)))
    tail = decoder._tail(w, h, 0, c, gray, torch.device("cpu"))
    got = tail.batch(torch.as_tensor(co)[None], missing[None])
    assert got.dtype == torch.uint8 and got.shape == (1, h0, w0, c)
    assert np.array_equal(got[0].numpy(), want)
    x = torch.as_tensor(co[:, :h0 * w0].T.reshape(1, h0, w0, c).copy())
    got = lifting.inverse_transform(x, ((h0, w0),), not gray, True)
    assert np.array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("w,h,gray,n,cut", [(37, 23, False, 1, 0),
                                            (64, 48, True, 3, 0),
                                            (49, 70, False, 4, 0),
                                            (40, 40, False, 5, 1),
                                            (33, 17, True, 1, 1),
                                            (96, 80, False, 3, 2)])
def test_bias_tail_equals_jax(rng, w, h, gray, n, cut):
    """The midpoint bias inside the tail: ``_Tail.batch`` on the CPU (the
    scatter's (H, W, N, C) output as a view, the root band as a view of the
    (N, C, total) coefficients, the (N, C, 16) bias table) and
    ``inverse_transform_plain`` on those views equal the JAX package's
    ``_tail_fn`` (one frame) and ``_tail_batch_fn`` (3-5 frames), with
    planes missing on several levels, differently by frame and channel,
    zeros among the coefficients, whole and reduced (``cut`` levels
    fewer)."""
    import jax.numpy as jnp

    from dwt_tpu.codec import decoder as jd
    from dwt_tpu_torch.codec import decoder
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    c = 1 if gray else 3
    pyr = compute_pyramid(w, h)
    levels = pyr.levels - cut
    co = rng.integers(-300, 300, (n, c, pyr.total)).astype(np.int32)
    co[rng.random(co.shape) < 0.3] = 0
    missing = rng.integers(0, 7, (n, c, 16)).astype(np.int32)
    if n == 1:
        want = np.asarray(jd._tail_fn(w, h, levels, c, gray)(
            jnp.asarray(co[0]), jnp.asarray(missing[0])))[None]
    else:
        want = np.asarray(jd._tail_batch_fn(w, h, levels, c, gray)(
            jnp.asarray(co), jnp.asarray(missing)))
    tail = decoder._tail(w, h, levels, c, gray, torch.device("cpu"))
    x = torch.as_tensor(co)
    got = tail.batch(x, missing)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    view, root = tail._views(x)
    bias = tail.bias_table(missing)
    assert bias is not None and (n == 1 or not view.is_contiguous())
    got = lifting.inverse_transform_plain(view, tail.chain, not gray, True,
                                          bias, root)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(x.numpy(), co)  # the input is left as it was
    # The int32 pyramid of the sharded decoder: the same bias, eagerly.
    pyr_x = tail.pyramid(x, missing)
    assert pyr_x.is_contiguous() and torch.equal(
        lifting.inverse_transform_plain(pyr_x, tail.chain, not gray, True),
        got)


def test_unlift_levels_closed_form():
    """The launch plan at the decode paths' sizes: at 4K levels 1-4 in the
    tail (a cluster of 8 blocks a channel, 9 rows a block), then 5-9; the
    preview's 480x270 likewise, then 5 and 6; a group of 480 512x512
    tiles, interleaved: levels 1-3 in the tail (a block a frame, all
    channels), then 4-7 with 2 frames a warp, warps frame-first; the
    levels in order, each once."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    cases = {((3840, 2160), 1, False): 6, ((480, 270), 1, False): 3,
             ((512, 512), 480, True): 5, ((512, 448), 30, True): 5,
             ((16, 16), 1, False): 1, ((8, 8), 1, False): 1,
             ((15360, 8640), 1, False): 8, ((65535, 16), 1, False): 2}
    for ((w, h), n, inter), launches in cases.items():
        pyr = compute_pyramid(w, h)
        chain = lifting.pyramid_chain(pyr)
        plan = lifting.unlift_plan(chain, n, 3, True, inter)
        assert len(plan) == launches, (w, h)
        assert [l for p in plan for l in p.levels] == list(
            range(1, pyr.levels + 1))
        for p in plan[1:] if plan[0].cb else plan:
            assert p.cb == 0 and p.F == (2 if inter else 1)
    c4k = lifting.pyramid_chain(compute_pyramid(3840, 2160))
    tail = lifting.unlift_plan(c4k)[0]
    assert (tail.levels, tail.cb, tail.K, tail.R) == ((1, 2, 3, 4), 1, 8, 9)
    tile = lifting.unlift_plan(lifting.pyramid_chain(
        compute_pyramid(512, 512)), 480, 3, True, True)[0]
    assert (tile.levels, tile.cb, tile.K) == ((1, 2, 3), 3, 1)
    assert lifting.tail_block(128, 128, 480, 3)[3] <= lifting.TAIL_SMEM
    assert [p.levels for p in lifting.unlift_plan(((9, 15),))] == [(1,)]


def test_inverse_transform_checks_its_input():
    from dwt_tpu_torch.ops import lifting

    x = torch.zeros((1, 9, 15, 3), dtype=torch.int32)
    for bad in ((), ((9, 14),), ((4, 8), (9, 15)), ((1, 8), (2, 15)),
                ((5, 8),) * 17 + ((9, 15),)):
        with pytest.raises(ValueError, match="chain"):
            lifting.inverse_transform(x, bad, True, True)
    with pytest.raises(ValueError, match="3 channels"):
        lifting.inverse_transform(x[..., :1], ((5, 8), (9, 15)), True, True)
    with pytest.raises(ValueError, match="int32"):
        lifting.inverse_transform(x.long(), ((5, 8), (9, 15)), True, True)
    assert lifting.inverse_transform(x, ((5, 8), (9, 15)), True,
                                     True).shape == (1, 9, 15, 3)


# --- a numpy replay of kernel 16's plan -----------------------------------

def _tdiv(a, d):
    return np.sign(a) * (np.abs(a) // d)


def _rgb(x):
    Y = np.clip(x[..., 0], 0, 255)
    U = np.clip(x[..., 1], -255, 255)
    V = np.clip(x[..., 2], -255, 255)
    T = Y - _tdiv(V, 2)
    G = V + T
    B = T - _tdiv(U, 2)
    return np.stack([B + U, G, B], axis=-1)


def _finish(x, colour, to_bytes):
    """The finest level's values as they store: colour, then clamps."""
    if colour:
        x = _rgb(x)
    return np.clip(x, 0, 255) if to_bytes else x


def _row_unlift(v, j, w):
    """``unlift_row`` of every lane at once: v (N, S, pw, 2C), each lane's
    low samples then its high ones, j (S, pw) the lanes' pairs -> their
    output pairs (ev, od), (N, S, pw, C) each; a lane's shuffle up at lane
    0 and down at the last lane returns its own value."""
    C = v.shape[3] // 2
    s, d = v[..., :C], v[..., C:]
    we = (w + 1) // 2
    nupd = we - 1 if w % 2 else we
    jj = j[None, :, :, None]
    dl = np.concatenate([d[:, :, :1], d[:, :, :-1]], axis=2)
    dl = np.where(jj == 0, d, dl)
    ev = np.where(jj < nupd, s - _tdiv(dl + d, 4), s)
    en = np.concatenate([ev[:, :, 1:], ev[:, :, -1:]], axis=2)
    en = np.where(jj + 1 >= we, ev, en)
    return ev, d + _tdiv(ev + en, 2)


def _unlift_level(det, ll, dst, h, w, pw, bp, colour, to_bytes, bias=None,
                  blev=0):
    """One launch of inverse_level_kernel with warps of pw pair lanes a
    frame (strips of pw - 2 stored column pairs) and bands of bp row pairs:
    the level's (N, h, w, C) output from the LL quadrant ll (N, >= he, >=
    we, C) and the detail quadrants in det (any strides), the details
    pushed away from zero by bias[n, c, blev] as they load, into dst.  A
    warp's walk: the band's prologue (its even row from the pair's rows and
    the detail row above), then a pair a step, the next pair's rows loaded
    a step ahead.  Frames are independent lanes (F of them a warp on the
    card; ``test_level_warps_cover_once`` checks the warps' order)."""
    N, C = det.shape[0], det.shape[3]
    he, we, nh, nw = (h + 1) // 2, (w + 1) // 2, h // 2, w // 2
    nupd = he - 1 if h % 2 else he
    k = pw - 2
    S = -(-we // k)
    j = k * np.arange(S)[:, None] - 1 + np.arange(pw)[None, :]
    cl, chi = np.clip(j, 0, we - 1), we + np.clip(j, 0, nw - 1)
    b = (np.zeros((N, 1, 1, C), np.int64) if bias is None
         else bias[:, None, None, :, blev].astype(np.int64))

    def biased(v):
        return v + np.sign(v) * b

    def load_s(i):
        r = min(i, he - 1)
        return np.concatenate([ll[:, r, cl], biased(det[:, r, chi])], axis=3)

    def load_d(i):
        r = he + min(i, nh - 1)
        return np.concatenate([biased(det[:, r, cl]), biased(det[:, r, chi])],
                              axis=3)

    def store(row, ev, od):
        for st in range(S):
            for lane in range(1, pw - 1):
                jj = j[st, lane]
                if jj >= we:
                    continue
                dst[:, row, 2 * jj] = _finish(ev[:, st, lane], colour,
                                              to_bytes)
                if 2 * jj + 1 < w:
                    dst[:, row, 2 * jj + 1] = _finish(od[:, st, lane],
                                                      colour, to_bytes)

    unloaded = np.full((N, S, pw, 2 * C), SENTINEL, np.int64)
    for i0 in range(0, he, bp):
        i1 = min(i0 + bp, he)
        s, D = load_s(i0), load_d(i0)
        dp = load_d(i0 - 1) if i0 > 0 else D
        E = s - _tdiv(dp + D, 4) if i0 < nupd else s
        sN, dN = (load_s(i0 + 1), load_d(i0 + 1)) if i0 + 1 < he else (
            unloaded, unloaded)
        for i in range(i0, i1):
            s2, d2 = (load_s(i + 2), load_d(i + 2)) \
                if i + 1 < i1 and i + 2 < he else (unloaded, unloaded)
            if i + 1 >= he:
                EN = E
            else:
                EN = sN - _tdiv(D + dN, 4) if i + 1 < nupd else sN
            store(2 * i, *_row_unlift(E, j, w))
            if i < nh:
                store(2 * i + 1, *_row_unlift(D + _tdiv(E + EN, 2), j, w))
            E, D, sN, dN = EN, dN, s2, d2


def _entry(y, n):
    """``axis_entry``: coordinate y of the top tail level's axis (its
    levels' sizes n, coarsest first) -> (its level: 0 for the root band,
    else L - its trailing zeros; its index on that level's deinterleaved
    axis)."""
    L = len(n)
    if y == 0:
        return 0, 0
    k = max(0, L - ((y & -y).bit_length() - 1))
    own = y >> L if k == 0 else (n[k - 1] + 1) // 2 + (((y >> (L - k)) - 1)
                                                       >> 1)
    return k, own


def _index_at(y, e, k, L):
    """``index_at``: coordinate y (entry e) as an input of level k."""
    return e[1] if e[0] == k else y >> (L - k + 1)


def _tail_sources(chain):
    """For each place (y, x) of the top tail level's grid: the level k of
    the sample loaded there and its (a, b) in the coefficients, in closed
    form from the two axes' entries."""
    from dwt_tpu_torch.ops import lifting  # noqa: F401  (the caller's plan)

    L = len(chain)
    hs, ws = [a for a, _ in chain], [b for _, b in chain]
    ht, wt = chain[-1]
    ey = [_entry(y, hs) for y in range(ht)]
    ex = [_entry(x, ws) for x in range(wt)]
    K = np.maximum(np.array([e[0] for e in ey])[:, None],
                   np.array([e[0] for e in ex])[None, :])
    A = np.array([[_index_at(y, ey[y], K[y, x], L) for x in range(wt)]
                  for y in range(ht)])
    B = np.array([[_index_at(x, ex[x], K[y, x], L) for x in range(wt)]
                  for y in range(ht)])
    return K, A, B


def _unlift_tail(det, root, bias, chain, p, dst, colour, to_bytes):
    """One launch of inverse_tail_kernel with the plan's launch p: for each
    cluster (a frame's cb channels) K blocks, block r holding rows [r R, (r
    + 1) R) of the top level's grid in an (cb, R, pitch) array at skewed
    columns.  Each block loads its band's places from the root view (level
    0) or the detail view with the place's level's bias; every coefficient
    of the ht x wt corner is read exactly once.  Each level is undone in
    place on the lattice of stride 2^(t-k), columns then rows; a column
    pass reads the rows above and below from whichever block holds them
    (counted as remote reads, which only column passes make, only from the
    neighbouring bands); the row passes touch the block's own rows.  The
    band's rows of the top level into dst.  Returns the remote reads."""
    from dwt_tpu_torch.ops import lifting

    L = len(chain)
    ht, wt = chain[-1]
    N, C = det.shape[0], det.shape[3]
    cb, K, R, pitch = p.cb, p.K, p.R, p.pitch
    assert K * R >= ht  # a band a block (the last ones may be empty)
    sk = np.array([lifting.skew(x) for x in range(wt)])
    assert len(set(sk.tolist())) == wt and sk.max() < pitch
    lev, A, B = _tail_sources(chain)
    hits = np.zeros((ht, wt), int)
    np.add.at(hits, (A, B), 1)
    assert (hits == 1).all()  # the places' sources cover the corner once
    remote = 0
    for task in range(N * (C // cb)):
        n, c0 = task // (C // cb), (task % (C // cb)) * cb
        chans = slice(c0, c0 + cb)
        mem = np.full((K, cb, R, pitch), SENTINEL, np.int64)
        r0, r1 = root.shape[1] - 1, root.shape[2] - 1
        v = np.where(lev[..., None] == 0,
                     root[n][np.minimum(A, r0), np.minimum(B, r1)][..., chans],
                     det[n][A, B][..., chans]).astype(np.int64)
        if bias is not None:
            bz = np.concatenate([np.zeros((cb, 1), np.int64),
                                 bias[n, chans].astype(np.int64)], axis=1)
            v = v + np.sign(v) * bz.T[lev]
        for r in range(K):
            y0, y1 = min(r * R, ht), min(r * R + R, ht)
            mem[r][:, :y1 - y0][..., sk] = np.moveaxis(v[y0:y1], 2, 0)

        def row(y, reader=None):
            nonlocal remote
            o = y // R
            if reader is not None and o != reader:
                assert abs(o - reader) == 1
                remote += 1
            return mem[o, :, y - o * R]

        for k, (h, w) in enumerate(chain, 1):
            st = 1 << (L - k)
            cols = sk[np.arange(w) * st]
            nuh = (h + 1) // 2 - h % 2
            nuw = (w + 1) // 2 - w % 2
            for i in range(0, 2 * nuh, 2):
                me = i * st // R
                x = row(i * st)
                x[:, cols] -= _tdiv(row((i - 1 if i else i + 1) * st, me)[
                    :, cols] + row((i + 1) * st, me)[:, cols], 4)
            for i in range(1, h, 2):
                me = i * st // R
                x = row(i * st)
                x[:, cols] += _tdiv(row((i - 1) * st, me)[:, cols] + row(
                    (i + 1 if i + 1 < h else i - 1) * st, me)[:, cols], 2)
            for i in range(h):
                x = row(i * st)
                jj = np.arange(0, 2 * nuw, 2)
                left = np.where(jj >= 1, jj - 1, jj + 1)
                x[:, sk[jj * st]] -= _tdiv(x[:, sk[left * st]]
                                           + x[:, sk[(jj + 1) * st]], 4)
                jj = np.arange(1, w, 2)
                right = np.where(jj + 1 < w, jj + 1, jj - 1)
                x[:, sk[jj * st]] += _tdiv(x[:, sk[(jj - 1) * st]]
                                           + x[:, sk[right * st]], 2)
        top = np.stack([row(y)[:, sk] for y in range(ht)])  # (ht, cb, wt)
        dst[n, :, :, chans] = _finish(np.moveaxis(top, 1, 2), colour,
                                      to_bytes)
    return remote


def unlift_plan(det, chain, colour, to_bytes, pw, bp, tail_samples,
                monkeypatch, bias=None, root=None, sms=132):
    """inverse_transform's launches (``lifting.unlift_plan`` with the tail
    cap ``tail_samples``, on a card of ``sms`` SMs): the tail from the
    views, then each large level from the LL buffer the launch before wrote
    (two buffers in turn; the first large level without a tail from the
    root view), the last into the result.  Returns (the result, the plan,
    the tail's remote reads)."""
    from dwt_tpu_torch.ops import lifting

    monkeypatch.setattr(lifting, "UNLIFT_TAIL_SAMPLES", tail_samples)
    monkeypatch.setattr(lifting, "INTERLEAVED_TAIL_SAMPLES", tail_samples)
    monkeypatch.setattr(lifting, "TAIL_ROWS", 2)
    N, H, W, C = det.shape
    inter = N > 1 and det.strides[0] < det.strides[2]
    plan = lifting.unlift_plan(chain, N, C, colour or to_bytes, inter, sms)
    L = len(chain)
    root = det if root is None else root
    out = np.full((N, H, W, C), SENTINEL, np.int64)  # every slot written
    bufs = [np.full(N * chain[l - 1][0] * chain[l - 1][1] * C, SENTINEL,
                    np.int64) for l in (L - 1, L - 2)[:len(plan) - 1]]
    src, remote = root, 0
    for p in plan:
        top = p.levels[-1]
        h, w = chain[top - 1]
        last = top == L
        dst = out if last else bufs[(L - 1 - top) % 2][
            :N * h * w * C].reshape(N, h, w, C)
        if p.cb:
            remote += _unlift_tail(det, root, bias, chain[:top], p, dst,
                                   colour and last, to_bytes and last)
        else:
            _unlift_level(det, src, dst, h, w, pw, bp, colour and last,
                          to_bytes and last, bias, top - 1)
        src = dst
    return out, plan, remote


def _decoder_inputs(rng, co, h0, w0):
    """Coefficients co (N, H, W, C) as the decoder hands them over: the
    (N, H, W, C) view of an (H, W, N, C) array (0 on the root band, as the
    scatter leaves it), the root band as a view of an (N, C, total) buffer
    holding co's root band, and a bias table with planes missing on several
    levels, by frame and channel."""
    n, h, w, c = co.shape
    scat = np.ascontiguousarray(co.transpose(1, 2, 0, 3))
    scat[:h0, :w0] = 0
    lin = rng.integers(-700, 700, (n, c, h0 * w0 + 7)).astype(np.int32)
    lin[..., :h0 * w0] = co[:, :h0, :w0].transpose(0, 3, 1, 2).reshape(
        n, c, -1)
    root = lin[..., :h0 * w0].reshape(n, c, h0, w0).transpose(0, 2, 3, 1)
    missing = rng.integers(0, 7, (n, c, 16))
    bias = np.where(missing >= 2, 1 << np.clip(missing - 2, 0, 30),
                    0).astype(np.int32)
    return scat.transpose(2, 0, 1, 3), root, bias


@pytest.mark.parametrize("w,h,c,n,pw,bp,tail,colour,to_bytes", [
    (37, 23, 3, 2, 5, 2, 0, True, True),        # no tail
    (33, 17, 1, 1, 4, 1, 200, False, True),     # a tail of level 1
    (64, 48, 3, 1, 8, 5, 800, True, True),      # a tail of two, one large
    (9, 30, 3, 1, 3, 3, 0, True, True),         # one pair a strip
    (321, 239, 1, 2, 6, 8, 2000, False, False),  # the int32 route
    (70, 50, 3, 3, 7, 3, 10**6, True, True),    # the tail reaches the top
    (40, 24, 3, 2, 6, 2, 10**6, False, False),
    (70, 50, 3, 1, 7, 4, 300, True, False),     # colour without the cast
])
def test_unlift_plan_equals_plain(rng, monkeypatch, w, h, c, n, pw, bp, tail,
                                  colour, to_bytes):
    """The plan replayed on a contiguous pyramid equals the plain version:
    the tail's clusters (a few blocks a frame's channel on a card of many
    SMs, the band's rows shared with the neighbours), then the large
    levels' strips and bands."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    co = _coeffs(rng, n, h, w, c)
    pyr = compute_pyramid(w, h)
    chain = lifting.pyramid_chain(pyr)
    want = lifting.inverse_transform_plain(torch.as_tensor(co), chain,
                                           colour, to_bytes)
    got, plan, remote = unlift_plan(co, chain, colour, to_bytes, pw, bp,
                                    tail, monkeypatch)
    assert np.array_equal(got, want.numpy().astype(np.int64))
    L = pyr.levels
    big = [p.levels[0] for p in plan if not p.cb]
    assert [l for p in plan for l in p.levels] == list(range(1, L + 1))
    if tail == 10**6:
        assert len(plan) == 1 and plan[0].levels == tuple(range(1, L + 1))
    elif tail:
        assert plan[0].cb and len(plan[0].levels) >= 1 and big
    else:
        assert not plan[0].cb
    if plan[0].cb:  # a cluster, its bands read across their edges
        assert plan[0].K > 1 and remote > 0
    assert any(-(-((chain[l - 1][1] + 1) // 2) // (pw - 2)) > 1
               for l in big) or not big  # several strips a row
    assert any(chain[l - 1][1] % (2 * (pw - 2)) or chain[l - 1][0] % (2 * bp)
               for l in big) or not big  # a ragged strip or band
    assert len(big) < 3 or any(-(-((chain[l - 1][0] + 1) // 2) // bp) > 1
                               for l in big)  # several bands


@pytest.mark.parametrize("w,h,c,n,tail,sms", [
    (37, 23, 3, 3, 0, 132),        # no tail: level 1 from the root view
    (64, 48, 3, 4, 800, 132),      # interleaved: a block all channels
    (70, 50, 1, 3, 10**6, 132),    # the tail to the top, clusters
    (49, 70, 3, 5, 300, 8),        # a card of 8 SMs: one block a frame
    (33, 17, 3, 1, 200, 132),      # one frame: not interleaved
])
def test_unlift_plan_as_the_decoder_hands_it(rng, monkeypatch, w, h, c, n,
                                            tail, sms):
    """The plan replayed on the decoder's inputs (the scatter's (H, W, N,
    C) output as a view, the root band as a view of the parsed (N, C,
    total) coefficients, a bias table) equals the plain version on the
    same views and on the pyramid they stand for."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    co = _coeffs(rng, n, h, w, c)
    pyr = compute_pyramid(w, h)
    chain = lifting.pyramid_chain(pyr)
    det, root, bias = _decoder_inputs(rng, co, pyr.heights[0], pyr.widths[0])
    for colour, to_bytes in {(c == 3, True), (False, False)}:
        want = lifting.inverse_transform_plain(
            torch.as_tensor(det), chain, colour, to_bytes,
            torch.as_tensor(bias), torch.as_tensor(root))
        biased = lifting.bias_plain(torch.as_tensor(co.copy()), chain,
                                    torch.as_tensor(bias))
        assert torch.equal(want, lifting.inverse_transform_plain(
            biased, chain, colour, to_bytes))
        got, plan, _ = unlift_plan(det, chain, colour, to_bytes, 6, 2, tail,
                                   monkeypatch, bias, root, sms)
        assert np.array_equal(got, want.numpy().astype(np.int64))
        inter = n > 1
        assert all(p.F == (lifting.LANE_FRAMES if inter else 1)
                   for p in plan if not p.cb)
        if plan[0].cb:
            assert plan[0].cb == (c if inter or len(plan) == 1
                                  and (colour or to_bytes) else 1)


@pytest.mark.parametrize("w,h,c,pw,bp,tail", [
    (313, 263, 3, 6, 2, 10**6),  # a root in the tail, to the finest level
    (313, 263, 1, 5, 2, 0),      # no tail: the root band as a large level
])
def test_unlift_plan_root_only(rng, monkeypatch, w, h, c, pw, bp, tail):
    """The root-only chain through the plan: one launch, the tail's or a
    large level's reading its LL quadrant from the coefficients, given as
    the decoder gives them: a (N, h0, w0, C) view of the parsed (N, C,
    total) coefficients."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    pyr = compute_pyramid(w, h)
    chain = ((pyr.heights[0], pyr.widths[0]),)
    h0, w0 = chain[0]
    lin = rng.integers(-700, 700, (2, c, h0 * w0 + 9)).astype(np.int32)
    co = lin[..., :h0 * w0].reshape(2, c, h0, w0).transpose(0, 2, 3, 1)
    want = lifting.inverse_transform_plain(torch.as_tensor(co), chain,
                                           c == 3, True)
    got, plan, _ = unlift_plan(co, chain, c == 3, True, pw, bp, tail,
                               monkeypatch)
    assert [p.levels for p in plan] == [(1,)]
    assert np.array_equal(got, want.numpy().astype(np.int64))


@pytest.mark.parametrize("n,F,strips,bands", [(1, 1, 5, 3), (480, 2, 9, 16),
                                              (30, 2, 3, 2), (7, 1, 2, 5),
                                              (2, 2, 4, 1)])
def test_level_warps_cover_once(n, F, strips, bands):
    """inverse_level_kernel's warps (csrc: frame groups first where F > 1,
    strips first at F = 1): each (frame group, strip, band) once; at F > 1
    adjacent warps take adjacent frame groups of one strip and band, at F
    = 1 adjacent strips of one band."""
    groups = -(-n // F)
    nwarps = groups * strips * bands
    seen = []
    for gw in range(nwarps):
        sb = strips * bands
        g, t = (gw % groups, gw // groups) if F > 1 else (gw // sb, gw % sb)
        strip, band = t % strips, t // strips
        assert band < bands and g < groups
        seen.append((g, strip, band))
    assert len(set(seen)) == nwarps
    for a, b in zip(seen, seen[1:]):
        if F > 1 and a[0] + 1 < groups:
            assert b == (a[0] + 1, a[1], a[2])
        if F == 1 and a[1] + 1 < strips:
            assert b == (a[0], a[1] + 1, a[2])


def test_tail_columns_skew_banks():
    """The tail's skewed columns (``lifting.skew``): a warp's 32 lanes on
    a lattice of stride up to 32 fall on 32 banks (the unskewed stride-8
    row fell on 4)."""
    from dwt_tpu_torch.ops import lifting

    for st in (1, 2, 4, 8, 16, 32):
        for j0 in (0, 32, 96):
            banks = {lifting.skew((j0 + lane) * st) % 32
                     for lane in range(32)}
            assert len(banks) == 32, st
    assert len({(lane * 8) % 32 for lane in range(32)}) == 4
