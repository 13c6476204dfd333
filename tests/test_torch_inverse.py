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
  (``unlift_levels``): ``inverse_level_kernel`` (warp strips of column
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


def test_unlift_levels_closed_form():
    """The launch count at the decode paths' sizes: 6 at 4K (levels 1-4
    in the tail, then 5-9), 3 at the preview's 480x270 and at a 512x512
    tile; the levels in order, each once."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    for (w, h), launches in {(3840, 2160): 6, (480, 270): 3, (512, 512): 3,
                             (512, 448): 3, (16, 16): 1, (8, 8): 1,
                             (15360, 8640): 8, (65535, 16): 2}.items():
        pyr = compute_pyramid(w, h)
        chain = lifting.pyramid_chain(pyr)
        groups = lifting.unlift_levels(chain)
        assert len(groups) == launches, (w, h)
        assert [l for g in groups for l in g] == list(
            range(1, pyr.levels + 1))
        # The mirror of the forward transform's launches.
        assert groups == [g[::-1] for g in lifting.launch_levels(pyr)[::-1]]
    assert lifting.unlift_levels(
        lifting.pyramid_chain(compute_pyramid(3840, 2160)))[0] == (1, 2, 3, 4)
    assert lifting.unlift_levels(((9, 15),)) == [(1,)]


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


def _unlift_level(coeff, ll, dst, h, w, pw, bp, colour, to_bytes):
    """One launch of inverse_level_kernel with warps of pw lanes (strips of
    pw - 2 stored column pairs) and bands of bp row pairs: the level's
    (N, h, w, C) output from the LL quadrant ll (N, >= he, >= we, C) and
    the detail quadrants in coeff, into dst.  A warp's walk: the band's
    prologue (its even row from the pair's rows and the detail row above),
    then a pair a step, the next pair's rows loaded a step ahead."""
    N, C = coeff.shape[0], coeff.shape[3]
    he, we, nh, nw = (h + 1) // 2, (w + 1) // 2, h // 2, w // 2
    nupd = he - 1 if h % 2 else he
    k = pw - 2
    S = -(-we // k)
    j = k * np.arange(S)[:, None] - 1 + np.arange(pw)[None, :]
    cl, chi = np.clip(j, 0, we - 1), we + np.clip(j, 0, nw - 1)

    def load_s(i):
        r = min(i, he - 1)
        return np.concatenate([ll[:, r, cl], coeff[:, r, chi]], axis=3)

    def load_d(i):
        r = he + min(i, nh - 1)
        return np.concatenate([coeff[:, r, cl], coeff[:, r, chi]], axis=3)

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


def _axis_entry(a, n):
    """``axis_entry``: index a of the top tail level's axis (sizes n,
    coarsest first) -> its level (0 for the root band, else the first
    level whose output holds it) << 16 | its own place on the axis."""
    L = len(n)
    k = 0
    if a >= (n[0] + 1) // 2:
        k = 1
        while k < L and a >= n[k - 1]:
            k += 1
    own = a << L if k == 0 else (2 * (a - (n[k - 1] + 1) // 2) + 1) << (L - k)
    return k << 16 | own


def _place(a, e, k, L):
    """``place``: index a (entry e) as an input of level k >= its own."""
    return e & 0xFFFF if e >> 16 == k else a << (L - k + 1)


def _unlift_tail(coeff, chain, dst, colour, to_bytes):
    """One launch of inverse_tail_kernel: the coefficients' ht x wt corner
    of each frame to its places on the levels' lattices (each place once),
    each level of ``chain`` undone in place on the lattice of stride
    2^(t-k), coarsest first, the top level's output into dst.  The
    kernel's blocks hold a frame's channel, or all its channels where the
    colour needs them: the channels are independent until the colour, so
    the replay takes them all at once."""
    hs, ws = [a for a, _ in chain], [b for _, b in chain]
    ht, wt = chain[-1]
    N, C = coeff.shape[0], coeff.shape[3]
    L = len(chain)
    ea = [_axis_entry(a, hs) for a in range(ht)]
    eb = [_axis_entry(b, ws) for b in range(wt)]
    ys, xs = np.zeros((ht, wt), int), np.zeros((ht, wt), int)
    for a in range(ht):
        for b in range(wt):
            k = max(ea[a] >> 16, eb[b] >> 16)
            ys[a, b], xs[a, b] = _place(a, ea[a], k, L), _place(b, eb[b], k, L)
    hits = np.zeros((ht, wt), int)
    np.add.at(hits, (ys, xs), 1)
    assert (hits == 1).all()  # the lattices' places cover the grid once
    t = np.full((N, ht, wt, C), SENTINEL, np.int64)
    t[:, ys, xs] = coeff[:, :ht, :wt]
    for lev, (h, w) in enumerate(chain, 1):
        st = 1 << (L - lev)
        x = t[:, ::st, ::st][:, :h, :w]  # a view: the passes write into t
        nuh = (h + 1) // 2 - h % 2
        nuw = (w + 1) // 2 - w % 2
        i = np.arange(0, 2 * nuh, 2)
        up = np.where(i >= 1, i - 1, i + 1)
        x[:, i] -= _tdiv(x[:, up] + x[:, i + 1], 4)
        i = np.arange(1, h, 2)
        down = np.where(i + 1 < h, i + 1, i - 1)
        x[:, i] += _tdiv(x[:, i - 1] + x[:, down], 2)
        jj = np.arange(0, 2 * nuw, 2)
        left = np.where(jj >= 1, jj - 1, jj + 1)
        x[:, :, jj] -= _tdiv(x[:, :, left] + x[:, :, jj + 1], 4)
        jj = np.arange(1, w, 2)
        right = np.where(jj + 1 < w, jj + 1, jj - 1)
        x[:, :, jj] += _tdiv(x[:, :, jj - 1] + x[:, :, right], 2)
    dst[:] = _finish(t, colour, to_bytes)


def unlift_plan(coeff, chain, colour, to_bytes, pw, bp, tail_samples,
                monkeypatch):
    """inverse_transform's launches (``lifting.unlift_levels`` with the
    tail threshold ``tail_samples``): the tail from the coefficients, then
    each large level from the LL buffer the launch before wrote (two
    buffers in turn; the first large level without a tail from the root
    band in the coefficients), the last into the result."""
    from dwt_tpu_torch.ops import lifting

    monkeypatch.setattr(lifting, "TAIL_SAMPLES", tail_samples)
    groups = lifting.unlift_levels(chain)
    co = coeff.astype(np.int64)
    N, H, W, C = co.shape
    L = len(chain)
    out = np.full((N, H, W, C), SENTINEL, np.int64)  # every slot written
    bufs = [np.full(N * chain[l - 1][0] * chain[l - 1][1] * C, SENTINEL,
                    np.int64) for l in (L - 1, L - 2)[:len(groups) - 1]]
    src = co
    for levels in groups:
        top = levels[-1]
        h, w = chain[top - 1]
        last = top == L
        dst = out if last else bufs[(L - 1 - top) % 2][
            :N * h * w * C].reshape(N, h, w, C)
        if h * w <= tail_samples:
            _unlift_tail(co, chain[:top], dst, colour and last,
                         to_bytes and last)
        else:
            _unlift_level(co, src, dst, h, w, pw, bp, colour and last,
                          to_bytes and last)
        src = dst
    return out, groups


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
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    co = _coeffs(rng, n, h, w, c)
    pyr = compute_pyramid(w, h)
    chain = lifting.pyramid_chain(pyr)
    want = lifting.inverse_transform_plain(torch.as_tensor(co), chain,
                                           colour, to_bytes)
    got, groups = unlift_plan(co, chain, colour, to_bytes, pw, bp, tail,
                              monkeypatch)
    assert np.array_equal(got, want.numpy().astype(np.int64))
    L, big = pyr.levels, [g[0] for g in groups if len(g) == 1
                          and chain[g[0] - 1][0] * chain[g[0] - 1][1] > tail]
    t = len(groups) - len(big)
    assert [l for g in groups for l in g] == list(range(1, L + 1))
    if tail == 10**6:
        assert groups == [tuple(range(1, L + 1))]
    elif tail:
        assert t == 1 and len(groups[0]) >= 1 and big  # a tail, then more
    else:
        assert not t
    assert any(-(-((chain[l - 1][1] + 1) // 2) // (pw - 2)) > 1
               for l in big) or not big  # several strips a row
    assert any(chain[l - 1][1] % (2 * (pw - 2)) or chain[l - 1][0] % (2 * bp)
               for l in big) or not big  # a ragged strip or band
    assert len(big) < 3 or any(-(-((chain[l - 1][0] + 1) // 2) // bp) > 1
                               for l in big)  # several bands


@pytest.mark.parametrize("w,h,c,pw,bp,tail", [
    (313, 263, 3, 6, 2, 10**6),  # a root in the tail, to the finest level
    (313, 263, 1, 5, 2, 0),      # no tail: the root band as a large level
])
def test_unlift_plan_root_only(rng, monkeypatch, w, h, c, pw, bp, tail):
    """The root-only chain through the plan: one launch, the tail's or a
    large level's reading its LL quadrant from the coefficients."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    pyr = compute_pyramid(w, h)
    chain = ((pyr.heights[0], pyr.widths[0]),)
    co = _coeffs(rng, 2, *chain[0], c)
    want = lifting.inverse_transform_plain(torch.as_tensor(co), chain,
                                           c == 3, True)
    got, groups = unlift_plan(co, chain, c == 3, True, pw, bp, tail,
                              monkeypatch)
    assert groups == [(1,)]
    assert np.array_equal(got, want.numpy().astype(np.int64))
