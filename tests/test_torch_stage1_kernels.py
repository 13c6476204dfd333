"""Stage 1's kernels (``csrc/lifting.cu``, ``csrc/plane_stats.cu``) on the
CPU: their plain versions against the JAX package, and numpy replays of
each kernel's plan against the plain versions.

* The forward transform (colour and lifting, ``forward_transform_plain``)
  equals ``dwt_tpu.ops.color.rgb_to_ycocg`` with
  ``dwt_tpu.ops.lifting.dwt2d_fwd`` frame by frame: RGB and grey, one and
  three frames, uint8 and int32 frames, even and odd sizes.
* The plane statistics (``plane_stats_plain`` with ``_level_stats``, and
  ``stage1._plane_stats``) equal ``dwt_tpu.codec.encoder._plane_stats`` on
  the same planes: all five outputs, every slot, on noise, flat, sparse
  and low-plane frames.
* ``lift_plan`` replays the transform's launches (``launch_levels``):
  ``lift_level_kernel`` (warp strips of column pairs lifted along the row
  with the neighbours' values, the strip's halo pairs on its edge lanes,
  bands of row pairs walked down
  with a sliding window after a halo prologue, the deinterleaved runs,
  the two ping-pong LL buffers) with strips and bands small enough that
  each test image spans several and a ragged edge, and
  ``lift_tail_kernel`` (the levels from the tail threshold on, lifted in
  place on lattices of stride 2^k), down to a tail that holds the whole
  pyramid and to no tail at all;
  ``stats_plan`` replays ``plane_stats_kernel`` (a block a chunk, its
  units found in ``unit_chunk``; each 512-element block's cumulative
  plane counts; the last block holding each plane and its recount; the
  level-local index from the chunk's level start), on the encoder's
  tables and on a made-up chunk whose last element at a plane falls
  mid-block or on a block edge; the kernel's byte tricks are held on
  packed words.  Both must equal the plain versions.

Every comparison is exact: integer results, dtype and shape included.
"""

import numpy as np
import pytest
import torch

from imagegen import random_image

torch.set_num_threads(1)

TRANSFORM_CASES = [
    # (w, h, c, n, dtype)
    (8, 8, 3, 1, np.uint8),
    (17, 9, 1, 3, np.uint8),
    (17, 9, 3, 3, np.int32),
    (321, 239, 3, 1, np.uint8),
    (321, 239, 1, 1, np.int32),
    (448, 512, 3, 3, np.uint8),
]


def _frames(rng, w, h, c, n, dtype, kind="mixed"):
    return np.stack([random_image(rng, w, h, c, kind)
                     for _ in range(n)]).astype(dtype)


def _jax_transform(frames, c):
    import jax
    import jax.numpy as jnp

    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu.ops import color as jc
    from dwt_tpu.ops import lifting as jl

    pyr = compute_pyramid(frames.shape[2], frames.shape[1])

    def one(x):
        x = x.astype(jnp.int32)
        return jl.dwt2d_fwd(x if c == 1 else jc.rgb_to_ycocg(x), pyr)

    f = jax.jit(one)
    return np.stack([np.asarray(f(jnp.asarray(x))) for x in frames])


@pytest.mark.parametrize("w,h,c,n,dtype", TRANSFORM_CASES)
def test_transform_plain_equals_jax(rng, w, h, c, n, dtype):
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    frames = _frames(rng, w, h, c, n, dtype)
    pyr = compute_pyramid(w, h)
    want = _jax_transform(frames, c)
    x = torch.as_tensor(frames)
    for got in (lifting.forward_transform_plain(x, pyr, c == 3),
                lifting.forward_transform(x, pyr, c == 3)):
        assert got.dtype == torch.int32 and got.shape == (n, h, w, c)
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(x.numpy(), frames)  # the frames are left as they were
    if dtype == np.int32:  # dwt2d_fwd: the transform without the colour step
        grey = torch.as_tensor(frames[0, ..., :1])
        assert np.array_equal(lifting.dwt2d_fwd(grey, pyr).numpy(),
                              _jax_transform(frames[:1, ..., :1], 1)[0])


def test_transform_checks_its_input():
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    pyr = compute_pyramid(16, 8)
    with pytest.raises(ValueError, match="not"):
        lifting.forward_transform(torch.zeros((1, 9, 16, 3), dtype=torch.uint8),
                                  pyr, True)
    with pytest.raises(ValueError, match="3 channels"):
        lifting.forward_transform(torch.zeros((1, 8, 16, 1), dtype=torch.uint8),
                                  pyr, True)


# --- the plane statistics ---------------------------------------------------

def _stats_image(rng, kind, w, h, c):
    """noise / flat / sparse (a few non-zero pixels on a flat field) /
    lowplanes (small values: planes_max well below PMAX)."""
    if kind in ("noise", "flat"):
        return random_image(rng, w, h, c, kind)
    img = np.full((h, w, c), 128, np.uint8)
    if kind == "sparse":
        ys, xs = rng.integers(0, h, 12), rng.integers(0, w, 12)
        img[ys, xs] = rng.integers(0, 256, (12, c))
    else:
        img += rng.integers(0, 3, (h, w, c)).astype(np.uint8)
    return img


def _port_lin(img):
    from dwt_tpu_torch.codec import encoder, stage1

    h, w, c = img.shape
    enc = encoder.Encoder(w, h, c, device="cpu")
    lin, stats = stage1._transform_and_stats(torch.as_tensor(img)[None],
                                             enc.pyr, c, c == 1, enc._src)
    return enc.pyr, lin[0], stats


STATS_CASES = [(96, 80, 3, "noise"), (64, 64, 3, "flat"),
               (321, 239, 1, "sparse"), (128, 96, 3, "lowplanes"),
               (448, 512, 3, "noise")]


@pytest.mark.parametrize("w,h,c,kind", STATS_CASES)
def test_plane_stats_plain_equals_jax(rng, w, h, c, kind):
    import jax.numpy as jnp

    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu_torch.codec import stage1
    from dwt_tpu_torch.ops import plane_stats as ps

    img = _stats_image(rng, kind, w, h, c)
    pyr, lin, stats = _port_lin(img)
    pm = int(stats["planes_max"][0])
    if kind == "lowplanes":
        assert 0 < pm < ps.PMAX - 20
    segs = stage1.segs_for(pyr, lin.device)
    q, valid = stage1._detail_q(lin, segs)
    jsegs = je._Segs(compute_pyramid(w, h))
    want = je._plane_stats(jnp.asarray(q.numpy()), jnp.asarray(valid.numpy()),
                           jsegs, c, pyr.levels, pm)
    planes, *tables = ps.plane_stats(
        lin, segs.valid_t, segs.idx_local, segs.block_chunk,
        segs.unit_chunk_t, segs.chunk_base_t)
    assert np.array_equal(planes.numpy(), stats["planes"][0].numpy())
    for got in (stage1._plane_stats(q, valid, segs, c, pyr.levels, pm),
                stage1._level_stats(*tables, segs)):
        for name, g, w_ in zip(["nS", "nZ", "trailZ", "nS_ck", "nZ_ck"], got,
                               want):
            w_ = np.asarray(w_)
            assert g.dtype == torch.int32 and g.shape == w_.shape, name
            assert np.array_equal(g.numpy(), w_), name


def test_transform_and_stats_keeps_the_stats_of_each_frame(rng):
    """Three uint8 frames through one stage 1 give each frame's own stats
    (every key the parity tests compare)."""
    from torch_parity import STATS_KEYS

    from dwt_tpu_torch.codec import encoder, stage1

    w, h, c = 40, 24, 3
    frames = _frames(rng, w, h, c, 3, np.uint8)
    enc = encoder.Encoder(w, h, c, device="cpu")
    lin, stats = stage1._transform_and_stats(torch.as_tensor(frames), enc.pyr,
                                             c, False, enc._src)
    for i in range(3):
        lin1, one = stage1._transform_and_stats(
            torch.as_tensor(frames[i:i + 1]), enc.pyr, c, False, enc._src)
        assert torch.equal(lin[i], lin1[0])
        for k in STATS_KEYS:
            assert torch.equal(stats[k][i], one[k][0]), k


# --- numpy replays of the kernels' plans ----------------------------------

def _tdiv(a, d):
    return np.sign(a) * (np.abs(a) // d)


def _ycocg(x):
    R, G, B = x[..., 0], x[..., 1], x[..., 2]
    U = R - B
    T = B + _tdiv(U, 2)
    V = G - T
    return np.stack([T + _tdiv(V, 2), U, V], axis=-1)


def _row_lift(src, colour, r, w, pw):
    """``lift_row`` of every warp strip of row r at once: (N, S, pw, 2C)
    low-pass and detail values of each lane's column pair (lane l of strip
    s: columns c, c + 1 with c = 2 ((pw - 2) s - 1 + l), read at the
    nearest column of the row past an edge), from its own two samples and
    its neighbours' through the shuffles (the last lane's shuffle down
    and lane 0's shuffle up return their own values).  Lanes 1..pw - 2
    are right; lanes 0 and pw - 1 are the strip's halo."""
    S = -(-((w + 1) // 2) // (pw - 2))
    c = 2 * ((pw - 2) * np.arange(S)[:, None] - 1 + np.arange(pw)[None, :])

    def px(cols):
        v = src[:, r, np.clip(cols, 0, w - 1)].astype(np.int64)
        return _ycocg(v) if colour else v

    a, b = px(c), px(c + 1)
    an = np.concatenate([a[:, :, 1:], a[:, :, -1:]], axis=2)
    an = np.where((c + 2 >= w)[None, ..., None], a, an)
    d = b - _tdiv(a + an, 2)
    dl = np.concatenate([d[:, :, :1], d[:, :, :-1]], axis=2)
    dl = np.where((c == 0)[None, ..., None], d, dl)
    keep = ((w % 2 == 1) & (c == w - 1))[None, ..., None]
    s_ = np.where(keep, a, a + _tdiv(dl + d, 4))
    return np.concatenate([s_, d], axis=3)


def _put(dst, rows, col0, v, w_run, pw):
    """The warp strips' runs of one quadrant row: lane l (1..pw - 2) of
    strip s at column col0 + (pw - 2) s + l - 1, the run cut at
    ``w_run``."""
    S, k = v.shape[1], pw - 2
    for st in range(S):
        m = min(k, w_run - k * st)
        if m > 0:
            dst[:, rows, col0 + k * st:col0 + k * st + m] = v[:, st, 1:1 + m]


def _lift_level(src, colour, coeff, ll, h, w, pw, bp):
    """One launch of lift_level_kernel with warps of pw lanes (strips of
    pw - 2 stored column pairs) and bands of bp row pairs: src (N, >= h, >= w, C), coeff the (N, H, W, C)
    coefficients, ll the (N, ceil(h / 2), ceil(w / 2), C) LL destination.
    A warp's column walk: the band's halo prologue, then two rows a step
    from the sliding window (the even row, the last detail row)."""
    C = src.shape[3]
    heven, weven = (h + 1) // 2, (w + 1) // 2
    nodd = w // 2
    for i0 in range(0, heven, bp):
        e = _row_lift(src, colour, 2 * i0, w, pw)
        if i0 > 0:
            p = _row_lift(src, colour, 2 * i0 - 2, w, pw)
            q = _row_lift(src, colour, 2 * i0 - 1, w, pw)
            dp = q - _tdiv(p + e, 2)
        for i in range(i0, min(i0 + bp, heven)):
            if 2 * i + 1 < h:
                o = _row_lift(src, colour, 2 * i + 1, w, pw)
                nx = _row_lift(src, colour, 2 * i + 2, w, pw) \
                    if 2 * i + 2 < h else e
                d = o - _tdiv(e + nx, 2)
                s_ = e + _tdiv((d if i == 0 else dp) + d, 4)
                _put(coeff, heven + i, 0, d[..., :C], weven, pw)
                _put(coeff, heven + i, weven, d[..., C:], nodd, pw)
                dp, e = d, nx
            else:
                s_ = e
            _put(ll, i, 0, s_[..., :C], weven, pw)
            _put(coeff, i, weven, s_[..., C:], nodd, pw)


def _lift_tail(src, colour, coeff, h, w, nlev):
    """One launch of lift_tail_kernel: each (frame, channel) of the h x w
    input lifted in place for nlev levels, level k on the lattice of
    stride 2^k, each level's details and then the root band into
    coeff."""
    t = src[:, :h, :w].astype(np.int64)
    if colour:
        t = _ycocg(t)
    st = 1
    for _ in range(nlev):
        x = t[:, ::st, ::st][:, :h, :w]  # a view: the passes write into t
        j = np.arange(1, w, 2)
        right = np.where(j + 1 < w, j + 1, j - 1)
        x[:, :, j] -= _tdiv(x[:, :, j - 1] + x[:, :, right], 2)
        j = np.arange(0, w - (w % 2), 2)
        left = np.where(j >= 1, j - 1, j + 1)
        x[:, :, j] += _tdiv(x[:, :, left] + x[:, :, j + 1], 4)
        i = np.arange(1, h, 2)
        below = np.where(i + 1 < h, i + 1, i - 1)
        x[:, i] -= _tdiv(x[:, i - 1] + x[:, below], 2)
        i = np.arange(0, h - (h % 2), 2)
        above = np.where(i >= 1, i - 1, i + 1)
        x[:, i] += _tdiv(x[:, above] + x[:, i + 1], 4)
        he, we = (h + 1) // 2, (w + 1) // 2
        ri = np.r_[np.arange(0, h, 2), np.arange(1, h, 2)]
        ci = np.r_[np.arange(0, w, 2), np.arange(1, w, 2)]
        out = x[:, ri][:, :, ci]
        detail = np.ones((h, w), bool)
        detail[:he, :we] = False
        coeff[:, :h, :w][:, detail] = out[:, detail]
        h, w, st = he, we, 2 * st
    coeff[:, :h, :w] = t[:, ::st, ::st][:, :h, :w]


def lift_plan(frames, pyr, colour, pw, bp, tail_samples, monkeypatch):
    """forward_transform's launches (``lifting.launch_levels`` with the
    tail threshold ``tail_samples``): the large levels from the frames and
    then from the LL buffer the last one wrote (two buffers in turn), the
    fused tail from the last LL buffer (or the frames)."""
    from dwt_tpu_torch.ops import lifting

    monkeypatch.setattr(lifting, "TAIL_SAMPLES", tail_samples)
    groups = lifting.launch_levels(pyr)
    N, H, W, C = frames.shape
    coeff = np.full((N, H, W, C), -(2**31), np.int64)  # every slot written
    L = pyr.levels
    bufs = [np.zeros((N * pyr.heights[l] * pyr.widths[l] * C,), np.int64)
            for l in (L - 1, L - 2) if l >= 1]
    src = frames
    for step, levels in enumerate(groups):
        l = levels[0]
        h, w = pyr.heights[l], pyr.widths[l]
        if l <= lifting.tail_level(pyr):
            _lift_tail(src, colour and l == L, coeff, h, w, len(levels))
            continue
        hl, wl = pyr.heights[l - 1], pyr.widths[l - 1]
        if l == 1:
            ll = coeff
        else:
            ll = bufs[step % 2][:N * hl * wl * C].reshape(N, hl, wl, C)
        _lift_level(src, colour and l == L, coeff, ll, h, w, pw, bp)
        src = ll
    return coeff, groups


@pytest.mark.parametrize("w,h,c,n,pw,bp,tail", [
    (37, 23, 3, 2, 5, 2, 0),        # no tail: the last level writes coeff
    (17, 9, 1, 1, 4, 1, 100),
    (64, 48, 3, 1, 8, 5, 800),      # a large level, then a tail of two
    (9, 30, 3, 1, 3, 3, 0),         # one pair a strip
    (321, 239, 1, 2, 6, 8, 2000),   # a tail of four levels
    (40, 24, 3, 2, 6, 2, 10**6),    # the whole pyramid in the tail
])
def test_lift_plan_equals_plain(rng, monkeypatch, w, h, c, n, pw, bp, tail):
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    frames = _frames(rng, w, h, c, n, np.uint8)
    pyr = compute_pyramid(w, h)
    want = lifting.forward_transform_plain(torch.as_tensor(frames), pyr,
                                           c == 3).numpy()
    got, groups = lift_plan(frames, pyr, c == 3, pw, bp, tail, monkeypatch)
    assert np.array_equal(got, want)
    t = lifting.tail_level(pyr)
    assert len(groups) == pyr.levels - t + (1 if t else 0)
    if tail == 10**6:
        assert groups == [tuple(range(pyr.levels, 0, -1))]
    elif t:
        assert len(groups[-1]) == t and len(groups) > 1
    big = [l for (l,) in groups[:len(groups) - (1 if t else 0)]]
    assert any(-(-((pyr.widths[l] + 1) // 2) // (pw - 2)) > 1 for l in big) \
        or not big  # several strips a row
    assert any(pyr.widths[l] % (2 * (pw - 2)) or pyr.heights[l] % (2 * bp)
               for l in big) or not big  # a ragged strip or band


def test_launch_levels_closed_form():
    """The launch count of every geometry the benchmark and the tiled
    paths use, and of sizes whose coarsest level does not fit the tail."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    for (w, h), launches in {(3840, 2160): 6, (1920, 1080): 5,
                             (512, 512): 3, (512, 448): 3, (16, 16): 1,
                             (8, 8): 1, (15360, 8640): 8,
                             (65535, 16): 2}.items():
        pyr = compute_pyramid(w, h)
        groups = lifting.launch_levels(pyr)
        assert len(groups) == launches, (w, h)
        assert [l for g in groups for l in g] == list(
            range(pyr.levels, 0, -1))


def stats_plan(lin, valid, unit_chunk, chunk_base):
    """plane_stats_kernel, a block a chunk (its units counted in the window
    [chunk, 8 chunk + 8) of ``unit_chunk``, as the kernel finds them) and
    row: each 512-element block's cumulative counts #{q < p}, counted
    plane by plane up to the block's top plane and the valid count above
    it; then, for each plane, nS from the counts' differences, the last
    block holding the plane, lastS from that block's bytes and zup from
    the counts of the blocks before it and a recount of that block up to
    lastS.  Returns (planes, nS_ck, lastS_ck, z0_ck, zup_ck)."""
    from dwt_tpu_torch.ops.plane_stats import PMAX, UNIT

    R, nlin = lin.shape
    n, nchunk = valid.size, chunk_base.size
    nunits = n // UNIT
    nS = np.zeros((R, nchunk, PMAX), np.int64)
    lastS, zup = np.full_like(nS, -1), np.zeros_like(nS)
    z0, planes = np.zeros((R, nchunk), np.int64), np.zeros(R, np.int64)
    for chunk in range(nchunk):
        win = unit_chunk[chunk:min(nunits, 8 * chunk + 8)]
        before, units = (win < chunk).sum(), (win == chunk).sum()
        assert 1 <= units <= 8
        pos0, ln = (chunk + before) * UNIT, units * UNIT
        nblk, first = ln // 512, pos0 - chunk_base[chunk]
        v = valid[pos0:pos0 + ln].reshape(nblk, 512)
        for row in range(R):
            x = lin[row, nlin - n + pos0:nlin - n + pos0 + ln].astype(np.int64)
            mag = np.abs(x)
            u = np.where((mag > 0) & (mag < 2**31),
                         np.frexp(np.maximum(mag, 1))[1], 0)  # q + 1
            u = np.where(v.reshape(-1), u, 127).reshape(nblk, 512)
            top = np.where(v, u - 1, -1).max(axis=1)  # each block's
            cnt = np.stack([np.where(p <= np.minimum(top, PMAX),
                                     (u < p + 1).sum(axis=1), v.sum(axis=1))
                            for p in range(PMAX + 1)], axis=1)
            cm = top.max()
            if cm >= 0:
                planes[row] = max(planes[row], cm + 1)
            z0[row, chunk] = cnt[:, 0].sum()
            for p in range(min(cm, PMAX - 1) + 1):
                at = cnt[:, p + 1] - cnt[:, p]
                nS[row, chunk, p] = at.sum()
                if not at.any():
                    continue
                blast = np.flatnonzero(at).max()
                pos = np.flatnonzero(u[blast] == p + 1).max()
                lastS[row, chunk, p] = first + 512 * blast + pos
                zup[row, chunk, p] = (cnt[:blast, p].sum()
                                      + (u[blast, :pos + 1] < p + 1).sum())
    return planes, nS, lastS, z0, zup


def test_plane_bytes_swar():
    """The kernel's byte tricks on packed q + 1 bytes (0..31, 127 for a
    pad): ``below`` flags the bytes < p + 1, ``equal`` the bytes equal to
    v, exactly, in every byte of a 32-bit word."""
    rng = np.random.default_rng(5)
    b = rng.choice(np.r_[np.arange(32), 127], size=(4096, 4)).astype(np.uint64)
    w = (b << (8 * np.arange(4, dtype=np.uint64))).sum(axis=1)
    M, HI, ONES = 2**32 - 1, 0x80808080, 0x01010101
    for p in range(30):
        got = ~((w | HI) - (p + 1) * ONES) & HI & M
        want = ((b < p + 1) << (8 * np.arange(4, dtype=np.uint64) + 7)).sum(1)
        assert np.array_equal(got, want)
        x = w ^ ((p + 1) * ONES)
        got = ~(((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) & HI & M
        want = ((b == p + 1) << (8 * np.arange(4, dtype=np.uint64) + 7)).sum(1)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("w,h,c,kind", [(448, 512, 3, "noise"),
                                        (321, 239, 1, "sparse"),
                                        (64, 64, 3, "flat")])
def test_stats_plan_equals_plain(rng, w, h, c, kind):
    from dwt_tpu_torch.codec import stage1
    from dwt_tpu_torch.ops import plane_stats as ps

    img = _stats_image(rng, kind, w, h, c)
    pyr, lin, _ = _port_lin(img)
    segs = stage1.segs_for(pyr, lin.device)
    if kind == "noise":  # several units a chunk and several chunks a level
        assert max(segs.level_nchunk) > 1
        assert max(segs.ch_len) // ps.UNIT > 1
    # The kernel's level-local index is the plain version's.
    pos = np.arange(segs.n)
    base = segs.chunk_base_t.numpy()[np.repeat(segs.unit_chunk_t.numpy(),
                                               ps.UNIT)]
    assert np.array_equal(pos - base, segs.idx_local.numpy())
    want = ps.plane_stats_plain(lin, segs.valid_t, segs.idx_local,
                                segs.block_chunk, segs.unit_chunk_t,
                                segs.chunk_base_t)
    got = stats_plan(lin.numpy(), segs.valid_np, segs.unit_chunk_t.numpy(),
                     segs.chunk_base_t.numpy())
    for name, g, w_ in zip(["planes", "nS_ck", "lastS_ck", "z0_ck", "zup_ck"],
                           got, want):
        assert np.array_equal(g, w_.numpy()), name


@pytest.mark.parametrize("edge", ["mid", "last", "first"])
def test_stats_plan_boundary_block(rng, edge):
    """A chunk whose last element at a plane falls mid-block, on a block's
    last slot, or on the first slot of a block: two levels on a made-up
    detail axis (3 and 9 units; the second level in chunks of 8 and 1
    units), small values with pads inside each 1024-slot window, and three
    planes planted so that their last elements in chunk 1 fall there."""
    from dwt_tpu_torch.ops import plane_stats as ps

    U = ps.UNIT
    units = [3, 9]
    n = sum(units) * U
    unit_chunk = np.r_[np.zeros(3), np.ones(8), [2]].astype(np.int32)
    chunk_base = np.array([0, 3 * U, 3 * U], np.int32)
    valid = (np.arange(n) % 1024) < rng.integers(600, 1025, n // 1024
                                                 ).repeat(1024)
    R, nlin = 2, n + 8192
    lin = rng.integers(-3, 4, (R, nlin)).astype(np.int32)
    at = {"mid": 700, "last": 511, "first": 512}[edge]
    for p, off in ((20, 5 * 512 + at), (21, 9 * 512 + at), (14, at)):
        pos = 3 * U + off  # chunk 1, level-local index off
        valid[pos] = True
        lin[:, nlin - n + pos] = (1 << p) + 3
    idx_local = np.r_[np.arange(3 * U), np.arange(9 * U)].astype(np.int32)
    block_chunk = unit_chunk.repeat(U // 512).astype(np.int64)
    t = [torch.as_tensor(a) for a in (lin, valid, idx_local, block_chunk,
                                      unit_chunk, chunk_base)]
    want = ps.plane_stats_plain(*t)
    got = stats_plan(lin, valid, unit_chunk, chunk_base)
    for name, g, w_ in zip(["planes", "nS_ck", "lastS_ck", "z0_ck", "zup_ck"],
                           got, want):
        assert np.array_equal(g, w_.numpy()), name
    last = got[2][:, 1]
    assert (last[:, 20] % 512 == at % 512).all()
    assert (last[:, 21] == 9 * 512 + at).all() and (got[4][:, 1, 21] > 0).all()


@pytest.mark.parametrize("case", ["wide chunk", "empty chunk", "large E"])
def test_plane_stats_checks_its_tables(monkeypatch, case):
    """The kernel's wrapper refuses, on the host, a layout whose chunks
    cannot all hold 1 to ``CHUNK_UNITS`` units: more units than that many
    a chunk, more chunks than units, or ``compact.E`` above that size."""
    from dwt_tpu_torch.ops import compact
    from dwt_tpu_torch.ops import plane_stats as ps

    nchunk, nunits = {"wide chunk": (1, ps.CHUNK_UNITS + 1),
                      "empty chunk": (3, 2), "large E": (1, 1)}[case]
    if case == "large E":
        monkeypatch.setattr(compact, "E", ps.CHUNK_UNITS * ps.UNIT + 1)
    n = nunits * ps.UNIT
    lin = torch.zeros((1, n), dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool)
    unit_chunk = torch.zeros(nunits, dtype=torch.int32)
    chunk_base = torch.zeros(nchunk, dtype=torch.int32)
    with pytest.raises(ValueError, match="units"):
        ps._check_units(lin, valid, unit_chunk, chunk_base)
    if case == "large E":  # the encoder's own layout passes
        monkeypatch.undo()
        ps._check_units(lin, valid, unit_chunk, chunk_base)
