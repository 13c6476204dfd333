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
* ``lift_plan`` replays ``lift_fwd_kernel`` (halo tiles, the row then the
  column lifting of each tile in its shared buffer, the deinterleaved
  store, the two ping-pong LL buffers of the wrapper) with tiles small
  enough that each test image spans several tiles and a ragged edge;
  ``stats_plan`` replays ``plane_hist_kernel`` and ``plane_zup_kernel``
  (per-unit tables added into their chunks, the int8 planes, the
  level-local index from the chunk's level start, the skipped units).
  Both must equal the plain versions.

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


def _lift_tiles(src, colour, coeff, ll, h, w, tp):
    """One launch of lift_fwd_kernel with tiles of tp x tp output pairs:
    src (N, >= h, >= w, C), coeff the (N, H, W, C) coefficients, ll the
    (N, ceil(h / 2), ceil(w / 2), C) LL destination."""
    ts = 2 * tp + 3
    heven, weven = (h + 1) // 2, (w + 1) // 2
    for by in range(-(-h // (2 * tp))):
        for bx in range(-(-w // (2 * tp))):
            r0, c0 = 2 * tp * by - 2, 2 * tp * bx - 2
            t = np.zeros((src.shape[0], ts, ts, src.shape[3]), np.int64)
            gr, gc = r0 + np.arange(ts), c0 + np.arange(ts)
            rin, cin = (gr >= 0) & (gr < h), (gc >= 0) & (gc < w)
            block = src[:, gr[rin]][:, :, gc[cin]].astype(np.int64)
            t[np.ix_(np.arange(src.shape[0]), np.flatnonzero(rin),
                     np.flatnonzero(cin))] = _ycocg(block) if colour else block
            rows = np.flatnonzero(rin)
            for k in range(1, 2 * tp + 2, 2):  # row predict
                if 0 <= c0 + k < w:
                    right = k + 1 if c0 + k + 1 < w else k - 1
                    t[:, rows, k] -= _tdiv(t[:, rows, k - 1]
                                           + t[:, rows, right], 2)
            for k in range(2, 2 * tp + 1, 2):  # row update
                g = c0 + k
                if g < w and not (w % 2 and g == w - 1):
                    left = k - 1 if g >= 1 else k + 1
                    t[:, rows, k] += _tdiv(t[:, rows, left]
                                           + t[:, rows, k + 1], 4)
            cols = [k for k in range(2, 2 * tp + 2) if c0 + k < w]
            for r in range(1, 2 * tp + 2, 2):  # column predict
                if 0 <= r0 + r < h:
                    below = r + 1 if r0 + r + 1 < h else r - 1
                    t[:, r, cols] -= _tdiv(t[:, r - 1, cols]
                                           + t[:, below, cols], 2)
            for r in range(2, 2 * tp + 1, 2):  # column update
                g = r0 + r
                if g < h and not (h % 2 and g == h - 1):
                    above = r - 1 if g >= 1 else r + 1
                    t[:, r, cols] += _tdiv(t[:, above, cols]
                                           + t[:, r + 1, cols], 4)
            for a in range(2 * tp):  # deinterleaved store
                odd_r = a >= tp
                i = tp * by + a - odd_r * tp
                g_r = 2 * i + odd_r
                for b in range(2 * tp):
                    odd_c = b >= tp
                    j = tp * bx + b - odd_c * tp
                    g_c = 2 * j + odd_c
                    if g_r >= h or g_c >= w:
                        continue
                    v = t[:, g_r - r0, g_c - c0]
                    if not odd_r and not odd_c:
                        ll[:, i, j] = v
                    else:
                        coeff[:, heven + i if odd_r else i,
                              weven + j if odd_c else j] = v


def lift_plan(frames, pyr, colour, tp):
    """forward_transform's launches: the finest level from the frames, each
    later one from the LL buffer the last one wrote (two buffers in turn),
    the last LL into the coefficients."""
    N, H, W, C = frames.shape
    coeff = np.full((N, H, W, C), -(2**31), np.int64)  # every slot written
    L = pyr.levels
    bufs = [np.zeros((N * pyr.heights[l] * pyr.widths[l] * C,), np.int64)
            for l in (L - 1, L - 2) if l >= 1]
    src = frames
    for step, l in enumerate(range(L, 0, -1)):
        h, w = pyr.heights[l], pyr.widths[l]
        hl, wl = pyr.heights[l - 1], pyr.widths[l - 1]
        if l == 1:
            ll = coeff
        else:
            ll = bufs[step % 2][:N * hl * wl * C].reshape(N, hl, wl, C)
        _lift_tiles(src, colour and l == L, coeff, ll, h, w, tp)
        src = ll
    return coeff


@pytest.mark.parametrize("w,h,c,n,tp", [(37, 23, 3, 2, 4), (17, 9, 1, 1, 2),
                                        (64, 48, 3, 1, 8), (9, 30, 3, 1, 3)])
def test_lift_plan_equals_plain(rng, w, h, c, n, tp):
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    frames = _frames(rng, w, h, c, n, np.uint8)
    pyr = compute_pyramid(w, h)
    assert -(-w // (2 * tp)) > 1  # several tiles, and a ragged edge
    assert any(pyr.widths[l] % (2 * tp) or pyr.heights[l] % (2 * tp)
               for l in range(1, pyr.levels + 1))
    want = lifting.forward_transform_plain(torch.as_tensor(frames), pyr,
                                           c == 3).numpy()
    assert np.array_equal(lift_plan(frames, pyr, c == 3, tp), want)


def stats_plan(lin, valid, unit_chunk, chunk_base, unit):
    """plane_hist_kernel then plane_zup_kernel, a block a unit of a row:
    returns (planes, nS_ck, lastS_ck, z0_ck, zup_ck)."""
    from dwt_tpu_torch.ops.plane_stats import PMAX

    R, nlin = lin.shape
    n, nchunk = valid.size, chunk_base.size
    nS = np.zeros((R, nchunk, PMAX), np.int64)
    last1, zup = np.zeros_like(nS), np.zeros_like(nS)
    z0, planes = np.zeros((R, nchunk), np.int64), np.zeros(R, np.int64)
    q8 = np.zeros((R, n), np.int8)
    p_all = np.arange(PMAX)
    for row in range(R):  # pass 1
        for u in range(n // unit):
            k = unit_chunk[u]
            pos = u * unit + np.arange(unit)
            x = lin[row, nlin - n + pos].astype(np.int64)
            mag = np.abs(x)
            q = np.where(valid[pos], np.where(
                mag > 0, np.frexp(np.maximum(mag, 1))[1] - 1, -1), 127)
            q8[row, pos] = q
            idx = pos - chunk_base[k]
            for p in range(PMAX):
                at = q == p
                nS[row, k, p] += at.sum()
                if at.any():
                    last1[row, k, p] = max(last1[row, k, p], idx[at].max() + 1)
            z0[row, k] += (q == -1).sum()
            real = q[q != 127]
            if real.size and real.max() >= 0:
                planes[row] = max(planes[row], real.max() + 1)
    for row in range(R):  # pass 2
        for u in range(n // unit):
            k = unit_chunk[u]
            lastp = last1[row, k] - 1
            first = u * unit - chunk_base[k]
            if lastp.max() < first:
                continue
            q = q8[row, u * unit:(u + 1) * unit].astype(np.int64)
            idx = first + np.arange(unit)
            zup[row, k] += ((q[:, None] < p_all)
                            & (idx[:, None] <= lastp)).sum(axis=0)
    return planes, nS, last1 - 1, z0, zup


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
    # The kernels' level-local index is the plain version's.
    pos = np.arange(segs.n)
    base = segs.chunk_base_t.numpy()[np.repeat(segs.unit_chunk_t.numpy(),
                                               ps.UNIT)]
    assert np.array_equal(pos - base, segs.idx_local.numpy())
    want = ps.plane_stats_plain(lin, segs.valid_t, segs.idx_local,
                                segs.block_chunk, segs.unit_chunk_t,
                                segs.chunk_base_t)
    got = stats_plan(lin.numpy(), segs.valid_np, segs.unit_chunk_t.numpy(),
                     segs.chunk_base_t.numpy(), ps.UNIT)
    for name, g, w_ in zip(["planes", "nS_ck", "lastS_ck", "z0_ck", "zup_ck"],
                           got, want):
        assert np.array_equal(g, w_.numpy()), name
