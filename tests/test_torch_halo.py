"""The row-sharded halo transform's levels (``dwt_tpu_torch/ops/halo.py``,
kernels 18 and 19, and ``parallel/tiled.py``'s launch plan) on the CPU.

* The plain route (``halo_dwt2d_fwd`` and ``halo_dwt2d_inv`` on a CPU
  mesh, and every rank's steps played in one process by
  ``tiled.play_ranks``) equals the JAX package's ``halo_dwt2d_fwd`` and
  ``halo_dwt2d_inv`` on as many virtual CPU devices: odd and even
  heights, ``n_halo < levels`` and ``n_halo == levels``, pad rows.
* The fused colour routes on gloo ranks 1-3 (``torch_ranks.Ranks``):
  uint8 RGB rows with the colour in kernel 18's plain version equal
  ``rgb_to_ycocg`` and the forward, and kernel 19's uint8 pixels equal
  the JAX ``ShardedDecoder``'s (the inverse, ``ycocg_to_rgb``, the clip).
* The launch plan: the launches between the two exchanges of each level.
* Both kernels' plan replayed in torch (:func:`replay_forward`,
  :func:`replay_inverse`): a warp a strip of 28 stored columns and a band
  of row pairs, lanes 0-1 and 30-31 the strip's halo read by shuffles,
  the column lifting walked down the band after its prologue, every mode;
  equal to the plain version at every rank of 1-3.

Every comparison is exact: all of it is integer.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from torch_ranks import Ranks, halo_image

torch.set_num_threads(1)

# (w, h): odd and even sides, pad rows at 3 ranks, plans with
# n_halo < levels and n_halo == levels (8x8: one level).
SHAPES = [(64, 64), (63, 64), (64, 63), (17, 1024), (200, 37), (96, 120),
          (8, 8), (513, 8), (31, 270)]


def _pyr(w, h):
    from dwt_tpu_torch.geometry import compute_pyramid

    return compute_pyramid(w, h)


def _seed(w, h):
    return w * 4099 + h


@functools.lru_cache(maxsize=None)
def _jax_halo(w, h, n, rgb=False):
    """JAX's (fine, coarse, inverse of fine, pixels of the inverse) of the
    halo image (``rgb``: a uint8 image through ``rgb_to_ycocg``) on n
    virtual CPU devices, as numpy."""
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu.ops.color import rgb_to_ycocg, ycocg_to_rgb
    from dwt_tpu.parallel import tiled as jt

    pyr, mesh = compute_pyramid(w, h), Mesh(np.array(jax.devices()[:n]),
                                            ("y",))
    img = _rgb(w, h) if rgb else halo_image(w, h, _seed(w, h))

    @jax.jit
    def both(img):
        x = img.astype(jnp.int32)
        if rgb:
            x = rgb_to_ycocg(x)
        x = jax.lax.with_sharding_constraint(
            jt.pad_rows(x, pyr, n), NamedSharding(mesh, P("y", None, None)))
        fine, coarse = jt.halo_dwt2d_fwd(x, mesh, pyr)
        inv = jt.halo_dwt2d_inv(fine, mesh, pyr)
        px = jnp.clip(ycocg_to_rgb(inv[:h]), 0, 255).astype(jnp.uint8)
        return fine, coarse, inv, px

    return tuple(np.asarray(a) for a in both(jnp.asarray(img)))


def _rgb(w, h):
    return np.random.default_rng(_seed(w, h)).integers(
        0, 256, (h, w, 3)).astype(np.uint8)


def _played(img, w, h, n, colour=False, fwd=None, inv=None, to_bytes=False,
            fine_in=None):
    """Every rank's forward steps played in one process
    (``tiled.play_forward``), then the inverse of ``fine_in`` (the
    forward's fine buffer when None): (fine, coarse grid, inverse) as
    numpy, rank blocks in order."""
    from dwt_tpu_torch.parallel import tiled

    pyr = _pyr(w, h)
    fine, grid = tiled.play_forward(torch.as_tensor(img), pyr, n, colour,
                                    fwd)
    src = fine if fine_in is None else torch.as_tensor(fine_in)
    out = tiled.play_inverse(src, pyr, n, to_bytes, inv)
    return fine.numpy(), grid.numpy(), out.numpy()


# --- the plain route against the JAX package --------------------------------

@pytest.mark.parametrize("w,h", SHAPES)
def test_plain_one_rank_equals_jax(w, h):
    """``halo_dwt2d_fwd`` and ``halo_dwt2d_inv`` on a CPU mesh of one rank
    equal the JAX package's on one device (fine block with its pad rows,
    coarse result, inverse), and the inverse gives the image back."""
    from dwt_tpu_torch.parallel import hosts, tiled

    pyr, mesh = _pyr(w, h), hosts.global_mesh("cpu")
    img = halo_image(w, h, _seed(w, h))
    jfine, jcoarse, jinv, _ = _jax_halo(w, h, 1)
    fine, coarse = tiled.halo_dwt2d_fwd(
        tiled.rank_rows(torch.as_tensor(img), mesh, pyr), mesh, pyr)
    np.testing.assert_array_equal(fine.numpy(), jfine)
    np.testing.assert_array_equal(coarse.numpy(), jcoarse)
    inv = tiled.halo_dwt2d_inv(torch.as_tensor(jfine), mesh, pyr)
    np.testing.assert_array_equal(inv.numpy(), jinv)
    np.testing.assert_array_equal(inv.numpy()[:h], img)


@pytest.mark.parametrize("n", (2, 3))
@pytest.mark.parametrize("w,h", SHAPES)
def test_played_ranks_equal_jax(w, h, n):
    """Every rank's plain steps played in one process, the exchanges made
    by copies, equal the JAX package on n devices: the fine buffer, the
    coarse grid (the LL quadrant each rank gathers) and the inverse."""
    from dwt_tpu_torch.ops.lifting import dwt2d_fwd
    from dwt_tpu_torch.parallel import tiled

    pyr = _pyr(w, h)
    n_halo, _ = tiled._halo_plan(pyr, n)
    jfine, jcoarse, jinv, _ = _jax_halo(w, h, n)
    fine, grid, inv = _played(halo_image(w, h, _seed(w, h)), w, h, n,
                              fine_in=jfine)
    np.testing.assert_array_equal(fine, jfine)
    np.testing.assert_array_equal(inv, jinv)
    L = pyr.levels
    hc, wc = pyr.heights[L - n_halo], pyr.widths[L - n_halo]
    coarse = torch.as_tensor(grid[:hc])
    if n_halo < L:
        coarse = dwt2d_fwd(coarse, _pyr(wc, hc))
    np.testing.assert_array_equal(coarse.numpy(), jcoarse)


def test_fused_colour_played_equals_jax():
    """uint8 RGB rows with the colour in the first forward level, and the
    uint8 pixels of the last inverse level, equal the JAX package's
    ``rgb_to_ycocg`` then forward, and inverse then ``ycocg_to_rgb`` and
    the clip, at 1-3 ranks played in one process."""
    for w, h in ((63, 64), (200, 37), (31, 270)):
        img = _rgb(w, h)
        for n in (1, 2, 3):
            jfine, _, _, jpx = _jax_halo(w, h, n, rgb=True)
            fine, _, px = _played(img, w, h, n, colour=True, to_bytes=True)
            np.testing.assert_array_equal(fine, jfine)
            np.testing.assert_array_equal(px[:h], jpx)
            np.testing.assert_array_equal(px[:h], img)


# --- the fused routes on gloo ranks -----------------------------------------

@pytest.fixture(scope="module", params=(1, 2, 3), ids=lambda n: f"n{n}")
def ranks(request):
    pool = Ranks(request.param)
    yield pool
    pool.close()


@pytest.mark.parametrize("w,h", [(63, 64), (200, 37), (31, 270)])
def test_fused_routes_on_ranks_equal_jax(ranks, w, h):
    """On gloo ranks: ``halo_dwt2d_fwd(rank_rows(img), colour=True)`` of
    a uint8 RGB image equals the JAX package's forward of
    ``rgb_to_ycocg(img)`` (fine block and coarse result), and
    ``halo_dwt2d_inv(..., to_bytes=True)`` of that fine
    buffer, gathered, equals its ``ShardedDecoder``'s pixels; the
    exchanges are those of the int32 route."""
    img = _rgb(w, h)
    jfine, jcoarse, _, jpx = _jax_halo(w, h, ranks.n, rgb=True)
    res = ranks.run("halo_rgb", img=img, fine=jfine)
    np.testing.assert_array_equal(np.concatenate([f for f, _, _, _ in res]),
                                  jfine)
    int32_logs = [log for _, _, log in ranks.run(
        "halo_fwd", w=w, h=h, seed=_seed(w, h))]
    for (_, coarse, px, log), want in zip(res, int32_logs):
        np.testing.assert_array_equal(coarse, jcoarse)
        np.testing.assert_array_equal(px, jpx)
        assert log == want


# --- the launch plan ----------------------------------------------------------

@pytest.mark.parametrize("n", (1, 2, 3, 8))
@pytest.mark.parametrize("w,h", SHAPES + [(3840, 2160)])
def test_launch_plan(w, h, n):
    """Each level's launches between its two exchanges: forward "head"
    (where there is a previous rank), exchange, "bulk", exchange, "fix"
    (likewise); inverse "pack" (where there is a next rank), exchange,
    "head" (where there is a previous rank), exchange, "bulk"; at world
    size 1 one "bulk" a level and no exchange.  A rank sends nothing
    where it has no neighbour, and reads a received row only where it
    has one.  The levels tile the rank's block."""
    from dwt_tpu_torch.ops import halo
    from dwt_tpu_torch.parallel import tiled

    pyr = _pyr(w, h)
    n_halo, h_pad = tiled._halo_plan(pyr, n)
    rb = h_pad // n
    for r in range(n):
        for inverse in (False, True):
            plan = tiled.launch_plan(pyr, n, r, inverse)
            ts = list(range(n_halo))[::-1 if inverse else 1]
            assert len(plan) == n_halo
            for t, (lv, steps) in zip(ts, plan):
                s, w_act, n_even, n_upd = tiled._level_rules(pyr, t)
                assert lv == halo.Level(s, w_act, rb // s, r * rb // s // 2,
                                        n_even, n_upd, r > 0, r < n - 1,
                                        t == n_halo - 1)
                modes = [st.mode for st in steps]
                if n == 1:
                    assert modes == ["bulk"]
                    continue
                i, j = [k for k, m in enumerate(modes) if m == "shift"]
                before, between, after = (modes[:i], modes[i + 1:j],
                                          modes[j + 1:])
                if inverse:
                    assert (before, between, after) == (
                        ["pack"] * lv.next, ["head"] * lv.prev, ["bulk"])
                else:
                    assert (before, between, after) == (
                        ["head"] * lv.prev, ["bulk"], ["fix"] * lv.prev)
                writer = {(False, halo.TOP): "head",
                          (False, halo.BOT): "bulk",
                          (True, halo.BOT): "pack", (True, halo.TOP): "head"}
                for k in (i, j):
                    st = steps[k]
                    # A row sent is one this rank wrote before it.
                    sends = 0 <= r - st.step < n
                    assert not sends or writer[inverse, st.send] in modes[:k]
                    # A row comes from the side that has a rank, if any.
                    assert (st.recv, st.step) in ((halo.NXT, 1),
                                                  (halo.PRV, -1))
                    assert (0 <= r + st.step < n) == (
                        lv.next if st.step == 1 else lv.prev)


def test_world_size_one_is_one_launch_a_level():
    """At world size 1 a 4K plan is 8 halo levels of one launch each, in
    both directions, and the coarse grid is the 15x9 the single-device
    tail transforms."""
    from dwt_tpu_torch.parallel import tiled

    pyr = _pyr(3840, 2160)
    for inverse in (False, True):
        plan = tiled.launch_plan(pyr, 1, 0, inverse)
        assert [len(lp.steps) for lp in plan] == [1] * 8
    lv = tiled.launch_plan(pyr, 1, 0)[-1].level
    assert (lv.rows // 2, (lv.w + 1) // 2) == (2304 // 256, 15)


# --- the kernels' plan, replayed --------------------------------------------

def _td(a, b):
    return torch.div(a, b, rounding_mode="trunc")


def _up(v):  # __shfl_up_sync(v, 1): lane 0 keeps its own
    return torch.cat([v[:, :1], v[:, :-1]], 1)


def _down(v):  # __shfl_down_sync(v, 1): lane 31 keeps its own
    return torch.cat([v[:, 1:], v[:, -1:]], 1)


def _lift_row(x, k, w):
    """csrc lift_row on every strip's 32 lanes: x (S, 32, C), k (S, 32, 1)."""
    xl, xr = _up(x), _down(x)
    dd = x - _td(xl + torch.where(k + 1 < w, xr, xl), 2)
    dl, dr = _up(dd), _down(dd)
    upd = x + _td(torch.where(k == 0, dr, dl) + dr, 4)
    keep = (w % 2 == 1) & (k == w - 1)
    return torch.where((k & 1) == 1, dd, torch.where(keep, x, upd))


def _unlift_row(y, k, w):
    """csrc unlift_row likewise."""
    yl, yr = _up(y), _down(y)
    keep = (w % 2 == 1) & (k == w - 1)
    ev = torch.where(keep, y, y - _td(torch.where(k >= 1, yl, yr) + yr, 4))
    el, er = _up(ev), _down(ev)
    return torch.where((k & 1) == 1,
                       y + _td(el + torch.where(k + 1 < w, er, el), 2), ev)


class _Warps:
    """The warps of a launch over a level's columns: strip s's lane l at
    column 28 s + l - 2 (clamped into the row for its loads), lanes 2..29
    storing."""

    def __init__(self, lv):
        from dwt_tpu_torch.ops import halo

        lanes = torch.arange(32)
        S = -(-lv.w // halo.STRIP)
        self.k = (halo.STRIP * torch.arange(S)[:, None] + lanes - 2)
        self.kc = self.k.clamp(0, lv.w - 1)
        self.store = (lanes >= 2) & (lanes < 30) & (self.k < lv.w)
        self.ks = self.k[self.store]
        self.kk = self.k[..., None]

    def put(self, dst, v):
        """Stored lanes' values into dst at their columns: dst[k] = v."""
        dst[self.ks] = v[self.store].to(dst.dtype)


def _put_even(lv, wp, g, ll, j, v):
    ev, od = wp.ks % 2 == 0, wp.ks % 2 == 1
    vals = v[wp.store]
    g[2 * j, wp.ks[od]] = vals[od].to(torch.int32)
    ll[j, wp.ks[ev] // 2] = vals[ev].to(torch.int32)
    if lv.coarsest or lv.s == 1:
        g[2 * j, wp.ks[ev]] = vals[ev].to(torch.int32)


def replay_forward(mode, lv, src, colour, fine, ll, edge):
    """csrc halo_fwd_kernel's plan, warp strip by warp strip and band by
    band, in place; (fine, ll, edge) as ``halo_forward``."""
    from dwt_tpu_torch.ops import halo
    from dwt_tpu_torch.ops.color import rgb_to_ycocg

    wp, w, P = _Warps(lv), lv.w, lv.rows // 2
    x = src.to(torch.int64)
    if colour:
        x = rgb_to_ycocg(x)
    g = halo._grid(fine, lv)

    def lifted(r):
        row = x[r][wp.kc] if r < x.shape[0] else torch.zeros(
            wp.k.shape + (x.shape[2],), dtype=torch.int64)
        return _lift_row(row, wp.kk, w)

    if mode == "head":
        wp.put(edge[halo.TOP], lifted(0))
        return fine, ll, edge
    if mode == "fix":
        if lv.g0 < lv.n_upd:
            e = g[0][wp.kc].long()
            ev = (wp.kc % 2 == 0)
            e[ev] = ll[0][wp.kc[ev] // 2].long()
            e = e + _td(edge[halo.PRV][wp.kc].long() + g[1][wp.kc].long(), 4)
            _put_even(lv, wp, g, ll, 0, e)
        return fine, ll, edge
    bp = halo.band_pairs(lv)
    for band in range(-(-P // bp)):
        i0, i1 = band * bp, min(band * bp + bp, P)
        e = lifted(2 * i0)
        if i0 > 0:
            q, o = lifted(2 * i0 - 2), lifted(2 * i0 - 1)
            dp = o - _td(q + (q if lv.g0 + i0 >= lv.n_even else e), 2)
        for j in range(i0, i1):
            jg = lv.g0 + j
            o = lifted(2 * j + 1)
            if j + 1 < P:
                en = lifted(2 * j + 2)
            elif lv.next:
                en = edge[halo.NXT][wp.kc].long()
            else:
                en = e
            d = o - _td(e + (e if jg + 1 >= lv.n_even else en), 2)
            upd = jg < lv.n_upd and not (j == 0 and lv.prev)
            s = e + _td((dp if j > 0 else d) + d, 4) if upd else e
            wp.put(g[2 * j + 1], d)
            _put_even(lv, wp, g, ll, j, s)
            if j == P - 1:
                wp.put(edge[halo.BOT], d)
            dp, e = d, en
    return fine, ll, edge


def replay_inverse(mode, lv, fine, ll, edge, out):
    """csrc halo_inv_kernel's plan likewise; (out, edge) as
    ``halo_inverse``."""
    from dwt_tpu_torch.ops import halo
    from dwt_tpu_torch.ops.color import ycocg_to_rgb

    wp, w, P = _Warps(lv), lv.w, lv.rows // 2
    g = halo._grid(fine, lv)

    def even(j):
        v = g[2 * j][wp.kc].long()
        if ll is not None:
            ev = wp.kc % 2 == 0
            v[ev] = ll[j][wp.kc[ev] // 2].long()
        return v

    def unupdate(j, e, left, d):
        return e - _td(left + d, 4) if lv.g0 + j < lv.n_upd else e

    def put(r, v):
        if out.dtype == torch.uint8:
            v = (ycocg_to_rgb(v) if v.shape[-1] == 3 else v).clamp(0, 255)
        wp.put(out[r], v)

    if mode == "pack":
        wp.put(edge[halo.BOT], g[lv.rows - 1][wp.kc])
        return out, edge
    if mode == "head":
        wp.put(edge[halo.TOP], unupdate(0, even(0), edge[halo.PRV][wp.kc]
                                        .long(), g[1][wp.kc].long()))
        return out, edge
    bp = halo.band_pairs(lv)
    for band in range(-(-P // bp)):
        i0, i1 = band * bp, min(band * bp + bp, P)
        d = g[2 * i0 + 1][wp.kc].long()
        if i0 > 0:
            left = g[2 * i0 - 1][wp.kc].long()
        elif lv.prev:
            left = edge[halo.PRV][wp.kc].long()
        else:
            left = g[1][wp.kc].long()
        sc = unupdate(i0, even(i0), left, d)
        for j in range(i0, i1):
            if j + 1 < P:
                dn = g[2 * j + 3][wp.kc].long()
                sn = unupdate(j + 1, even(j + 1), d, dn)
            elif lv.next:
                dn, sn = d, edge[halo.NXT][wp.kc].long()
            else:
                dn, sn = d, sc
            clamp = lv.g0 + j + 1 >= lv.n_even
            od = d + _td(sc + (sc if clamp else sn), 2)
            put(2 * j, _unlift_row(sc, wp.kk, w))
            put(2 * j + 1, _unlift_row(od, wp.kk, w))
            d, sc = dn, sn
    return out, edge


@pytest.mark.parametrize("n", (1, 2, 3))
@pytest.mark.parametrize("w,h", SHAPES[:6] + [(31, 270)])
def test_kernel_plan_replayed_equals_plain(w, h, n):
    """Kernels 18 and 19 replayed lane by lane (every mode, every rank of
    n played in one process) equal their plain versions: the fine buffer,
    the coarse grid, the int32 inverse and the uint8 pixels with and
    without the colour."""
    from dwt_tpu_torch.ops import halo

    img = halo_image(w, h, _seed(w, h))
    want = _played(img, w, h, n, fwd=halo.halo_forward_plain,
                   inv=halo.halo_inverse_plain)
    got = _played(img, w, h, n, fwd=replay_forward, inv=replay_inverse)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rgb = _rgb(w, h)
    want = _played(rgb, w, h, n, True, halo.halo_forward_plain,
                   halo.halo_inverse_plain, True)
    got = _played(rgb, w, h, n, True, replay_forward, replay_inverse, True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2][:h], rgb)
    gray = rgb[..., :1]
    want = _played(gray, w, h, n, False, halo.halo_forward_plain,
                   halo.halo_inverse_plain, True)
    got = _played(gray, w, h, n, False, replay_forward, replay_inverse, True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_band_pairs():
    """A bulk launch's row pairs a warp: 16 on the 4K finest level, halved
    on the coarser ones until the launch has 4,096 warps or a pair a
    warp."""
    from dwt_tpu_torch.parallel import tiled
    from dwt_tpu_torch.ops import halo

    bps = [halo.band_pairs(lp.level)
           for lp in tiled.launch_plan(_pyr(3840, 2160), 1, 0)]
    assert bps[0] == 16 and bps[-1] == 1
    assert bps == sorted(bps, reverse=True)


# --- the wrappers -----------------------------------------------------------

def test_wrappers_check_their_arguments():
    """Each wrapper raises on a mode, a shape or a type it does not take;
    on CPU tensors it runs its plain version, which launches nothing."""
    from dwt_tpu_torch.ops import halo

    lv = halo.Level(1, 8, 8, 0, 4, 4, False, False, True)
    fine = torch.zeros((8, 8, 3), dtype=torch.int32)
    src = torch.zeros((8, 8, 3), dtype=torch.uint8)
    ll = torch.zeros((4, 4, 3), dtype=torch.int32)
    edge = torch.zeros((4, 8, 3), dtype=torch.int32)
    out = torch.zeros((8, 8, 3), dtype=torch.uint8)
    before = (halo.halo_forward.launches, halo.halo_inverse.launches)
    halo.halo_forward("bulk", lv, src, True, fine, ll, edge)
    halo.halo_inverse("bulk", lv, fine, None, edge, out)
    assert (halo.halo_forward.launches, halo.halo_inverse.launches) == before
    with pytest.raises(ValueError, match="mode"):
        halo.halo_forward("pack", lv, src, True, fine, ll, edge)
    with pytest.raises(ValueError, match="grid"):
        halo.halo_forward("bulk", lv, src, True, fine[:6], ll, edge)
    with pytest.raises(ValueError, match="input rows"):
        halo.halo_forward("bulk", lv, src.float(), False, fine, ll, edge)
    with pytest.raises(ValueError, match="colour"):
        halo.halo_forward("bulk", lv, src[..., :1], True, fine[..., :1],
                          ll[..., :1], edge[..., :1])
    with pytest.raises(ValueError, match="ll must be"):
        halo.halo_inverse("bulk", lv, fine, ll[:2], edge, out)
    with pytest.raises(ValueError, match="out must be"):
        halo.halo_inverse("bulk", lv, fine, None, edge, out.long())
    with pytest.raises(ValueError, match="edge"):
        halo.halo_inverse("head", lv, fine, None, edge[:3], out)


def test_halo_entry_points_check_their_blocks():
    from dwt_tpu_torch.parallel import hosts, tiled

    pyr, mesh = _pyr(64, 63), hosts.global_mesh("cpu")
    with pytest.raises(ValueError, match="not one of"):
        tiled.halo_dwt2d_fwd(torch.zeros((65, 64, 3), dtype=torch.int32),
                             mesh, pyr)
    with pytest.raises(ValueError, match="not one of"):
        tiled.halo_dwt2d_inv(torch.zeros((63, 64, 3), dtype=torch.int32),
                             mesh, pyr)
    with pytest.raises(ValueError, match="int32 block"):
        tiled.halo_dwt2d_inv(torch.zeros((64, 64, 3), dtype=torch.uint8),
                             mesh, pyr)
