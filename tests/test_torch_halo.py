"""The row-sharded halo transform's levels (``dwt_tpu_torch/ops/halo.py``,
kernels 18 and 19, and ``parallel/tiled.py``'s launch plan) on the CPU.

* The plain route (``halo_dwt2d_fwd`` and ``halo_dwt2d_inv`` on a CPU
  mesh, and every rank's steps played in one process by
  ``tiled.play_ranks``) equals the JAX package's ``halo_dwt2d_fwd`` and
  ``halo_dwt2d_inv`` on as many virtual CPU devices: odd and even
  heights, ``n_halo < levels`` and ``n_halo == levels``, pad rows, three
  channels and one.
* The fused colour routes on gloo ranks 1-3 (``torch_ranks.Ranks``):
  uint8 RGB rows with the colour in kernel 18's plain version equal
  ``rgb_to_ycocg`` and the forward, and kernel 19's uint8 pixels equal
  the JAX ``ShardedDecoder``'s (the inverse, ``ycocg_to_rgb``, the clip).
* The launch plan: at world size 1 the two finest levels in one launch
  and a launch a level after them (seven launches at 4K), with neighbours
  the launches between each level's two exchanges; one allocation of a
  call's buffers; the one-level launches' bands.
* Both kernels' source built for the CPU (``cuda_cpu.build``: a block's
  threads as threads) and played at every rank of 1-3: equal to the plain
  version, every mode, the one-level launches and the pair, its bands and
  tiles at two card sizes.

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


@pytest.mark.parametrize("n", (1, 2, 3))
@pytest.mark.parametrize("w,h", SHAPES)
def test_played_gray_equals_jax(w, h, n):
    """One channel: the plain steps played at n ranks on channel 0 of the
    halo image equal channel 0 of the JAX package's fine buffer and
    inverse (the transform lifts each channel alone)."""
    jfine, _, jinv, _ = _jax_halo(w, h, n)
    fine, _, inv = _played(halo_image(w, h, _seed(w, h))[..., :1], w, h, n,
                           fine_in=jfine[..., :1])
    np.testing.assert_array_equal(fine, jfine[..., :1])
    np.testing.assert_array_equal(inv, jinv[..., :1])


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
    """The launches cover every halo level once, in order (the inverse's
    coarsest first), each level as ``_level_rules`` makes it.  At world
    size 1: one "bulk" a launch, the two finest levels in the first (where
    there are two), one level in each other.  With neighbours a
    launch a level: forward "head" (where there is a previous rank),
    exchange, "bulk", exchange, "fix" (likewise); inverse "pack" (where
    there is a next rank), exchange, "head" (where there is a previous
    rank), exchange, "bulk".  A rank sends nothing where it has no
    neighbour, and reads a received row only where it has one."""
    from dwt_tpu_torch.ops import halo
    from dwt_tpu_torch.parallel import tiled

    pyr = _pyr(w, h)
    n_halo, h_pad = tiled._halo_plan(pyr, n)
    rb = h_pad // n
    for r in range(n):
        for inverse in (False, True):
            plan = tiled.launch_plan(pyr, n, r, inverse)
            order = plan[::-1] if inverse else plan
            levels = [lv for la in order for lv in la.levels]
            assert len(levels) == n_halo
            for t, lv in enumerate(levels):
                s, w_act, n_even, n_upd = tiled._level_rules(pyr, t)
                assert lv == halo.Level(s, w_act, rb // s, r * rb // s // 2,
                                        n_even, n_upd, r > 0, r < n - 1,
                                        t == n_halo - 1)
            if n == 1:
                assert [len(la.levels) for la in order] == (
                    [2] + [1] * (n_halo - 2) if n_halo > 1 else [1] * n_halo)
                assert all([st.mode for st in la.steps] == ["bulk"]
                           for la in plan)
                continue
            for la in plan:
                (lv,), steps = la
                modes = [st.mode for st in steps]
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


def test_world_size_one_4k_launches():
    """At world size 1 a 4K plan is 8 halo levels in seven launches in
    both directions: levels 0 and 1 (the pair), then one level each; the
    inverse runs them in the opposite order; the coarse grid is the 15x9
    the single-device tail transforms."""
    from dwt_tpu_torch.parallel import tiled

    pyr = _pyr(3840, 2160)
    for inverse in (False, True):
        plan = tiled.launch_plan(pyr, 1, 0, inverse)
        strides = [[lv.s for lv in la.levels] for la in plan]
        want = [[1, 2]] + [[1 << t] for t in range(2, 8)]
        assert strides == (want[::-1] if inverse else want)
    lv = tiled.launch_plan(pyr, 1, 0)[-1].levels[-1]
    assert lv.coarsest and (lv.rows // 2, (lv.w + 1) // 2) == (2304 // 256,
                                                               15)


def test_band_pairs():
    """A one-level bulk launch's row pairs a warp: 16 on the 4K finest
    level, halved on the coarser ones until the launch has 4,096 warps or
    a pair a warp."""
    from dwt_tpu_torch.ops import halo
    from dwt_tpu_torch.parallel import tiled

    bps = [halo.band_pairs(lv) for la in tiled.launch_plan(
        _pyr(3840, 2160), 1, 0) for lv in la.levels]
    assert bps[0] == 16 and bps[-1] == 1
    assert bps == sorted(bps, reverse=True)


@pytest.mark.parametrize("inverse", (False, True))
def test_one_allocation_a_call(inverse):
    """A call's launch outputs and edge rows are views of one allocation,
    each at a multiple of 256 bytes, of the shapes the wrappers check
    (the inverse's finest output uint8 where the pixels are asked)."""
    from dwt_tpu_torch.ops import halo
    from dwt_tpu_torch.parallel import tiled

    pyr, C = _pyr(200, 37), 3
    for n, r in ((1, 0), (3, 1)):
        plan = tiled.launch_plan(pyr, n, r, inverse)
        bufs = tiled._buffers(torch.empty((1, 1, C)), pyr, n, r, inverse,
                              to_bytes=True)
        base = bufs[0][0].untyped_storage().data_ptr()
        assert len(bufs) == len(plan)
        for la, (o, edge) in zip(plan, bufs):
            lv = la.levels[0]
            want = ((lv.rows, lv.w, C) if inverse
                    else halo.ll_shape(la.levels, C))
            assert tuple(o.shape) == want and o.is_contiguous()
            assert o.untyped_storage().data_ptr() == base
            assert (o.data_ptr() - base) % 256 == 0
            assert o.dtype == (torch.uint8 if inverse and lv.s == 1
                               else torch.int32)
            assert (edge is None) == (n == 1)
            if edge is not None:
                assert tuple(edge.shape) == (4, lv.w, C)
                assert edge.untyped_storage().data_ptr() == base


# --- the kernels' source, built for the CPU ----------------------------------

def _cpu_steps(sms, per_sm):
    """Kernel 18's and 19's C entry points of ``csrc/halo_lifting.cu``
    built for the CPU (``cuda_cpu.build``) as ``step`` functions of
    ``tiled.play_forward`` and ``play_inverse``, the pair planning for a
    card of ``sms`` SMs of ``per_sm`` blocks."""
    import ctypes

    import cuda_cpu
    from dwt_tpu_torch.ops import halo
    from dwt_tpu_torch.runtime import build

    lib = cuda_cpu.build("halo_lifting.cu")
    for name in ("dwt_halo_forward", "dwt_halo_inverse",
                 "dwt_halo_forward_pair", "dwt_halo_inverse_pair"):
        getattr(lib, name).argtypes = build.ENTRY_POINTS[name]
    lib.emu_card(sms, per_sm)

    def fwd(mode, levels, src, colour, fine, ll, edge):
        src = src.contiguous()  # held through the call: the kernel reads it
        assert halo._forward_call(lib, None, mode, levels, fine.shape[2], src,
                                  colour, fine, ll, edge) == 0
        return fine, ll, edge

    def inv(mode, levels, fine, ll, edge, out):
        assert halo._inverse_call(lib, None, mode, levels, fine.shape[2],
                                  fine, ll, edge, out) == 0
        return out, edge

    return fwd, inv


@pytest.mark.parametrize("n", (1, 2, 3))
@pytest.mark.parametrize("w,h", SHAPES)
def test_kernel_plan_replayed_equals_plain(w, h, n):
    """Kernels 18 and 19, their source built for the CPU and played at
    every rank of n (every mode of the one-level launches, the pair at n =
    1 with the bands and tiles of a card of 3 SMs of 2 blocks), equal
    their plain versions: the fine buffer, the coarse grid, the int32
    inverse and the uint8 pixels with and without the colour."""
    from dwt_tpu_torch.ops import halo

    fwd, inv = _cpu_steps(3, 2)
    img = halo_image(w, h, _seed(w, h))
    want = _played(img, w, h, n, fwd=halo.halo_forward_plain,
                   inv=halo.halo_inverse_plain)
    got = _played(img, w, h, n, fwd=fwd, inv=inv)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rgb = _rgb(w, h)
    want = _played(rgb, w, h, n, True, halo.halo_forward_plain,
                   halo.halo_inverse_plain, True)
    got = _played(rgb, w, h, n, True, fwd, inv, True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2][:h], rgb)
    gray = rgb[..., :1]
    want = _played(gray, w, h, n, False, halo.halo_forward_plain,
                   halo.halo_inverse_plain, True)
    got = _played(gray, w, h, n, False, fwd, inv, True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w,h,c,n", [(1001, 77, 3, 1), (600, 40, 1, 1),
                                     (100, 600, 1, 1), (513, 16, 3, 1),
                                     (513, 8, 3, 2)])
def test_kernel_source_at_card_plans_equals_plain(w, h, c, n):
    """The CPU build at the bands of a card of 132 SMs of 2 blocks: the
    pair on three column tiles (1001 x 77) and on two (600 x 40), a width
    below a tile with bands of two pairs, the pair with the fewest rows it
    takes (513 x 16: eight at level 1), the one-level launches of two
    ranks; uint8 rows (with the colour for RGB) to uint8 pixels."""
    from dwt_tpu_torch.ops import halo

    fwd, inv = _cpu_steps(132, 2)
    img = _rgb(w, h)[..., :c]
    got = _played(img, w, h, n, c == 3, fwd, inv, True)
    want = _played(img, w, h, n, c == 3, halo.halo_forward_plain,
                   halo.halo_inverse_plain, True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2][:h], img)


# --- the wrappers -----------------------------------------------------------

def test_wrappers_check_their_arguments():
    """Each wrapper raises on a mode, a level group, a shape or a type it
    does not take; on CPU tensors it runs its plain version, which
    launches nothing."""
    from dwt_tpu_torch.ops import halo

    lv = halo.Level(1, 8, 8, 0, 4, 4, False, False, False)
    lv2 = halo.Level(2, 4, 4, 0, 2, 2, False, False, True)
    fine = torch.zeros((8, 8, 3), dtype=torch.int32)
    src = torch.zeros((8, 8, 3), dtype=torch.uint8)
    ll = torch.zeros((2, 2, 3), dtype=torch.int32)
    out = torch.zeros((8, 8, 3), dtype=torch.uint8)
    before = (halo.halo_forward.launches, halo.halo_inverse.launches)
    halo.halo_forward("bulk", (lv, lv2), src, True, fine, ll, None)
    halo.halo_inverse("bulk", (lv, lv2), fine, None, None, out)
    assert (halo.halo_forward.launches, halo.halo_inverse.launches) == before
    with pytest.raises(ValueError, match="mode"):
        halo.halo_forward("pack", (lv, lv2), src, True, fine, ll, None)
    with pytest.raises(ValueError, match="levels for mode"):
        halo.halo_forward("head", (lv, lv2), src, True, fine, ll, None)
    with pytest.raises(ValueError, match="levels for mode"):
        halo.halo_inverse("bulk", (lv, lv2, lv2._replace(
            s=4, w=2, rows=2, g0=0)), fine, None, None, out)
    with pytest.raises(ValueError, match="not the two finest"):
        halo.halo_forward("bulk", (lv, lv), src, True, fine, ll, None)
    with pytest.raises(ValueError, match="not the two finest"):
        halo.halo_forward("bulk", (lv2, lv2._replace(s=4, w=2, rows=2)),
                          src, True, fine, ll, None)
    with pytest.raises(ValueError, match="neighbours"):
        halo.halo_forward("bulk", (lv._replace(next=True),
                                   lv2._replace(next=True)), src, True,
                          fine, ll, torch.zeros((4, 8, 3),
                                                dtype=torch.int32))
    with pytest.raises(ValueError, match="grid"):
        halo.halo_forward("bulk", (lv, lv2), src, True, fine[:6], ll, None)
    with pytest.raises(ValueError, match="input rows"):
        halo.halo_forward("bulk", (lv, lv2), src.float(), False, fine, ll,
                          None)
    with pytest.raises(ValueError, match="colour"):
        halo.halo_forward("bulk", (lv, lv2), src[..., :1], True,
                          fine[..., :1], ll[..., :1], None)
    with pytest.raises(ValueError, match="ll must be"):
        halo.halo_forward("bulk", (lv,), src, True, fine, ll, None)
    with pytest.raises(ValueError, match="edge must be"):
        halo.halo_forward("bulk", (lv._replace(prev=True),), src, True,
                          fine, torch.zeros((4, 4, 3), dtype=torch.int32),
                          None)
    with pytest.raises(ValueError, match="edge must be"):
        halo.halo_forward("head", (lv,), src, True, fine,
                          torch.zeros((4, 4, 3), dtype=torch.int32), None)
    with pytest.raises(ValueError, match="ll must be"):
        halo.halo_inverse("bulk", (lv,), fine, ll, None, out)
    with pytest.raises(ValueError, match="out must be"):
        halo.halo_inverse("bulk", (lv, lv2), fine, None, None, out.long())
    with pytest.raises(ValueError, match="edge"):
        halo.halo_inverse("head", (lv._replace(prev=True),), fine, None,
                          torch.zeros((3, 8, 3), dtype=torch.int32), out)


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
