"""The port's transforms and static layout against the JAX package.

Colour transform and CDF 5/3 lifting on tests/test_ops.py's cases (odd
lengths included), and every layout array the port computes from its own
copies of geometry.py and hilbert.py.  Exact.
"""

import numpy as np
import pytest
import torch

from dwt_tpu import specmodel

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [8, 9, 15, 16, 17, 101, 240])
@pytest.mark.parametrize("axis", [0, 1])
def test_cdf53_fwd(rng, n, axis):
    import jax.numpy as jnp

    from dwt_tpu.ops import lifting as jl
    from dwt_tpu_torch.ops import lifting as tl

    shape = (n, 5) if axis == 0 else (5, n)
    x = rng.integers(-1000, 1000, shape).astype(np.int32)
    want = np.asarray(jl.cdf53_fwd(jnp.asarray(x), axis=axis))
    got = tl.cdf53_fwd(torch.as_tensor(x), axis=axis).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("w,h", [(320, 240), (321, 239), (8, 8), (64, 48),
                                 (17, 1000)])
def test_dwt2d_fwd(rng, w, h):
    import jax
    import jax.numpy as jnp

    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu.ops import lifting as jl
    from dwt_tpu_torch import geometry
    from dwt_tpu_torch.ops import lifting as tl

    img = rng.integers(-255, 256, (h, w, 3)).astype(np.int32)
    pyr = compute_pyramid(w, h)
    want = np.asarray(jax.jit(lambda x: jl.dwt2d_fwd(x, pyr))(
        jnp.asarray(img)))
    x = torch.as_tensor(img)
    got = tl.dwt2d_fwd(x, geometry.compute_pyramid(w, h)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, specmodel.dwt2d_fwd(img, pyr))
    assert np.array_equal(x.numpy(), img)  # the input is left as it was


def test_ycocg(rng):
    import jax.numpy as jnp

    from dwt_tpu.ops import color as jc
    from dwt_tpu_torch.ops import color as tc

    img = rng.integers(0, 256, (37, 53, 3)).astype(np.int32)
    want = np.asarray(jc.rgb_to_ycocg(jnp.asarray(img)))
    got = tc.rgb_to_ycocg(torch.as_tensor(img)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_ilog2_matches_clz():
    import jax.numpy as jnp

    from dwt_tpu.codec.encoder import _ilog2_i32
    from dwt_tpu_torch.codec.stage1 import _ilog2

    p = 1 << np.arange(31, dtype=np.int64)
    x = np.unique(np.concatenate([p, p - 1, p + 1, [2**31 - 1]]))
    x = x[(x > 0) & (x < 2**31)].astype(np.int32)
    want = np.asarray(_ilog2_i32(jnp.asarray(x)))
    assert np.array_equal(_ilog2(torch.as_tensor(x)).numpy(), want)


LAYOUT_SIZES = [(8, 8), (9, 8), (64, 48), (128, 32), (321, 239), (640, 480)]


@pytest.mark.parametrize("w,h", LAYOUT_SIZES)
def test_layout_arrays(w, h):
    from dwt_tpu import geometry as jg
    from dwt_tpu import hilbert as jh
    from dwt_tpu_torch import geometry as tg
    from dwt_tpu_torch import hilbert as th

    jp, tp = jg.compute_pyramid(w, h), tg.compute_pyramid(w, h)
    for f in ("width", "height", "levels", "widths", "heights", "pixels",
              "lengths"):
        assert getattr(tp, f) == getattr(jp, f), f
    for n in sorted(set(jp.lengths)):
        for a, b in zip(th.hilbert_xy(n), jh.hilbert_xy(n)):
            assert np.array_equal(a, b)
    assert np.array_equal(th.linearization_perm(tp),
                          jh.linearization_perm(jp))
    assert np.array_equal(th.level_of_position(tp), jh.level_of_position(jp))
    for align in (512, 8192):
        got, want = th.padded_layout(tp, align), jh.padded_layout(jp, align)
        assert got[2] == want[2]
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    got, want = th.tile_plan(tp, 8192), jh.tile_plan(jp, 8192)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("w,h", LAYOUT_SIZES)
def test_segment_tables(w, h):
    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu_torch import geometry
    from dwt_tpu_torch.codec import stage1
    from dwt_tpu_torch.ops import compact

    assert (stage1.ALIGN, stage1.PMAX, stage1.NSTATE) == \
        (je.ALIGN, je.PMAX, je.NSTATE)
    want = je._Segs(compute_pyramid(w, h))
    got = stage1._Segs(geometry.compute_pyramid(w, h), "cpu")
    assert compact.E == 65536
    for f in ("L", "root_pad", "sizes", "real", "starts", "n", "nchunk",
              "ch_start", "ch_len", "level_chunk_base",
              "level_nchunk", "ch_valid"):
        assert getattr(got, f) == getattr(want, f), f
    assert np.array_equal(got.valid_np, want.valid_np)
    assert np.array_equal(got.idx_local.numpy(), np.asarray(want.idx_local))
    assert np.array_equal(got.block_chunk.numpy(), want.block_chunk)


@pytest.mark.parametrize("w,h,c,kind", [(96, 80, 3, "noise"),
                                        (321, 239, 1, "mixed"),
                                        (64, 64, 3, "flat")])
def test_plane_stats_fused_equals_loop(rng, w, h, c, kind):
    """The fused one-hot statistics agree with the per-plane loop on every
    plane below planes_max (the planes every consumer reads)."""
    from conftest import random_image
    from dwt_tpu_torch.codec import encoder, stage1

    img = random_image(rng, w, h, c, kind)
    enc = encoder.Encoder(w, h, c, device="cpu")
    lin, stats = stage1._transform_and_stats(torch.as_tensor(img), enc.pyr,
                                             c, c == 1, enc._src)
    segs = stage1.segs_for(enc.pyr, lin.device)
    q, valid = stage1._detail_q(lin, segs)
    pm = stats["planes_max"]
    got = stage1._plane_stats(q, valid, segs, c, enc.pyr.levels, pm)
    want = stage1._plane_stats_loop(q, valid, segs, c, enc.pyr.levels, pm)
    for name, g, w_ in zip(["nS", "nZ", "trailZ", "nS_ck", "nZ_ck"], got, want):
        assert np.array_equal(g[..., :int(pm)].numpy(),
                              w_[..., :int(pm)].numpy()), name


def test_fill_max_equals_cummax_of_scatter():
    """The token finisher's forward fill equals the JAX package's
    scatter-max + cummax formulation on any positions and values."""
    from dwt_tpu_torch.codec.tokens import _fill_max

    rng = np.random.default_rng(5)
    for _ in range(200):
        n, S = int(rng.integers(1, 60)), int(rng.integers(1, 10))
        pos = torch.as_tensor(rng.integers(0, n, S))
        vals = torch.as_tensor(rng.integers(-5, 100, S).astype(np.int32))
        want = torch.cummax(torch.zeros(n, dtype=torch.int32).scatter_reduce(
            0, pos, vals, "amax"), dim=0).values
        got = _fill_max(pos, vals, torch.arange(n, dtype=torch.int32))
        assert torch.equal(got, want)
