"""The port's sharded paths (``dwt_tpu_torch/parallel``) on the CPU: real
gloo ranks in spawned processes (``torch_ranks.Ranks``, started once for
each world size of 2, 3 and 8), held against the JAX package on the
virtual CPU devices of ``conftest.py`` (``Mesh(jax.devices()[:n])``) and
against ``specmodel``.  Every comparison is exact: all of it is integer.

Mirrors tests/test_parallel.py (the halo transform, the sharded encoder,
decoder and tiled encode) and tests/test_comms.py (the halo transform's
collective traffic, here read from ``hosts.comm_log`` instead of compiled
HLO).  Each JAX result is made once (its CPU compiles dominate).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from conftest import random_image
from torch_ranks import Ranks, halo_image

torch.set_num_threads(1)

WORLDS = (2, 3, 8)
HALO_SHAPES = [(64, 64), (63, 64), (320, 256), (17, 1024),
               (64, 63), (64, 270), (640, 360), (1920, 1080)]
PLAN_SHAPES = HALO_SHAPES + [(96, 120), (3840, 2160), (8, 8), (8, 513),
                             (513, 8)]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"n{n}")
def ranks(request):
    pool = Ranks(request.param)
    yield pool
    pool.close()


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("y",))


def _pyr(w, h):
    from dwt_tpu_torch.geometry import compute_pyramid

    return compute_pyramid(w, h)


def _seed(w, h):
    return w * 4099 + h


# JAX's halo transforms compile for each geometry and device count (about a
# second each on the CPU): all eight geometries on the JAX tests' 8
# devices, and at 2 and 3 ranks the ones with padded rows, an odd side or
# the deepest plan.  ``specmodel`` checks every geometry at every size.
JAX_HALO = {8: HALO_SHAPES,
            2: [(63, 64), (64, 63), (64, 270), (1920, 1080)],
            3: [(63, 64), (64, 63), (64, 270), (1920, 1080)]}


@functools.lru_cache(maxsize=None)
def _jax_halo(w, h, n):
    """JAX's forward (fine, coarse) of the halo image on n devices, and its
    inverse of that fine buffer, as numpy."""
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu.parallel import tiled as jt

    pyr, mesh = compute_pyramid(w, h), _jmesh(n)
    x = jax.device_put(jt.pad_rows(jnp.asarray(halo_image(w, h, _seed(w, h))),
                                   pyr, n),
                       NamedSharding(mesh, P("y", None, None)))

    @jax.jit
    def both(x):
        fine, coarse = jt.halo_dwt2d_fwd(x, mesh, pyr)
        return fine, coarse, jt.halo_dwt2d_inv(fine, mesh, pyr)

    return tuple(np.asarray(a) for a in both(x))


@functools.lru_cache(maxsize=None)
def _spec_fwd(w, h):
    from dwt_tpu import specmodel

    return specmodel.dwt2d_fwd(halo_image(w, h, _seed(w, h)), _pyr(w, h))


# --- the pure functions ----------------------------------------------------

@pytest.mark.parametrize("n", (1,) + WORLDS)
def test_plan_and_perms_equal_jax(n):
    """``_halo_plan``, ``pad_rows``, ``halo_perm`` and
    ``interleaved_to_pyramid_perm`` equal the JAX package's on a grid of
    geometries."""
    from dwt_tpu.geometry import compute_pyramid as jpyr
    from dwt_tpu.parallel import tiled as jt
    from dwt_tpu_torch.parallel import tiled as pt

    for w, h in PLAN_SHAPES:
        pyr, jp = _pyr(w, h), jpyr(w, h)
        assert pt._halo_plan(pyr, n) == jt._halo_plan(jp, n), (w, h)
        if h * w <= 1 << 20:  # the maps of 4K take seconds in numpy
            np.testing.assert_array_equal(pt.halo_perm(pyr, n),
                                          jt.halo_perm(jp, n))
            got = pt.interleaved_to_pyramid_perm(pyr)
            want = jt.interleaved_to_pyramid_perm(jp)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            x = np.arange(h * w * 2, dtype=np.int32).reshape(h, w, 2)
            np.testing.assert_array_equal(
                pt.pad_rows(torch.as_tensor(x), pyr, n).numpy(),
                np.asarray(jt.pad_rows(jnp.asarray(x), jp, n)))


# --- the halo transform ----------------------------------------------------

def _port_halo_fwd(ranks, w, h):
    """The whole fine buffer (rank blocks in order), every rank's coarse
    result and every rank's collectives."""
    res = ranks.run("halo_fwd", w=w, h=h, seed=_seed(w, h))
    return (np.concatenate([f for f, _, _ in res]), [c for _, c, _ in res],
            [log for _, _, log in res])


@pytest.mark.parametrize("w,h", HALO_SHAPES)
def test_halo_fwd_equals_jax(ranks, w, h):
    """``assemble_pyramid`` of the sharded transform equals
    ``specmodel.dwt2d_fwd``; the fine buffer, pad rows included, and the
    coarse result (the same on every rank) equal JAX's on as many devices
    (``JAX_HALO``)."""
    from dwt_tpu_torch.parallel import tiled as pt

    pyr = _pyr(w, h)
    fine, coarses, _ = _port_halo_fwd(ranks, w, h)
    for c in coarses[1:]:
        np.testing.assert_array_equal(c, coarses[0])
    got = pt.assemble_pyramid(torch.as_tensor(fine),
                              torch.as_tensor(coarses[0]), pyr, ranks.n)
    np.testing.assert_array_equal(got.numpy(), _spec_fwd(w, h))
    if (w, h) in JAX_HALO[ranks.n]:
        jfine, jcoarse, _ = _jax_halo(w, h, ranks.n)
        np.testing.assert_array_equal(fine, jfine)
        np.testing.assert_array_equal(coarses[0], jcoarse)


@pytest.mark.parametrize("w,h", HALO_SHAPES)
def test_halo_inv_restores_and_equals_jax(ranks, w, h):
    """``halo_dwt2d_inv`` of the forward transform's fine buffer gives the
    image back in its first H rows, and equals JAX's inverse of the same
    buffer on as many devices, pad rows included (``JAX_HALO``)."""
    fine, _, _ = _port_halo_fwd(ranks, w, h)
    spat = np.concatenate([s for s, _ in ranks.run("halo_inv", fine=fine,
                                                     w=w, h=h)])
    np.testing.assert_array_equal(spat[:h], halo_image(w, h, _seed(w, h)))
    if (w, h) in JAX_HALO[ranks.n]:
        np.testing.assert_array_equal(spat, _jax_halo(w, h, ranks.n)[2])


# --- the collective traffic (tests/test_comms.py's closed form) ------------

def _halo_messages(pyr, n_halo, C=3):
    """Each level's two boundary rows of w_act * C * 4 bytes, at each of
    the n - 1 rank boundaries."""
    L = pyr.levels
    return [pyr.widths[L - t] * C * 4 for t in range(n_halo) for _ in (0, 1)]


@pytest.mark.parametrize("wh", [(512, 720), (1920, 1080), (512, 512)])
def test_halo_traffic_is_ideal(ranks, wh):
    """Per level and per rank boundary, the forward sends exactly two
    messages of one active row (w_act * C * 4 bytes), one each way, and
    all-gathers the coarse grid once; the inverse sends the same rows and
    gathers nothing; nothing else communicates.  Checked at n = 8 (the JAX
    test's mesh) and at the fixture's other sizes alike."""
    from dwt_tpu_torch.parallel import tiled as pt

    W, H = wh
    pyr, n = _pyr(W, H), ranks.n
    n_halo, h_pad = pt._halo_plan(pyr, n)
    S = 1 << n_halo
    fine, _, logs = _port_halo_fwd(ranks, W, H)
    inv_logs = [log for _, log in ranks.run("halo_inv", fine=fine, w=W, h=H)]
    ideal = sorted(_halo_messages(pyr, n_halo) * (n - 1))
    for name, per_rank, gathers in (("fwd", logs, 1), ("inv", inv_logs, 0)):
        sends = sorted(b for log in per_rank for op, b in log if op == "send")
        assert sends == ideal, name
        for r, log in enumerate(per_rank):
            # The first rank has no previous and the last no next rank.
            assert sum(op == "send" for op, _ in log) == \
                n_halo * ((r > 0) + (r < n - 1))
            ags = [b for op, b in log if op == "all_gather"]
            assert ags == [(h_pad // S) * pyr.widths[pyr.levels - n_halo]
                           * 3 * 4] * gathers, name
            assert {op for op, _ in log} <= {"send", "all_gather"}
    # A vanishing share of a rank's rows: under four rows of the image.
    halo_bytes = sum(_halo_messages(pyr, n_halo))
    assert halo_bytes < 4 * W * 3 * 4
    if wh == (1920, 1080) and n == 8:
        assert halo_bytes / ((H // 8) * W * 3 * 4) < 0.04


# --- the sharded encoder and decoder ---------------------------------------

ENCODE_CASES = {"rgb": (96, 120, 3), "gray": (70, 53, 1)}


@functools.lru_cache(maxsize=None)
def _encode_case(name):
    """(image, JAX ShardedEncoder's stream on 8 devices, specmodel's).  The
    JAX package's bytes do not depend on its device count
    (tests/test_parallel.py holds them to specmodel's)."""
    from dwt_tpu import specmodel
    from dwt_tpu.parallel.encode import ShardedEncoder

    w, h, c = ENCODE_CASES[name]
    rng = np.random.default_rng(7 + c)
    if c == 3:  # tests/test_parallel.py's image: 120 rows pad at n = 8
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    else:
        img = random_image(rng, w, h, 1, "mixed")[..., 0]
    jax_stream = ShardedEncoder(w, h, c, _jmesh(8)).encode(img)
    return img, jax_stream, specmodel.encode(img, gray=c == 1)


@pytest.mark.parametrize("name", ENCODE_CASES)
def test_sharded_encoder_equals_jax(ranks, name):
    img, jax_stream, spec = _encode_case(name)
    assert jax_stream == spec
    for stream in ranks.run("encode", img=img):
        assert stream == jax_stream


@pytest.mark.parametrize("name", ENCODE_CASES)
def test_sharded_decoder_roundtrip_and_prefix(ranks, name):
    """The lossless stream decodes to the image on every rank; its 3/4
    prefix decodes to the port's single-stream ``decoder.decode``."""
    from dwt_tpu_torch.codec import decoder

    img, stream, _ = _encode_case(name)
    w, h, c = ENCODE_CASES[name]
    want = img.reshape(h, w, c)
    for out in ranks.run("decode", stream=stream, w=w, h=h, c=c):
        np.testing.assert_array_equal(out, want)
    cut = stream[:len(stream) * 3 // 4]
    want, _ = decoder.decode(cut, device="cpu")
    for out in ranks.run("decode", stream=cut, w=w, h=h, c=c):
        np.testing.assert_array_equal(out, want)


# --- the tile-parallel encode ----------------------------------------------

TILED_IMG = (96, 64)  # (H, W): six 32x32 tiles, dummies on 8 ranks


@functools.lru_cache(maxsize=None)
def _tiled_case():
    """(image, [(budget, JAX encode_tiled, JAX encode_tiled_sharded on 8
    devices)]) at budgets 0, 2/3 and 1/3 of the lossless container."""
    from dwt_tpu.codec.tiled import encode_tiled
    from dwt_tpu.parallel.encode import encode_tiled_sharded

    img = np.random.default_rng(11).integers(
        0, 256, TILED_IMG + (3,)).astype(np.uint8)
    full = encode_tiled(img, tile=(32, 32))
    return img, [(budget,
                  full if budget == 0 else
                  encode_tiled(img, tile=(32, 32), budget=budget),
                  encode_tiled_sharded(img, _jmesh(8), tile=(32, 32),
                                       budget=budget))
                 for budget in (0, len(full) * 2 // 3, len(full) // 3)]


@pytest.mark.parametrize("case", range(3), ids=("lossless", "2-3", "1-3"))
def test_tiled_sharded_equals_jax(ranks, case):
    img, cases = _tiled_case()
    budget, host, sharded = cases[case]
    assert host == sharded
    for got in ranks.run("encode_tiled", img=img, tile=(32, 32),
                         budget=budget):
        assert got == host
