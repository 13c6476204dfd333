"""The port's budgeted tiled encode gives the lossless encode of every tile
cut by ``allocate_budget``: the contract of ``encode_tiled`` and of both
packages' ``encode_tiled_sharded``.

The budgeted ``encode_tiled`` masks every tile's schedule past a
lower-bound waterline layer before stage 2.  A masked stream equals the
lossless one through the end of that layer, then holds a few bits of its
own; a tile whose cut's last byte reaches them is emitted again unmasked.
Exact: all of it is integer.  On the CPU each kernel wrapper runs its
plain PyTorch version.

Every image below falls into 9x9 tiles of widths 9 or 8 and heights 9 or
13, so the JAX package compiles four tile geometries for the module."""

import numpy as np
import pytest
import torch

from conftest import random_image

torch.set_num_threads(1)

TILE = (9, 9)
IMAGES = {"seed5": (17, 31, 5), "wide": (35, 22, 6), "tall": (26, 40, 7)}
CASES = [("seed5", 453)] + [(name, f"/{d}") for name in IMAGES
                            for d in (2, 3, 5, 9)]
IDS = [f"{name}-{b}" for name, b in CASES]


def _port():
    from dwt_tpu_torch.codec import tiled

    return tiled


def _image(name):
    w, h, seed = IMAGES[name]
    return random_image(np.random.default_rng(seed), w, h, 3, "mixed")


@pytest.fixture(scope="module")
def cases():
    """(name, budget) -> (image, budget in bytes, the JAX package's
    ``encode_tiled_sharded`` on a mesh of four CPU devices)."""
    import jax
    from jax.sharding import Mesh

    from dwt_tpu.parallel.encode import encode_tiled_sharded

    mesh = Mesh(np.array(jax.devices()[:4]), ("y",))
    out = {}
    for name, b in CASES:
        img = _image(name)
        if isinstance(b, str):
            full = _port().encode_tiled(img, TILE, device="cpu")
            budget = len(full) // int(b[1:])
        else:
            budget = b
        out[name, b] = (img, budget, encode_tiled_sharded(
            img, mesh, tile=TILE, budget=budget))
    return out


def _lossless(img, device="cpu"):
    """(payloads, layer byte ends) of every tile's lossless encode, in
    tile order."""
    groups, n = _port().group_tiles(img, TILE)
    payloads, ends = [None] * n, [None] * n
    for (hh, ww), items in groups.items():
        enc = _port().get_batch_encoder(ww, hh, 3, device)
        pls, lbs = enc.encode_raw(np.stack([t for _, t in items]))
        for (i, _), p, lb in zip(items, pls, lbs):
            payloads[i], ends[i] = p, lb
    return payloads, ends


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_budgeted_encode_equals_lossless_then_cut(cases, case):
    """``encode_tiled`` equals the port's ``encode_tiled_sharded`` on one
    rank and the JAX package's on four CPU devices, within the budget."""
    from dwt_tpu_torch.parallel import encode, hosts

    img, budget, want = cases[case]
    got = _port().encode_tiled(img, TILE, budget, device="cpu")
    assert got == want
    assert encode.encode_tiled_sharded(img, hosts.global_mesh("cpu"), TILE,
                                       budget) == want
    assert len(got) <= budget


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_masked_cuts_equal_lossless_cuts(cases, case):
    """The cuts allocated from the masked layer ends equal those from the
    lossless ones, and every tile's bytes are the lossless payload's
    prefix of that length."""
    tiled = _port()
    img, budget, _ = cases[case]
    groups, n = tiled.group_tiles(img, TILE)
    payloads, ends = tiled._budget_work(groups, 3, budget, n, "cpu")
    lossless, lossless_ends = _lossless(img)
    cuts = tiled.budget_cuts(ends, budget)
    assert np.array_equal(cuts, tiled.budget_cuts(lossless_ends, budget))
    assert [p[:c] for p, c in zip(payloads, cuts)] == \
        [p[:c] for p, c in zip(lossless, cuts)]


@pytest.mark.parametrize("case", CASES[:5], ids=IDS[:5])
def test_decode_equals_jax(cases, case):
    from dwt_tpu.codec import tiled as jt

    img, budget, data = cases[case]
    out, gray = _port().decode_tiled(data, device="cpu")
    assert not gray
    assert np.array_equal(out, np.asarray(jt.decode_tiled(data)[0]))


def test_reemit_repairs_the_seed5_case(cases, monkeypatch):
    """In the 17x31 image of seed 5 at 453 bytes, the masked streams' own
    bits reach into the last byte of some tiles' cuts: those tiles are
    emitted again unmasked, and the masked payloads alone differ from the
    lossless ones in exactly the last byte of those tiles' cuts."""
    tiled = _port()
    img, budget, want = cases["seed5", 453]
    lossless, ends = _lossless(img)
    cuts = tiled.budget_cuts(ends, budget)
    masked, again = [], []
    emit, reemit = tiled.BatchEncoder.emit_batch, tiled._reemit

    def spy(self, batch, padded_T=0):
        pls, e = emit(self, batch, padded_T)
        masked.extend(pls)
        return pls, e

    monkeypatch.setattr(tiled.BatchEncoder, "emit_batch", spy)
    monkeypatch.setattr(tiled, "_reemit",
                        lambda *a: (again.append(1), reemit(*a))[1])
    assert tiled.encode_tiled(img, TILE, budget, device="cpu") == want
    groups, n = tiled.group_tiles(img, TILE)
    order = [i for items in groups.values() for i, _ in items]
    by_tile = dict(zip(order, masked))
    differ = {}
    for i in range(n):
        a, b = by_tile[i][:cuts[i]], lossless[i][:cuts[i]]
        if a != b:
            differ[i] = [k for k in range(cuts[i]) if a[k] != b[k]]
    assert differ and len(again) >= len(differ)
    assert all(ks == [cuts[i] - 1] for i, ks in differ.items())


def _tile_ends(data):
    """The end offset of every tile's bytes in a container."""
    ntx, nty = _port()._tile_grid(*np.frombuffer(data[4:12], "<u4"),
                                  *np.frombuffer(data[12:16], "<u2"))
    table = np.frombuffer(data[16:16 + 4 * ntx * nty], "<u4")
    return 16 + 4 * table.size + np.cumsum(table.astype(np.int64))


def test_jax_encode_tiled_breaks_its_contract_on_the_cpu(cases):
    """A fact of the JAX package, not of the port: on the CPU its budgeted
    ``encode_tiled`` differs from its own ``encode_tiled_sharded`` in the
    seed-5 case and others, in the last byte of some tiles (its masked
    streams' bits past the kept layer's end, ROADMAP).  Where it meets its
    contract, the port equals it."""
    from dwt_tpu.codec import tiled as jt

    broken = []
    for case, (img, budget, want) in cases.items():
        got = jt.encode_tiled(img, tile=TILE, budget=budget)
        if got == want:
            assert _port().encode_tiled(img, TILE, budget,
                                        device="cpu") == got
            continue
        broken.append(case)
        assert len(got) == len(want)
        diff = np.flatnonzero(np.frombuffer(got, np.uint8)
                              != np.frombuffer(want, np.uint8))
        assert set(diff + 1) <= set(_tile_ends(want).tolist())
    assert ("seed5", 453) in broken


GRAY = [(40, 36, 12), (33, 27, 8)]


@pytest.mark.parametrize("div", [2, 3, 5, 9])
@pytest.mark.parametrize("w,h,t", GRAY)
def test_gray_budgeted_encode_equals_sharded(w, h, t, div):
    """Gray images in other tile sizes: the port's two routes agree."""
    from dwt_tpu_torch.parallel import encode, hosts

    img = random_image(np.random.default_rng(w), w, h, 1, "mixed")
    tiled = _port()
    budget = len(tiled.encode_tiled(img, (t, t), device="cpu")) // div
    assert tiled.encode_tiled(img, (t, t), budget, device="cpu") == \
        encode.encode_tiled_sharded(img, hosts.global_mesh("cpu"), (t, t),
                                    budget)
