"""Kernel 17, the emit half's step tables (``dwt_tpu_torch/ops/
emit_tables.py``, ``csrc/emit_tables.cu``), on the CPU.

* Its plain version against the JAX package on the JAX pipeline's own
  inputs: each step's first refinement bit (``_codeword_contribs``), the
  bit partials (``_bit_partials``), kernel B's meta (``_kernel_b_meta``)
  and the layer ends (``_layer_boundaries`` at the int32 total), exactly,
  on grey and RGB frames from 8x8 to 320x240 (flat, noise, mixed), on a
  batch of three unlike frames at one bucket above every T (frame by
  frame after the f * nwords offsets) and on schedules cut as the
  budgeted tiled path cuts them (``_truncate_schedule_to_layer``).
* The kernel's plan replayed in numpy block by block (frames a block,
  blocks a frame, :func:`launch_plan`): the pairs gathered in schedule
  order where ``order`` is a permutation whose sites never decrease,
  else the bitonic network; the runs-a-thread scan, the binary searches,
  the layer buckets, and the meta rows with each unit's level prefix in
  closed form from the chunk tables' level scans, every frame's tables
  written by one block and every row by one thread, against the plain
  version on the frames above, on seeded tables at the edges (tied and
  clamped sites, wrapping sums, up to 2,048 steps, clamped word windows,
  orders that are no permutation) and on tables in schedule order from
  kernel 14's plain version; the plan at the main path's geometries.
* The closed form of that prefix against the plain version's level scan,
  and the sites in schedule order on every encode path.
* ``emit._stage2_emit`` makes no eager pass over the step tables outside
  the wrapper, and the wrapper's checks.

The kernel runs only on the card: ``tests/test_torch_card.py`` holds it
against this plain version there.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from imagegen import random_image

torch.set_num_threads(1)

PMAX = 29
LMAX = 64

FRAMES = [(8, 8, 1, "mixed"), (9, 8, 3, "noise"), (64, 64, 3, "flat"),
          (64, 64, 1, "mixed"), (96, 80, 3, "noise"), (128, 32, 1, "mixed"),
          (320, 240, 3, "mixed")]


def _jax_frame(img, padded_T=None, layer=None) -> dict:
    """The JAX package's pipeline on one frame, the schedule cut at quality
    layer ``layer`` where given, at token bucket ``padded_T`` (default:
    its own): kernel 17's inputs and the JAX package's tables, as numpy."""
    import jax
    import jax.numpy as jnp

    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu.hilbert import padded_layout

    h, w, c = img.shape
    pyr = compute_pyramid(w, h)
    perm, _, _ = padded_layout(pyr, je.ALIGN)
    lin, stats = jax.jit(lambda x, p: je._transform_and_stats(
        x, pyr, c, c == 1, p, engine=False))(jnp.asarray(img),
                                             jnp.asarray(perm))
    T = int(stats["T"])
    if layer is not None:
        host = jax.device_get({k: stats[k] for k in je._TRUNC_STATS_KEYS})
        upd = je._truncate_schedule_to_layer(host, layer, pyr, c)
        assert upd is not None, "the cut masks nothing"
        stats = {**stats, **{k: jnp.asarray(v) for k, v in upd.items()}}
        T = int(upd["T"])
    padded_T = padded_T or je._bucket(T)
    nwords = je._stream_words(pyr, c, padded_T)

    def stage2(lin, stats):
        tv, tr, tf, orders = je._stage2_tokens(lin, stats, pyr, c, padded_T)
        nbits, nref, off, refstart, *_ = je._codeword_contribs(
            stats, tv, tr, tf, orders, padded_T)
        segs = je._Segs(pyr)
        com = je._unit_common(stats, segs, pyr, c)
        meta = je._kernel_b_meta(stats, segs, com, refstart, pyr, padded_T,
                                 nwords)
        parts = je._bit_partials(nbits, nref)
        ends = je._layer_boundaries(stats, off, jnp.sum(parts,
                                                        dtype=jnp.int32),
                                    pyr, c)
        r = (-padded_T) % 2048
        chunks = jnp.concatenate([nbits, jnp.zeros(r, jnp.int32)]).reshape(
            -1, 2048).sum(axis=1, dtype=jnp.int32)
        return dict(off=off, chunks=chunks, nref=nref, refstart=refstart,
                    meta=meta, parts=parts, ends=ends, com=com)

    monkey = pytest.MonkeyPatch()
    monkey.setattr(je, "_use_pallas", lambda: False)
    try:
        out = jax.device_get(jax.jit(stage2)(lin, stats))
    finally:
        monkey.undo()
    out["stats"] = jax.device_get(stats)
    out.update(T=T, padded_T=padded_T, nwords=nwords, pyr=pyr, c=c)
    return out


def _level_scans(x, lcb, lnc) -> np.ndarray:
    """(..., nchunk, PMAX) chunk table -> its level-exclusive scan over the
    chunks, in wrapping int32 (kernel 14's ``scar_ck`` and ``zcar_ck``)."""
    x = np.asarray(x, np.int64)
    out = np.zeros_like(x)
    for b, c in zip(lcb, lnc):
        seg = x[..., b:b + c, :]
        out[..., b:b + c, :] = np.cumsum(seg, axis=-2) - seg
    return _wrap(out)


def _inputs(runs: list) -> tuple:
    """Kernel 17's arguments over the frames of ``runs`` (one geometry, one
    bucket), stacked on a leading axis, on the CPU."""
    from dwt_tpu_torch.codec.stage1 import segs_for
    from dwt_tpu_torch.ops.units import COM_KEYS

    r0 = runs[0]
    segs = segs_for(r0["pyr"], "cpu")

    def stack(get, dtype=torch.int32):
        return torch.as_tensor(np.stack([get(r) for r in runs])).to(dtype)

    def scan(k):
        return lambda r: _level_scans(r["stats"][k], segs.level_chunk_base,
                                      segs.level_nchunk)

    args = [stack(lambda r: r["off"]), stack(lambda r: r["chunks"]),
            stack(lambda r: r["nref"]),
            stack(lambda r: np.clip(r["stats"]["inj_pos"].reshape(-1), 0,
                                    r["padded_T"])),
            stack(lambda r: r["stats"]["order"])]
    args += [stack(lambda r, k=k: r["stats"][k]) for k in (
        "step_end", "refpfx", "step_base", "planes", "planes_max", "nS_ck",
        "nZ_ck")]
    args += [stack(scan("nS_ck")), stack(scan("nZ_ck"))]
    args += [stack(lambda r, k=k: r["com"][k],
                   torch.bool if k == "valid" else torch.int32)
             for k in COM_KEYS]
    args += [segs.ch_valid_t, segs.vcar_t, segs.level_chunk_base_t,
             segs.level_nchunk_t]
    return tuple(args) + (segs.n, r0["nwords"])


def _same_as_jax(runs: list, got: tuple) -> None:
    """The wrapper's outputs over the frames of ``runs`` equal the JAX
    package's tables of each frame, kernel B's meta after frame f's
    element-row and word offsets."""
    from dwt_tpu_torch.codec.stage1 import segs_for
    from dwt_tpu_torch.ops import compact

    refstart, parts, meta, ends, head = got
    n = segs_for(runs[0]["pyr"], "cpu").n
    U = meta.shape[0] // len(runs)
    for f, r in enumerate(runs):
        for name, g, w in (("refstart", refstart[f], r["refstart"]),
                           ("bits_parts", parts[f], r["parts"]),
                           ("layer_ends", ends[f], r["ends"])):
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w), (name, f)
        m = meta[f * U:(f + 1) * U].numpy().copy()
        m[:, 0] -= f * r["c"] * n // compact.SUBB
        m[:, 3] -= f * r["nwords"]
        assert np.array_equal(m, np.asarray(r["meta"])), ("meta", f)
    assert head[0] == 0
    assert torch.equal(head[1:1 + parts.numel()], parts.reshape(-1))
    assert torch.equal(head[1 + parts.numel():], ends.reshape(-1))


@pytest.fixture(scope="module")
def runs() -> dict:
    """Case name -> the JAX package's runs of its frames (made once)."""
    cache: dict = {}

    def get(name: str) -> list:
        if name not in cache:
            if name.startswith("frame"):
                w, h, c, kind = FRAMES[int(name[5:])]
                rng = np.random.default_rng(w * h + c)
                cache[name] = [_jax_frame(random_image(rng, w, h, c, kind))]
            elif name == "batch":
                from dwt_tpu.codec import encoder as je

                rng = np.random.default_rng(3)
                imgs = [random_image(rng, 64, 48, 3, k)
                        for k in ("flat", "noise", "mixed")]
                top = max(_jax_frame(i)["T"] for i in imgs)
                b = je._bucket(je._bucket(top) + 1)
                cache[name] = [_jax_frame(i, b) for i in imgs]
            else:
                w, h, c, kind, layer = {"cut 1": (96, 80, 3, "mixed", 1),
                                        "cut 3": (64, 64, 1, "noise", 3)}[
                                            name]
                rng = np.random.default_rng(w + layer)
                cache[name] = [_jax_frame(random_image(rng, w, h, c, kind),
                                          layer=layer)]
        return cache[name]

    return get


CASES = [f"frame{i}" for i in range(len(FRAMES))] + ["batch", "cut 1",
                                                     "cut 3"]


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_jax(runs, case):
    """The wrapper on the CPU (its plain version) on the JAX pipeline's
    inputs equals the JAX package's tables; the frames of the batch lie
    at one bucket above every T, and each is held to its own JAX run at
    that bucket."""
    from dwt_tpu_torch.codec import emit
    from dwt_tpu_torch.codec.stage1 import segs_for
    from dwt_tpu_torch.ops import emit_tables

    rs = runs(case)
    if case == "batch":
        assert rs[0]["padded_T"] > max(r["T"] for r in rs)
        assert len({r["padded_T"] for r in rs}) == 1
    args = _inputs(rs)
    got = emit_tables.emit_tables(*args)
    _same_as_jax(rs, got)
    # the plain version's parts, by the encoder's names
    st = {k: args[5 + i] for i, k in enumerate(
        ("step_end", "refpfx", "step_base", "planes", "planes_max", "nS_ck",
         "nZ_ck"))}
    from dwt_tpu_torch.ops.units import COM_KEYS

    com = dict(zip(COM_KEYS, args[14:20]))
    segs = segs_for(rs[0]["pyr"], "cpu")
    assert torch.equal(emit._bit_partials(args[1], args[2]), got[1])
    assert torch.equal(emit._kernel_b_meta(st, segs, com, got[0], None, 0,
                                           args[-1]), got[2])
    assert torch.equal(emit._layer_boundaries(
        st, args[0], got[1].sum(dim=1, dtype=torch.int32), None, 0), got[3])


# ---------------------------------------------------------------------------
# The kernel's plan, replayed in numpy.

def _wrap(x) -> np.ndarray:
    """int64 values -> their int32 bit patterns (wrapping)."""
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(
        np.int32)


def _flip(site) -> np.ndarray:
    """Sites as the kernel's keys hold them: the sign bit flipped, so that
    an unsigned compare orders them as signed ints."""
    return (np.asarray(site, np.int64) & 0xFFFFFFFF) ^ 0x80000000


def _bitonic(key: np.ndarray, tf: int) -> np.ndarray:
    """The bitonic network of ``emit_tables_kernel`` on ``np`` keys (a
    power of two) by a group of ``tf`` threads: thread q of a stage takes
    pairs q, q + tf, ..., each pair (i, i + j) once."""
    key, n = key.copy(), key.size
    k = 2
    while k <= n:
        j = k >> 1
        while j:
            q = np.arange(n // 2)  # thread q % tf, its turn q // tf
            i = 2 * q - (q & (j - 1))
            assert len(set(i) | set(i + j)) == n  # every key, once
            a, b = key[i].copy(), key[i + j].copy()
            swap = (a > b) == ((i & k) == 0)
            key[i], key[i + j] = np.where(swap, b, a), np.where(swap, a, b)
            j >>= 1
        k <<= 1
    assert np.all(key[1:] >= key[:-1])
    return key


def _group_steps(f, b, a, plan):
    """One group of ``emit_tables_kernel`` (frame f, its block b) on the
    numpy arguments ``a``: (sorted, its keys' sites, the scan, refstart
    (S,), parts (K,) and ends (LMAX,) where b is 0, else None)."""
    np_, tf = plan[:2]
    off, chunks, nref, site, order = (a[k][f] for k in (
        "off", "chunks", "nref", "site", "order"))
    S, T = nref.size, off.size
    end = np.clip(a["step_end"][f].reshape(-1), 0, T - 1)
    # 2. the pairs through order, checked to be a permutation whose sites
    # never decrease; else the frame's pairs sorted
    perm = bool(np.all((order >= 0) & (order < S))
                and np.unique(order).size == S)
    sites = _flip(site[order]) if perm else None
    srt = not perm or bool(np.any(np.diff(sites) < 0))
    if srt:
        key = np.full(np_, np.iinfo(np.uint64).max, np.uint64)
        key[:S] = ((_flip(site).astype(np.uint64) << np.uint64(32))
                   | nref.astype(np.uint32).astype(np.uint64))
        key = _bitonic(key, tf)[:S]
        sites = (key >> np.uint64(32)).astype(np.int64)
        vals = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    else:
        vals = nref[order]
    # 3. the scan: thread t's run of R keys (a key a thread where the
    # group has more threads than keys), warps' inclusive scans, the
    # earlier warps' totals
    R = max(np_ // tf, 1)
    v = np.zeros(tf * R, np.int64)
    v[:S] = vals
    runs = v.reshape(tf, R)
    x = runs.sum(axis=1).reshape(-1, 32)
    incl = np.cumsum(x, axis=1)
    prev = np.concatenate([[0], np.cumsum(incl[:, -1])[:-1]])
    before = (incl - x + prev[:, None]).reshape(-1)
    scan = _wrap(before[:, None] + np.cumsum(runs, axis=1)).reshape(-1)[
        :np_]
    cnt = np.searchsorted(sites, _flip(end), side="right")
    inj = np.where(cnt > 0, scan[np.maximum(cnt - 1, 0)], 0)
    refstart = _wrap(off[end].astype(np.int64) - inj
                     + a["refpfx"][f].reshape(-1))
    if b:
        return srt, sites, scan, refstart, None, None
    C, L = a["step_end"].shape[1:3]
    pm, planes = int(a["planes_max"][f]), a["planes"][f]
    parts = [_wrap(chunks[j:j + 512].astype(np.int64).sum())
             for j in range(0, chunks.size, 512)]
    parts += [_wrap(nref[j:j + 8].astype(np.int64).sum())
              for j in range(0, S, 8)]
    parts = np.asarray(parts, np.int32)
    tot = _wrap(parts.astype(np.int64).sum())
    smin = np.full(LMAX + 1, 2**31 - 1, np.int64)
    base = np.clip(a["step_base"][f].reshape(-1), 0, T - 1)
    for s in range(S):
        c, l, p = s // (L * PMAX), (s // PMAX) % L, s % PMAX
        if p < planes[c]:
            layer = (pm - 2 if c == 0 else pm - 1) - p + l
            bucket = min(max(layer, -1) + 1, LMAX)
            smin[bucket] = min(smin[bucket], off[base[s]])
    ends = np.array([min(smin[k + 1:].min(), tot) for k in range(LMAX)],
                    np.int32)
    return srt, sites, scan, refstart, parts, ends


def _closed_rcar(a, f, fck) -> np.ndarray:
    """The closed-form level prefix of refinement bits of units at chunk
    slots ``fck`` of frame f: [p < planes_max] (vcar - scar_ck - zcar_ck)
    at the slot, in wrapping int32."""
    nchunk = a["ch_valid"].size
    p, k = fck % PMAX, (fck // PMAX) % nchunk
    r = (a["vcar"][k].astype(np.int64) - a["scar_ck"][f].reshape(-1)[fck]
         - a["zcar_ck"][f].reshape(-1)[fck])
    return np.where(p < a["planes_max"][f], _wrap(r), 0).astype(np.int32)


def _args_np(args) -> dict:
    from dwt_tpu_torch.ops import emit_tables

    a = {k: t.numpy() for k, t in zip(emit_tables._IN_NAMES, args[:24])}
    a["nref"], a["site"] = a.pop("nref_step"), a.pop("inj_site")
    a["n"], a["nwords"] = args[24:]
    return a


def _replay(args) -> tuple:
    """``emit_tables_kernel`` block by block (numpy) on the wrapper's
    arguments, at the plan the kernel launches (:func:`launch_plan`):
    (refstart, bits_parts, meta,
    layer_ends, each frame's branch: True where it sorted).  Every frame's
    step tables are written by its first block alone and every meta row by
    one thread of one block."""
    from dwt_tpu_torch.ops import compact, emit_tables

    a = _args_np(args)
    N, C, L = a["step_end"].shape[:3]
    S, U = C * L * PMAX, a["elem"].shape[1]
    plan = emit_tables.launch_plan(S, U)
    np_, tf, fpb, bpf, ub = plan
    assert fpb * tf <= emit_tables.BLOCK and np_ <= emit_tables.MAX_RUN * tf
    assert ub <= emit_tables.MAX_UPT * tf and ub * (bpf - (bpf > 1)) >= U
    # the kernel's instances: 8 keys a thread only with 4 units
    assert np_ <= 4 * tf or ub <= emit_tables.UPT * tf
    K = emit_tables.parts_count(a["chunks"].shape[1], S)
    refstart = np.zeros((N, S), np.int32)
    parts = np.zeros((N, K), np.int32)
    ends = np.zeros((N, LMAX), np.int32)
    meta = np.zeros((N * U, 8), np.int64)
    wrote = np.zeros(N * U, int)
    firsts = np.zeros(N, int)
    branch = [None] * N
    wsmax = (a["nwords"] - compact.WREF) // 128 * 128
    nchunk = a["ch_valid"].size
    for blk in range(-(-N // fpb) * bpf):
        for g in range(fpb):
            f, b = blk // bpf * fpb + g, blk % bpf
            if f >= N:
                continue
            srt, _, _, ref, pf, en = _group_steps(f, b, a, plan)
            assert branch[f] in (None, srt)
            branch[f] = srt
            if b == 0:
                firsts[f] += 1
                refstart[f], parts[f], ends[f] = ref, pf, en
            # the units: the one block's, or blocks 1 to bpf - 1's
            u0 = 0 if bpf == 1 else max(b - 1, 0) * ub
            u = np.arange(u0, U if bpf == 1 else u0 if b == 0
                          else min(U, u0 + ub))
            assert u.size <= emit_tables.MAX_UPT * tf
            i = f * U + u
            fck, fst = a["flat_ck"][f][u], a["flat_step"][f][u]
            bit0 = _wrap(ref[fst].astype(np.int64) + _closed_rcar(a, f, fck))
            k = (fck // PMAX) % nchunk
            live = fck % PMAX < a["planes_max"][f]
            nR = np.where(live & a["valid"][f][u], _wrap(
                a["ch_valid"][k].astype(np.int64)
                - a["nS_ck"][f].reshape(-1)[fck]
                - a["nZ_ck"][f].reshape(-1)[fck]), 0)
            ws = np.minimum(np.maximum((bit0 >> 5) & ~127, 0), wsmax)
            row = _wrap(a["elem"][f][u].astype(np.int64) + f * C * a["n"])
            z = np.zeros(u.size, np.int64)
            meta[i] = np.stack([row >> 10, a["elen"][f][u], a["p"][f][u],
                                _wrap(ws.astype(np.int64)
                                      + f * a["nwords"]),
                                _wrap(bit0.astype(np.int64)
                                      - 32 * ws.astype(np.int64)),
                                z, nR, z], axis=1)
            wrote[i] += 1
    assert np.all(wrote == 1) and np.all(firsts == 1)
    return (refstart.reshape(N, C, L, PMAX), parts, _wrap(meta), ends,
            branch)


def _same_as_replay(args) -> list:
    """The replay equals the plain version; returns its branches."""
    from dwt_tpu_torch.ops import emit_tables

    got = emit_tables.emit_tables_plain(*args)
    want = _replay(args)
    for name, g, w in zip(("refstart", "bits_parts", "meta", "layer_ends"),
                          got, want):
        assert g.numpy().shape == w.shape, name
        assert np.array_equal(g.numpy(), w), name
    return want[4]


@pytest.mark.parametrize("case", ["frame2", "frame6", "batch", "cut 1"])
def test_plan_replayed_on_frames(runs, case):
    """The replayed kernel equals the plain version on the JAX pipeline's
    inputs, every frame in schedule order (no sort)."""
    assert not any(_same_as_replay(_inputs(runs(case))))


def _seeded(rng, N, C, L, lnc, T, nwords, n=1 << 16, order="random"):
    """Seeded kernel-17 arguments: N frames of C channels and L levels of
    ``lnc`` chunks each, T token slots; tied sites, sites at 0 and T,
    step ends past both edges, refinement counts that wrap int32 sums,
    random unit columns (any in-range steps and chunks), the chunk
    tables' level scans as kernel 14 makes them.  ``order``: a random
    permutation ("random"), a sequence that is not one ("none"), or the
    permutation that puts the sites in order ("sorted")."""
    S, nchunk = C * L * PMAX, int(sum(lnc))
    U = C * nchunk * PMAX

    def i32(*shape, lo=-2**31, hi=2**31):
        return torch.as_tensor(rng.integers(lo, hi, shape), dtype=torch.int32)

    site = rng.choice([0, T, T // 2, T - 1, 1], size=(N, S))
    site = np.where(rng.random((N, S)) < 0.5, rng.integers(0, T + 1, (N, S)),
                    site)
    nref = np.where(rng.random((N, S)) < 0.3, 0,
                    rng.integers(0, 2**30, (N, S)))
    planes = rng.integers(0, PMAX + 1, (N, C))
    lcb = np.concatenate([[0], np.cumsum(lnc)[:-1]])
    if order == "sorted":
        perm = np.argsort(site, axis=1, kind="stable")
    elif order == "random":
        perm = np.argsort(rng.random((N, S)), axis=1)
    else:
        perm = rng.integers(0, S, (N, S))
        perm[:, 0] = perm[:, -1]
    nS = rng.integers(0, 5000, (N, C, nchunk, PMAX))
    nZ = rng.integers(0, 70000, (N, C, nchunk, PMAX))
    ch_valid = rng.integers(0, 65537, nchunk)

    def t32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32)

    return (i32(N, T), i32(N, -(-T // 2048), lo=0, hi=2**17), t32(nref),
            t32(site), t32(perm), i32(N, C, L, PMAX, lo=-3, hi=T + 3),
            i32(N, C, L, PMAX), i32(N, C, L, PMAX, lo=-3, hi=T + 3),
            t32(planes), i32(N, lo=0, hi=PMAX + 1), t32(nS), t32(nZ),
            t32(_level_scans(nS, lcb, lnc)), t32(_level_scans(nZ, lcb, lnc)),
            i32(N, U, lo=0, hi=C * n), i32(N, U, lo=1, hi=65537),
            i32(N, U, lo=0, hi=PMAX), i32(N, U, lo=0, hi=S),
            i32(N, U, lo=0, hi=U),
            torch.as_tensor(rng.random((N, U)) < 0.7), t32(ch_valid),
            t32(_level_scans(ch_valid[:, None], lcb, lnc)[:, 0]), t32(lcb),
            t32(lnc), n, nwords)


def _scheduled(rng, N, C, L, lnc, nwords=40_000, n=1 << 16):
    """Kernel-17 arguments in schedule order: kernel 14's plain version on
    seeded planes and chunk tables (frame 0 without planes, frame 2's
    channel 0 with every plane), kernel 15's plain unit columns from it,
    the injection sites and refinement counts as ``emit._codeword_contribs``
    makes them, seeded token offsets and chunk sums at a bucket above
    every T; on the CPU."""
    from dwt_tpu_torch.ops import schedule, units

    def t32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32)

    nchunk = int(sum(lnc))
    ck = (N, C, nchunk, PMAX)
    planes = rng.integers(0, PMAX + 1, (N, C))
    planes[0] = 0
    if N > 2:
        planes[2, 0] = PMAX
    lcb = np.concatenate([[0], np.cumsum(lnc)[:-1]])
    ch_len = rng.integers(1, 65537, nchunk)
    args = tuple(map(t32, (
        planes, np.where(rng.random(ck) < 0.5, 0, rng.integers(0, 40, ck)),
        rng.integers(-1, 6, ck), rng.integers(0, 300, (N, C, nchunk)),
        rng.integers(0, 50, ck), rng.integers(-70, 70, (N, C, 7)),
        rng.integers(100, 900, L), lcb, lnc)))
    st = dict(zip(schedule.OUT_KEYS, schedule.schedule_plain(*args)))
    T = 1 << max(11, int(st["T"].max()).bit_length())
    com = units.unit_tables_plain(
        st["order"], st["ubase_sched"], st["valid_sched"], st["step_base"],
        st["nS_ck"], st["scar_ck"], st["zcar_ck"], args[7],
        t32(np.cumsum(ch_len) - ch_len), t32(ch_len), n, T)[:6]
    ch_valid = rng.integers(0, 65537, nchunk)
    S = C * L * PMAX
    return (t32(rng.integers(-2**31, 2**31, (N, T))),
            t32(rng.integers(0, 2**17, (N, -(-T // 2048)))),
            torch.where(st["valid"], st["nRef"], 0).reshape(N, S),
            st["inj_pos"].reshape(N, S).clamp(0, T), st["order"],
            st["step_end"], st["refpfx"], st["step_base"], st["planes"],
            st["planes_max"], st["nS_ck"], st["nZ_ck"], st["scar_ck"],
            st["zcar_ck"], *com, t32(ch_valid),
            t32(_level_scans(ch_valid[:, None], lcb, lnc)[:, 0]), args[7],
            args[8], n, nwords)


@pytest.mark.parametrize("N,C,L,T,nwords,order", [
    (1, 1, 1, 4096, 9000, "random"), (3, 1, 2, 5000, 1000, "none"),
    (2, 3, 4, 8192, 2**20, "random"), (1, 3, 23, 9000, 50_000, "random"),
    (1, 1, 70, 2048, 3000, "sorted"), (4, 2, 1, 3, 5000, "random"),
    (9, 3, 2, 3000, 4000, "sorted"), (2, 3, 23, 9000, 50_000, "none"),
    (2, 1, 4, 4096, 9000, "sorted"), (3, 1, 4, 5000, 9000, "random")])
def test_plan_replayed_on_seeded_tables(N, C, L, T, nwords, order):
    """The replayed kernel equals the plain version on seeded tables at the
    edges: up to 2,001 and 2,030 steps a frame, groups of 32 to 256
    threads (more threads than keys: 116 steps of 464 units), word
    windows clamped below and above (and a frame's words fewer than a
    window); an order that is no permutation, or a random one, takes the
    sort, sites already in order do not."""
    rng = np.random.default_rng(N * 1000 + C * 100 + L)
    lnc = np.full(L, 4) if (C, L) == (1, 4) else rng.integers(1, 5, L)
    branch = _same_as_replay(_seeded(rng, N, C, L, lnc, T, nwords,
                                     order=order))
    assert all(branch) if order != "sorted" else not any(branch)


@pytest.mark.parametrize("N,C,L", [(1, 1, 1), (3, 3, 2), (4, 3, 2),
                                   (5, 3, 2), (9, 3, 2), (17, 3, 2),
                                   (3, 3, 7), (3, 1, 24), (2, 3, 9),
                                   (2, 1, 4), (3, 1, 2)])
def test_plan_replayed_on_scheduled_tables(N, C, L):
    """On tables in schedule order (kernel 14's and 15's plain versions on
    seeded planes) the replayed kernel takes no sort and equals the plain
    version, at frame counts either side of 4 frames a block (16x16 RGB
    tiles' 2 levels), at many blocks a frame, at blocks of more threads
    than keys, and at 6 units a thread of a small frame's group."""
    rng = np.random.default_rng(N * 100 + C * 10 + L)
    # 16x16 tiles: a chunk a level; (1, 4): more units than 8 a thread of
    # np / 4 threads, so a larger frame's blocks of more threads than keys;
    # (1, 2): 174 units a group of 32 threads
    lnc = (np.ones(L, int) if (C, L) == (3, 2) else np.full(L, 4)
           if (C, L) == (1, 4) else np.full(L, 3) if (C, L) == (1, 2)
           else rng.integers(1, 7, L))
    args = _scheduled(rng, N, C, L, lnc)
    from dwt_tpu_torch.ops import emit_tables

    plan = emit_tables.launch_plan(C * L * PMAX, args[14].shape[1])
    assert (C, L) != (3, 2) or plan[2:4] == (4, 1)
    assert (C, L) != (1, 2) or plan == (64, 32, 8, 1, 174)
    assert not any(_same_as_replay(args))


def test_closed_form_rcar_equals_the_level_scan():
    """The unit's level prefix of refinement bits in closed form, [p <
    planes_max] (vcar - scar_ck - zcar_ck), equals the level scan of
    ``kernel_b_meta_plain`` at every (frame, channel, chunk, plane) slot,
    planes at and above planes_max among them, wrapping sums too."""
    from dwt_tpu_torch.ops import emit_tables

    rng = np.random.default_rng(27)
    N, C, L = 5, 3, 6
    lnc = rng.integers(1, 9, L)
    args = list(_seeded(rng, N, C, L, lnc, 4096, 2**20))
    U = C * int(lnc.sum()) * PMAX
    nZ = rng.integers(-2**31, 2**31, args[11].shape)
    args[11] = torch.as_tensor(nZ, dtype=torch.int32)
    args[13] = torch.as_tensor(_level_scans(nZ, args[22].numpy(), lnc))
    args[9] = torch.tensor([0, 1, 14, PMAX - 1, PMAX], dtype=torch.int32)
    fck = np.arange(U, dtype=np.int32)
    args[18] = torch.as_tensor(np.tile(fck, (N, 1)))
    a = _args_np(args)
    refstart, _, meta, _, _ = emit_tables.emit_tables_plain(*args)
    meta = meta.numpy().astype(np.int64).reshape(N, U, 8)
    ws = meta[..., 3] - np.arange(N)[:, None] * a["nwords"]
    rcar = _wrap(meta[..., 4] + 32 * ws - refstart.numpy().reshape(N, -1)[
        np.arange(N)[:, None], a["flat_step"]])
    for f in range(N):
        assert np.array_equal(rcar[f], _closed_rcar(a, f, fck)), f
    assert (rcar == 0).any() and (np.abs(rcar) > 2**30).any()


@pytest.mark.parametrize("w,h,frames", [(16, 16, 29_126), (512, 512, 61),
                                        (1920, 1080, 7), (3840, 2160, 1)])
def test_launch_plan_at_the_main_geometries(w, h, frames):
    """The launch at the main path's sub-batches: 16x16 RGB tiles 4 frames
    a block of 8 warps, 2 warps a frame; 512x512 tiles, 1080p and 4K
    frames a block of 8 warps for the step tables and 1, 4 and 12 more for
    the units; each group within its keys, units and shared memory, every
    frame's step tables and every unit covered once by the block indices
    the kernel reads."""
    from dwt_tpu_torch.codec.stage1 import segs_for
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import emit_tables

    segs = segs_for(compute_pyramid(w, h), "cpu")
    S, U = 3 * segs.L * PMAX, 3 * segs.nchunk * PMAX
    np_, tf, fpb, bpf, ub = emit_tables.launch_plan(S, U)
    want = {16: (256, 64, 4, 1), 512: (1024, 256, 1, 2),
            1920: (1024, 256, 1, 5), 3840: (1024, 256, 1, 13)}[w]
    assert (np_, tf, fpb, bpf) == want
    group = 16 * np_ + 4 * (LMAX + 4) + np_ // 8 + 48
    assert fpb * group <= 48 * 1024 and fpb * tf <= 256
    assert np_ >= S and np_ <= 8 * tf and ub <= 8 * tf
    tables = np.zeros(frames, int)
    units = np.zeros((frames, U), int)
    for blk in range(-(-frames // fpb) * bpf):
        for g in range(fpb):
            f, b = blk // bpf * fpb + g, blk % bpf
            if f < frames:
                tables[f] += b == 0
                u0 = 0 if bpf == 1 else max(b - 1, 0) * ub
                u1 = U if bpf == 1 else u0 if b == 0 else min(U, u0 + ub)
                units[f, u0:u1] += 1
    assert np.all(tables == 1) and np.all(units == 1)


def test_steps_threads():
    """The threads of a frame's group: np / 4 and at least a warp where
    frames of at most 256 keys share a block, else a block of 256; eight
    keys a thread at most, holding every step; past 2,048 steps a frame
    the plan raises."""
    from dwt_tpu_torch.ops import emit_tables

    assert [emit_tables.launch_plan(s, 1)[:3]
            for s in (1, 64, 65, 256, 257, 783, 2048)] == [
        (64, 32, 8), (64, 32, 8), (128, 32, 8), (256, 64, 4), (512, 256, 1),
        (1024, 256, 1), (2048, 256, 1)]
    with pytest.raises(ValueError, match="2048"):
        emit_tables.launch_plan(2049, 1)


# ---------------------------------------------------------------------------
# The encoder around the wrapper, and the wrapper's checks.

_VIEWS = {"view", "_unsafe_view", "reshape", "slice", "alias", "as_strided",
          "select", "unsqueeze", "expand", "detach", "t", "transpose"}


class _Record(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] not in _VIEWS:
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    self.ops.append((func.__name__, tuple(o.shape)))
        return out


def test_stage2_emit_runs_no_eager_step_tables(monkeypatch):
    """On the CPU, ``emit._stage2_emit`` runs the four kernel wrappers
    (kernel 11, kernel 17, the pack kernel, kernel B), each once, and
    outside them only the (N, S) refinement counts and injection sites
    that kernel 11 reads (and the scalar 0 of their where): the plain
    version's parts are never called by the encoder itself, and no other
    tensor is made."""
    from dwt_tpu_torch.codec import emit, encoder, tokens

    rng = np.random.default_rng(5)
    imgs = np.stack([random_image(rng, 64, 48, 3, k)
                     for k in ("noise", "mixed")])
    enc = encoder.Encoder(64, 48, 3, device="cpu")
    lin, stats = enc.stage1_frames(imgs)
    padded_T = encoder._bucket(int(stats["T"].max()))
    tv, tr, tf, orders, vmag, com = tokens._stage2_tokens(
        lin, stats, enc.pyr, 3, padded_T)
    want = emit._stage2_emit(lin, stats, tv, tr, tf, orders, vmag, com,
                             enc.pyr, 3, padded_T)

    def refuse(*args, **kwargs):
        raise AssertionError("an eager pass of the step tables ran")

    for name in ("_bit_partials", "_kernel_b_meta", "_layer_boundaries"):
        monkeypatch.setattr(emit, name, refuse)
    calls = []
    for name in ("codeword_pieces", "emit_tables", "pack_words",
                 "scatter_refbits"):
        real = getattr(emit, name)

        def opaque(*args, real=real, name=name, **kwargs):
            calls.append(name)
            with torch.utils._python_dispatch._disable_current_modes():
                return real(*args, **kwargs)

        monkeypatch.setattr(emit, name, opaque)
    rec = _Record()
    with rec:
        got = emit._stage2_emit(lin, stats, tv, tr, tf, orders, vmag, com,
                                enc.pyr, 3, padded_T)
    assert calls == ["codeword_pieces", "emit_tables", "pack_words",
                     "scatter_refbits"]
    S = 3 * enc.pyr.levels * PMAX
    tables = [s for f, s in rec.ops if f != "scalar_tensor.default"]
    assert tables and all(s in ((2, S), (2, 3, enc.pyr.levels, PMAX))
                          for s in tables), rec.ops
    for g, w in zip(got, want):
        assert (torch.equal(g, w) if isinstance(w, torch.Tensor)
                else g == w)


def test_host_totals_read_the_head():
    """``encoder._host_totals`` reads the order flag, the bit partials and
    the layer ends from the one head, and raises on a set order flag."""
    from dwt_tpu_torch.codec import encoder
    from dwt_tpu_torch.ops import emit_tables

    parts = torch.tensor([[5, 2**30, 7], [1, 2, 3]], dtype=torch.int32)
    ends = torch.arange(2 * LMAX, dtype=torch.int32).reshape(2, LMAX)
    head = torch.cat([torch.zeros(1, dtype=torch.int32), parts.reshape(-1),
                      ends.reshape(-1)])
    flag, p, e = emit_tables.head_views(head, 2)
    assert torch.equal(p, parts) and torch.equal(e, ends)
    totals, got = encoder._host_totals(head, 2)
    assert totals == [2**30 + 12, 6]
    assert got.dtype == np.int64 and np.array_equal(got, ends.numpy())
    flag.fill_(1)
    with pytest.raises(ValueError, match="nondecreasing"):
        encoder._host_totals(head, 2)


@pytest.mark.parametrize("case", ["off dtype", "valid dtype", "unit shape",
                                  "step grid", "chunk tables", "levels",
                                  "device", "steps", "words", "order shape",
                                  "scan tables", "vcar"])
def test_emit_tables_checks(monkeypatch, case):
    """The wrapper raises on what kernel 17 does not take: wrong dtypes
    and shapes, tensors on several devices, more steps a frame than the
    kernel's 2,048 (on the card's path) and word indices past int32."""
    from dwt_tpu_torch.ops import emit_tables

    rng = np.random.default_rng(17)
    args = list(_seeded(rng, 2, 3, 2, np.array([1, 2]), 4096, 9000))
    assert emit_tables.emit_tables(*args)
    if case == "off dtype":
        args[0] = args[0].long()
    elif case == "valid dtype":
        args[19] = args[19].to(torch.int32)
    elif case == "unit shape":
        args[15] = args[15][:, :-1]
    elif case == "step grid":
        args[6] = args[6][:, :, :1]
    elif case == "chunk tables":
        args[11] = args[11][:, :, :1]
    elif case == "levels":
        args[23] = args[23][:1]
    elif case == "device":
        args[3] = torch.empty(args[3].shape, dtype=torch.int32,
                              device="meta")
    elif case == "steps":
        args = list(_seeded(rng, 1, 3, 24, np.ones(24, int), 4096, 9000))
        assert emit_tables.emit_tables(*args)  # the plain version takes it
        monkeypatch.setattr(emit_tables, "cuda_or_cpu", lambda *a: True)
        with pytest.raises(ValueError, match="2048"):
            emit_tables.emit_tables(*args)
        return
    elif case == "order shape":
        args[4] = args[4][:, :-1]
    elif case == "scan tables":
        args[13] = args[13][:1]
    elif case == "vcar":
        args[21] = args[21][:-1]
    else:
        args[25] = 2**30
    with pytest.raises(ValueError):
        emit_tables.emit_tables(*args)


@pytest.mark.parametrize("path", ["single", "sub-batch", "tiled",
                                  "budgeted tiled", "capacity"])
def test_sites_in_schedule_order_on_every_path(monkeypatch, path):
    """Every ``emit_tables`` call of the encode paths gets an ``order``
    that is a permutation of each frame's steps and injection sites that
    never decrease in that order, the budget's cuts
    (``_mask_schedule_suffix``) included: kernel 17 takes no sort there.
    The replayed kernel agrees on each call."""
    from dwt_tpu_torch.codec import emit, encoder, tiled

    seen = []
    real = emit.emit_tables

    def spy(*args):
        seen.append(tuple(a.clone() if torch.is_tensor(a) else a
                          for a in args))
        return real(*args)

    cut = []
    mask = encoder._mask_schedule_suffix
    monkeypatch.setattr(emit, "emit_tables", spy)
    monkeypatch.setattr(encoder, "_mask_schedule_suffix", lambda *a: (
        lambda r: (cut.append(r is not None), r)[1])(mask(*a)))
    rng = np.random.default_rng(len(path))
    img = random_image(rng, 96, 80, 3, "mixed")
    if path == "single":
        encoder.encode(img, device="cpu")
    elif path == "sub-batch":
        imgs = np.stack([random_image(rng, 64, 48, 3, k)
                         for k in ("flat", "noise", "mixed")])
        tiled.BatchEncoder(64, 48, 3, device="cpu").encode_batch(imgs)
    elif path == "capacity":
        encoder.encode(img, capacity=300, device="cpu")
    else:
        full = tiled.encode_tiled(img, tile=(32, 32), device="cpu")
        if path == "budgeted tiled":
            seen.clear()
            tiled.encode_tiled(img, tile=(32, 32), budget=len(full) // 4,
                               device="cpu")
    assert seen
    if path in ("capacity", "budgeted tiled"):
        assert any(cut)
    if path == "sub-batch":
        assert seen[0][0].shape[0] == 3
    for args in seen:
        site, order = args[3], args[4].long()
        N, S = order.shape
        assert torch.equal(order.sort(dim=1).values,
                           torch.arange(S).expand(N, S))
        assert (torch.diff(site.gather(1, order), dim=1) >= 0).all()
        assert not any(_same_as_replay(args))


@pytest.mark.parametrize("N,C,L,nchunk,K", [(1, 3, 9, 136, 38),
                                             (7, 3, 8, 39, 40), (3, 1, 2, 2,
                                                                 9)])
def test_emit_tables_arena_layout(N, C, L, nchunk, K):
    """Kernel 17's one allocation a call: refstart, the meta rows and the
    head as disjoint views at 256-byte offsets, the head holding the order
    flag, bits_parts and layer_ends end to end (as ``head_views`` finds
    them), and the launch plan beside them."""
    from dwt_tpu_torch.ops import emit_tables

    words, views, offsets, plan = emit_tables._layout(N, C, L, nchunk, K)
    assert (plan.np, plan.tf, plan.fpb, plan.bpf, plan.ub) == \
        emit_tables.launch_plan(C * L * PMAX, C * nchunk * PMAX)
    outs = emit_tables._carve(words, views, "cpu")
    U = C * nchunk * PMAX
    assert [tuple(o.shape) for o in outs] == [
        (N, C, L, PMAX), (N * U, 8), (1 + N * (K + LMAX),), (N, K),
        (N, LMAX)]
    assert all(o.is_contiguous() and o.dtype == torch.int32 for o in outs)
    at = [o.data_ptr() - outs[0].data_ptr() for o in outs[:3]]
    assert list(offsets.at) == at and all(a % 256 == 0 for a in at)
    ends = [a + o.numel() * 4 for a, o in zip(at, outs)]
    assert all(e <= a for e, a in zip(ends, at[1:])) and ends[-1] <= 4 * words
    flag, parts, lend = emit_tables.head_views(outs[2], N)
    assert parts.data_ptr() == outs[3].data_ptr() == outs[2].data_ptr() + 4
    assert lend.data_ptr() == outs[4].data_ptr() == \
        parts.data_ptr() + 4 * N * K
