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
* The kernel's plan replayed in numpy: the bitonic network at the block
  size :func:`steps_threads` gives, the warp-structured scan, the binary
  searches, the layer buckets, and the meta rows with each unit's level
  prefix summed as its thread sums it (its level found from the levels'
  first chunks alone), against the plain version on the frames above and on
  seeded tables at the edges (tied and clamped sites, wrapping sums, up
  to 2,048 steps, clamped word windows).
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


def _inputs(runs: list) -> tuple:
    """Kernel 17's arguments over the frames of ``runs`` (one geometry, one
    bucket), stacked on a leading axis, on the CPU."""
    from dwt_tpu_torch.codec.stage1 import segs_for
    from dwt_tpu_torch.ops.units import COM_KEYS

    r0 = runs[0]
    segs = segs_for(r0["pyr"], "cpu")

    def stack(get, dtype=torch.int32):
        return torch.as_tensor(np.stack([get(r) for r in runs])).to(dtype)

    st = [(k, lambda r, k=k: r["stats"][k]) for k in (
        "step_end", "refpfx", "step_base", "planes", "planes_max", "nS_ck",
        "nZ_ck")]
    args = [stack(lambda r: r["off"]), stack(lambda r: r["chunks"]),
            stack(lambda r: r["nref"]),
            stack(lambda r: np.clip(r["stats"]["inj_pos"].reshape(-1), 0,
                                    r["padded_T"]))]
    args += [stack(get) for _, get in st]
    args += [stack(lambda r, k=k: r["com"][k],
                   torch.bool if k == "valid" else torch.int32)
             for k in COM_KEYS]
    args += [segs.ch_valid_t, segs.level_chunk_base_t, segs.level_nchunk_t]
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
    st = {k: args[4 + i] for i, k in enumerate(
        ("step_end", "refpfx", "step_base", "planes", "planes_max", "nS_ck",
         "nZ_ck"))}
    from dwt_tpu_torch.ops.units import COM_KEYS

    com = dict(zip(COM_KEYS, args[11:17]))
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


def _replay_steps(off, chunks, nref, site, step_end, refpfx, step_base,
                  planes, pm, C, L):
    """One block of ``emit_steps_kernel`` on one frame's tables (numpy):
    (refstart (S,), parts (K,), ends (LMAX,))."""
    from dwt_tpu_torch.ops import emit_tables

    S, T = C * L * PMAX, off.size
    nt = emit_tables.steps_threads(S)
    NP = 2 * nt
    assert 64 <= nt <= 1024 and nt & (nt - 1) == 0 and NP >= S
    key = np.full(NP, np.iinfo(np.uint64).max, np.uint64)
    key[:S] = ((site.astype(np.uint32).astype(np.uint64) << np.uint64(32))
               | nref.astype(np.uint32).astype(np.uint64))
    t = np.arange(nt)
    k = 2
    while k <= NP:  # the bitonic network, a pair a thread a stage
        j = k >> 1
        while j:
            i = 2 * t - (t & (j - 1))
            assert len(set(i) | set(i + j)) == NP  # every key, once
            a, b = key[i].copy(), key[i + j].copy()
            swap = (a > b) == ((i & k) == 0)
            key[i], key[i + j] = np.where(swap, b, a), np.where(swap, a, b)
            j >>= 1
        k <<= 1
    assert np.all(key[1:] >= key[:-1])
    # the scan, two keys a thread, warp by warp
    low = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    v = np.where(np.arange(NP) < S, low.astype(np.int64), 0).reshape(nt, 2)
    x = v.sum(axis=1)
    x = np.cumsum(x.reshape(-1, 32), axis=1)
    prev = np.repeat(np.concatenate([[0], np.cumsum(x[:, -1])[:-1]]), 32)
    x = x.reshape(-1)
    before = x + prev - v.sum(axis=1)
    scan = _wrap(np.stack([before + v[:, 0], before + v[:, 0] + v[:, 1]],
                          axis=1).reshape(-1))
    sites = (key[:S] >> np.uint64(32)).astype(np.int64)
    end = np.clip(step_end, 0, T - 1)
    cnt = np.array([np.searchsorted(sites, e, side="right") for e in end])
    inj = np.where(cnt > 0, scan[np.maximum(cnt - 1, 0)], 0)
    refstart = _wrap(off[end].astype(np.int64) - inj + refpfx)

    s = np.arange(S)
    c_s, l_s, p_s = s // (L * PMAX), (s // PMAX) % L, s % PMAX
    parts = [_wrap(chunks[j:j + 512].astype(np.int64).sum())
             for j in range(0, chunks.size, 512)]
    parts += [_wrap(nref[j:j + 8].astype(np.int64).sum())
              for j in range(0, S, 8)]
    parts = np.asarray(parts, np.int32)
    tot = _wrap(parts.astype(np.int64).sum())
    smin = np.full(LMAX + 1, 2**31 - 1, np.int64)
    for cc, ll, pp, b in zip(c_s, l_s, p_s, np.clip(step_base, 0, T - 1)):
        if pp < planes[cc]:
            layer = (pm - 2 if cc == 0 else pm - 1) - pp + ll
            bucket = min(max(layer, -1) + 1, LMAX)
            smin[bucket] = min(smin[bucket], off[b])
    ends = np.array([min(smin[k + 1:].min(), tot) for k in range(LMAX)],
                    np.int32)
    return refstart, parts, ends


def _replay_rcar(fck, pm, nS, nZ, ch_valid, lcb):
    """Each unit's level prefix of refinement bits, as a thread of
    ``emit_meta_kernel`` sums it: its chunk's level by a binary search of
    the levels' first chunks, then nR_ck over the level's chunks before
    its own, in its (c, p) column."""
    nchunk = ch_valid.size
    out = []
    for u in fck:
        p, k, c = u % PMAX, (u // PMAX) % nchunk, u // (PMAX * nchunk)
        lo, hi = 0, lcb.size
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            lo, hi = (mid, hi) if lcb[mid] <= k else (lo, mid)
        acc = 0
        if p < pm:
            for kk in range(lcb[lo], k):
                acc += int(ch_valid[kk]) - int(nS[c, kk, p]) - int(nZ[c, kk, p])
        out.append(acc)
    return _wrap(out)


def _replay(args) -> tuple:
    """``emit_steps_kernel`` a block a frame, then ``emit_meta_kernel`` a
    unit a thread, on the wrapper's arguments (numpy); the levels' chunk
    counts are not the kernel's input."""
    from dwt_tpu_torch.ops import compact

    (off, chunks, nref, site, step_end, refpfx, step_base, planes, pm, nS,
     nZ, elem, elen, p, fst, fck, valid, ch_valid, lcb) = (
         a.numpy() for a in args[:19])
    n, nwords = args[20:]
    N, C, L = step_end.shape[:3]
    nchunk, U = nS.shape[2], elem.shape[1]
    outs = [_replay_steps(off[f], chunks[f], nref[f], site[f],
                          step_end[f].reshape(-1), refpfx[f].reshape(-1),
                          step_base[f].reshape(-1), planes[f], int(pm[f]),
                          C, L)
           for f in range(N)]
    wsmax = (nwords - compact.WREF) // 128 * 128
    rows = []
    for f, (rs, _, _) in enumerate(outs):
        rcar = _replay_rcar(fck[f], pm[f], nS[f], nZ[f], ch_valid, lcb)
        bit0 = _wrap(rs[fst[f]].astype(np.int64) + rcar)
        pp, kk = fck[f] % PMAX, (fck[f] // PMAX) % nchunk
        nR = np.where(pp < pm[f], _wrap(ch_valid[kk].astype(np.int64)
                                        - nS[f].reshape(-1)[fck[f]]
                                        - nZ[f].reshape(-1)[fck[f]]), 0)
        ws = np.minimum(np.maximum((bit0 >> 5) & ~127, 0), wsmax)
        row = _wrap(elem[f].astype(np.int64) + f * C * n) >> 10
        z = np.zeros(U, np.int64)
        rows.append(np.stack([row, elen[f], p[f],
                              _wrap(ws.astype(np.int64) + f * nwords),
                              _wrap(bit0.astype(np.int64) - 32 * ws.astype(
                                  np.int64)), z,
                              np.where(valid[f], nR, 0), z], axis=1))
    refstart = np.stack([o[0] for o in outs]).reshape(step_end.shape)
    return (refstart, np.stack([o[1] for o in outs]),
            _wrap(np.concatenate(rows)), np.stack([o[2] for o in outs]))


def _same_as_replay(args) -> None:
    from dwt_tpu_torch.ops import emit_tables

    got = emit_tables.emit_tables_plain(*args)
    for name, g, w in zip(("refstart", "bits_parts", "meta", "layer_ends"),
                          got, _replay(args)):
        assert g.numpy().shape == w.shape, name
        assert np.array_equal(g.numpy(), w), name


@pytest.mark.parametrize("case", ["frame2", "frame6", "batch", "cut 1"])
def test_plan_replayed_on_frames(runs, case):
    """The replayed kernels equal the plain version on the JAX pipeline's
    inputs."""
    _same_as_replay(_inputs(runs(case)))


def _seeded(rng, N, C, L, lnc, T, nwords, n=1 << 16):
    """Seeded kernel-17 arguments: N frames of C channels and L levels of
    ``lnc`` chunks each, T token slots; tied sites, sites at 0 and T,
    step ends past both edges, refinement counts that wrap int32 sums,
    random unit columns (any in-range steps and chunks)."""
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
    return (i32(N, T), i32(N, -(-T // 2048), lo=0, hi=2**17),
            torch.as_tensor(nref, dtype=torch.int32),
            torch.as_tensor(site, dtype=torch.int32),
            i32(N, C, L, PMAX, lo=-3, hi=T + 3), i32(N, C, L, PMAX),
            i32(N, C, L, PMAX, lo=-3, hi=T + 3),
            torch.as_tensor(planes, dtype=torch.int32),
            torch.as_tensor(rng.integers(0, PMAX + 1, N), dtype=torch.int32),
            i32(N, C, nchunk, PMAX, lo=0, hi=5000),
            i32(N, C, nchunk, PMAX, lo=0, hi=70000),
            i32(N, U, lo=0, hi=C * n), i32(N, U, lo=1, hi=65537),
            i32(N, U, lo=0, hi=PMAX), i32(N, U, lo=0, hi=S),
            i32(N, U, lo=0, hi=U),
            torch.as_tensor(rng.random((N, U)) < 0.7),
            i32(nchunk, lo=0, hi=65537), torch.as_tensor(lcb, dtype=torch.int32),
            torch.as_tensor(lnc, dtype=torch.int32), n, nwords)


@pytest.mark.parametrize("N,C,L,T,nwords", [
    (1, 1, 1, 4096, 9000), (3, 1, 2, 5000, 1000), (2, 3, 4, 8192, 2**20),
    (1, 3, 23, 9000, 50_000), (1, 1, 70, 2048, 3000), (4, 2, 1, 3, 5000)])
def test_plan_replayed_on_seeded_tables(N, C, L, T, nwords):
    """The replayed kernels equal the plain version on seeded tables at the
    edges: up to 2,001 and 2,030 steps a frame, blocks of 64 to 1,024
    threads, word windows clamped below and above (and a frame's words
    fewer than a window)."""
    rng = np.random.default_rng(N * 1000 + C * 100 + L)
    lnc = rng.integers(1, 5, L)
    _same_as_replay(_seeded(rng, N, C, L, lnc, T, nwords))


def test_steps_threads():
    """The step tables' block: a power of two from 64 to 1,024 threads,
    two keys a thread holding every step; past 2,048 steps it raises."""
    from dwt_tpu_torch.ops import emit_tables

    assert [emit_tables.steps_threads(s) for s in (1, 128, 129, 783, 2048)] \
        == [64, 64, 128, 512, 1024]
    with pytest.raises(ValueError, match="2048"):
        emit_tables.steps_threads(2049)


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
                                  "device", "steps", "words"])
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
        args[16] = args[16].to(torch.int32)
    elif case == "unit shape":
        args[12] = args[12][:, :-1]
    elif case == "step grid":
        args[5] = args[5][:, :, :1]
    elif case == "chunk tables":
        args[10] = args[10][:, :, :1]
    elif case == "levels":
        args[19] = args[19][:1]
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
    else:
        args[21] = 2**30
    with pytest.raises(ValueError):
        emit_tables.emit_tables(*args)


@pytest.mark.parametrize("N,C,L,nchunk,K", [(1, 3, 9, 136, 38),
                                             (7, 3, 8, 39, 40), (3, 1, 2, 2,
                                                                 9)])
def test_emit_tables_arena_layout(N, C, L, nchunk, K):
    """Kernel 17's one allocation a call: refstart, the meta rows and the
    head as disjoint views at 256-byte offsets, the head holding the order
    flag, bits_parts and layer_ends end to end."""
    from dwt_tpu_torch.ops import _launch, emit_tables

    nbytes, views, offsets = emit_tables._layout(N, C, L, nchunk, K)
    outs = _launch.carve(nbytes, views, "cpu")
    U = C * nchunk * PMAX
    assert [tuple(o.shape) for o in outs] == [
        (N, C, L, PMAX), (N * U, 8), (1 + N * (K + LMAX),)]
    at = [o.data_ptr() - outs[0].data_ptr() for o in outs]
    assert list(offsets.at) == at and all(a % 256 == 0 for a in at)
    ends = [a + o.numel() * 4 for a, o in zip(at, outs)]
    assert all(e <= a for e, a in zip(ends, at[1:])) and ends[-1] <= nbytes
    flag, parts, lend = emit_tables.head_views(outs[2], N)
    assert parts.shape == (N, K) and lend.shape == (N, LMAX)
    assert parts.data_ptr() == outs[2].data_ptr() + 4
    assert lend.data_ptr() == parts.data_ptr() + 4 * N * K
