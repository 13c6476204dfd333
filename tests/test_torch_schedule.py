"""Kernel 14, stage 1's level sums, step order and carry chain
(``dwt_tpu_torch/ops/schedule.py``, ``csrc/schedule.cu``), on the CPU.

* Its plain version against the JAX package's ``_stats_from_lin`` on the
  same linearized coefficients: every stats key exactly (dtype, shape and
  every slot), on noise, flat (planes_max 0), sparse and low-plane frames,
  grey and RGB, one frame and three, and a 16x16 geometry (two levels).
* The kernel's plan replayed in numpy at cluster sizes 1, 3 and 8 and up
  to 2,030 steps a frame (the level sums by a cluster's blocks, each on its
  rows, a row's chunks cut into shares in proportion, folded in order and
  handed to block 0 from each block's shared memory; the sort in closed
  form; the chain and the unit bases as one scan of each thread's run of
  steps; the bases by a second scan) and held to the plain version on
  random tables whose chains meet invalid steps and every kind of map,
  with ties among the invalid keys and among the chunks' last positions.
* The closed-form rank against ``np.argsort(kind="stable")`` of the keys.
* The wrapper's one allocation (its views, offsets and the C source's
  order of outputs), its checks, and stage 1's one host copy of
  planes_max and T.

The kernel itself runs only on the card: ``tests/test_torch_card.py`` and
``chip_smoke.py`` hold it against this plain version there.
"""

import numpy as np
import pytest
import torch

from imagegen import random_image
from torch_parity import STATS_KEYS

PMAX = 29
# The schedule kernel's block and warps and the levels its key holds
# (csrc/schedule.cu).
THREADS, WARPS = 1024, 32
MAX_LEVELS = 64
INT_MIN = -2**31


def _frames(rng, w, h, c, kinds):
    out = []
    for kind in kinds:
        if kind in ("noise", "flat", "mixed"):
            out.append(random_image(rng, w, h, c, kind))
            continue
        img = np.full((h, w, c), 128, np.uint8)
        if kind == "sparse":  # a few pixels on a flat field
            ys, xs = rng.integers(0, h, 12), rng.integers(0, w, 12)
            img[ys, xs] = rng.integers(0, 256, (12, c))
        else:  # lowplanes: small values, planes_max well below PMAX
            img += rng.integers(0, 3, (h, w, c)).astype(np.uint8)
        out.append(img)
    return np.stack(out)


def _tables(frames):
    """The port's stage 1 up to kernel 14 on the CPU: (encoder, lin, the
    arguments of ``schedule``)."""
    from dwt_tpu_torch.codec import encoder, stage1
    from dwt_tpu_torch.ops.lifting import forward_transform
    from dwt_tpu_torch.ops.plane_stats import plane_stats

    n, h, w, c = frames.shape
    enc = encoder.Encoder(w, h, c, device="cpu")
    coeff = forward_transform(torch.as_tensor(frames), enc.pyr, c == 3)
    lin = stage1._linearize(coeff, enc._src, enc.pyr, c)
    segs = stage1.segs_for(enc.pyr, lin.device)
    planes, *tabs = plane_stats(lin.reshape(n * c, -1), segs.valid_t,
                                segs.idx_local, segs.block_chunk,
                                segs.unit_chunk_t, segs.chunk_base_t)
    args = (planes.reshape(n, c),
            *(t.reshape(n, c, *t.shape[1:]) for t in tabs),
            lin[:, :, :enc.pyr.pixels[0]], segs.real_t,
            segs.level_chunk_base_t, segs.level_nchunk_t)
    return enc, lin, args


CASES = [  # (w, h, c, the frames' kinds)
    (96, 80, 3, ("noise",)),
    (64, 64, 3, ("flat",)),
    (321, 239, 1, ("sparse",)),
    (128, 96, 3, ("lowplanes",)),
    (16, 16, 3, ("mixed", "flat", "noise")),
    (80, 72, 1, ("noise", "sparse", "flat")),
]


@pytest.mark.parametrize("w,h,c,kinds", CASES)
def test_schedule_plain_equals_jax(monkeypatch, w, h, c, kinds):
    import jax
    import jax.numpy as jnp

    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu_torch.ops import schedule as sc

    monkeypatch.setattr(je, "_use_pallas", lambda: False)  # pair-aligned
    rng = np.random.default_rng(w * h + len(kinds))
    frames = _frames(rng, w, h, c, kinds)
    enc, lin, args = _tables(frames)
    got = dict(zip(sc.OUT_KEYS, sc.schedule_plain(*args)))
    if w == 16:
        assert enc.pyr.levels == 2
    if "flat" in kinds:
        assert int(got["planes_max"][kinds.index("flat")]) == 0
    pyr = compute_pyramid(w, h)
    stats_of = jax.jit(lambda x: je._stats_from_lin(x, pyr, c)[1])
    for i in range(len(kinds)):
        want = stats_of(jnp.asarray(lin[i].numpy()))
        for k in STATS_KEYS:
            g, w_ = got[k][i].numpy(), np.asarray(want[k])
            assert g.dtype == w_.dtype and g.shape == w_.shape, k
            assert np.array_equal(g, w_), k
    assert torch.equal(got["head"], torch.stack([got["planes_max"],
                                                 got["T"]]))


# --- the kernels' plan in numpy ---------------------------------------

def _u32(x):
    return np.asarray(x, np.int64).astype(np.uint32)


def _blocks(CL, K):
    """The cluster's row ranges: block b takes rows [b * CL // K, (b + 1)
    * CL // K)."""
    return [(b * CL // K, (b + 1) * CL // K) for b in range(K)]


def _owner(r, CL, K):
    """The block that holds row r's level sums, as block 0 computes it."""
    b = ((r + 1) * K - 1) // CL
    lo, hi = _blocks(CL, K)[b]
    assert lo <= r < hi
    return b


def _shares(kns):
    """Warps a row of a block whose rows have ``kns`` chunks: in
    proportion to its chunks, one at least and no more than its chunks."""
    Wb = sum(kns)
    return [max(1, min(WARPS * kn // Wb if Wb > 0 else 1, kn)) for kn in kns]


def _level_sums_replay(nS_ck, lastS_ck, z0_ck, zup_ck, lcb, lnc, K):
    """schedule_kernel's level sums on (N, C, nchunk, PMAX) tables: a
    cluster of K blocks a frame, block b on its rows, each row cut into
    shares (a warp each, lane p on plane p), the shares folded in order,
    the level sums kept in the block's own shared memory at each step's
    (c, l, p) index and each share walked again for its cumsums.  Returns
    (the level sums as block 0 gathers them from their owners, (N, S) each,
    the chunk cumsums)."""
    N, C, nchunk, P = nS_ck.shape
    L = len(lcb)
    CL, S = C * L, C * L * P
    lv = {k: np.zeros((N, S), np.uint32) for k in ("nS", "nZ", "tz")}
    ck = {k: np.zeros((N, C, nchunk, P), np.uint32)
          for k in ("nZ", "scar", "zcar")}
    tasks = -(-CL // K) + WARPS  # the shares a block has room for
    for f in range(N):
        smem = []  # each block's level sums
        for r0, r1 in _blocks(CL, K):
            own = {k: np.zeros(S, np.uint32) for k in lv}
            Ws = _shares([lnc[r % L] for r in range(r0, r1)])
            assert sum(Ws) <= tasks
            for r, W in zip(range(r0, r1), Ws):
                c, l = divmod(r, L)
                kb, kn = lcb[l], lnc[l]
                shares = []
                for w in range(W):
                    k0, k1 = kb + kn * w // W, kb + kn * (w + 1) // W
                    sS, sZ, acc, cnt, zloc = (np.zeros(P, np.uint32)
                                              for _ in range(5))
                    m = np.full(P, INT_MIN, np.int64)
                    for k in range(k0, k1):
                        s = _u32(nS_ck[f, c, k])
                        nz = (_u32(z0_ck[f, c, k])
                              + np.cumsum(s, dtype=np.uint32) - s)
                        ck["nZ"][f, c, k] = nz
                        ls = lastS_ck[f, c, k].astype(np.int64)
                        val = zloc + _u32(zup_ck[f, c, k])
                        gt, eq = ls > m, ls == m
                        acc = np.where(gt, val, np.where(eq, acc + val, acc))
                        cnt = np.where(gt, 1, np.where(eq, cnt + 1, cnt)
                                       ).astype(np.uint32)
                        m = np.maximum(m, ls)
                        sS, sZ, zloc = sS + s, sZ + nz, zloc + nz
                    shares.append((k0, k1, sS, sZ, m, acc, cnt))
                Sb, Zb, ACC = (np.zeros(P, np.uint32) for _ in range(3))
                M = np.full(P, INT_MIN, np.int64)
                for k0, k1, sS, sZ, m, acc, cnt in shares:
                    sc, zc = Sb.copy(), Zb.copy()
                    for k in range(k0, k1):  # the second walk
                        ck["scar"][f, c, k], ck["zcar"][f, c, k] = sc, zc
                        sc = sc + _u32(nS_ck[f, c, k])
                        zc = zc + ck["nZ"][f, c, k]
                    aj = acc + cnt * Zb
                    ACC = np.where(m > M, aj, np.where(m == M, ACC + aj, ACC))
                    M = np.maximum(M, m)
                    Sb, Zb = Sb + sS, Zb + sZ
                at = slice(r * P, (r + 1) * P)
                own["nS"][at], own["nZ"][at] = Sb, Zb
                own["tz"][at] = Zb - np.where(M >= 0, ACC, 0).astype(np.uint32)
            smem.append(own)
        for i in range(S):  # the hand-over
            b = _owner(i // P, CL, K)
            for k in lv:
                lv[k][f, i] = smem[b][k][i]
    return lv, ck


def closed_order(pl, pm: int, L: int):
    """schedule_kernel's sort of one frame's steps in closed form, from the
    planes ``pl`` (C,) and planes_max ``pm``: (order (S,), valid (S,))."""
    C = len(pl)
    S = C * L * PMAX
    P = np.clip(np.asarray(pl, np.int64), 0, PMAX)
    i = np.arange(S)
    c, l, p = i // (L * PMAX), (i // PMAX) % L, i % PMAX
    valid = p < P[c]
    lam = pm - 1 - (c == 0) - p + l
    sec = c > 0
    r = np.zeros(S, np.int64)
    for c2 in range(C):
        for l2 in range(L):
            t = pm - 1 - int(c2 == 0) + l2 - lam
            r += P[c2] - np.clip(t + 1, 0, P[c2])
            less = np.where((c2 > 0) != sec, (c2 > 0) < sec,
                            np.where(l2 != l, l2 < l, c2 < c))
            r += (t >= 0) & (t < P[c2]) & less
    V = L * P.sum()
    before = L * (np.cumsum(P) - P)
    r = np.where(valid, r, V + i - (before[c] + l * P[c] + np.minimum(p, P[c])))
    order = np.full(S, -1, np.int64)
    order[r] = i
    assert (order >= 0).all()  # the ranks are a permutation
    return order, valid


def _runs(S):
    per = -(-S // THREADS)
    return [(min(t * per, S), min(t * per + per, S)) for t in range(THREADS)]


def _excl(vals):
    """The block scan: each run's exclusive prefix and the total."""
    out, acc = [], 0
    for v in vals:
        out.append(acc)
        acc += v
    return out, acc


def _schedule_replay(planes, lv, root, real, lnc, C, L):
    """schedule_kernel's block 0, a frame at a time: the closed-form sort,
    then its threads' runs of steps between block scans.  Returns {stats
    key: numpy array}."""
    i32 = lambda x: np.asarray(x, np.int64).astype(np.uint32).astype(  # noqa
        np.int32)
    N, S = planes.shape[0], C * L * PMAX
    pix0 = root.shape[2]
    out = {k: np.zeros((N, S), np.int32) for k in (
        "nRef", "step_base", "step_end", "inj_pos", "refpfx", "carry_in",
        "refrun_val", "order", "base_sched", "nS_sched", "cin_sched",
        "ubase_sched")}
    out.update({k: np.zeros((N, S), bool)
                for k in ("refrun_ok", "valid", "valid_sched")})
    for k in ("root_cnt", "root_base"):
        out[k] = np.zeros((N, C), np.int32)
    for k in ("planes_max", "planes_base", "T", "carry_end"):
        out[k] = np.zeros(N, np.int32)
    runs = _runs(S)
    for f in range(N):
        pl = planes[f]
        pm = int(pl.max())
        mag = np.abs(root[f].astype(np.int64))
        rcnt = np.where(mag.max(1) > 0, np.floor(np.log2(np.maximum(
            mag.max(1), 1))).astype(np.int64) + 1, 0)
        rtok = 1 + np.where(rcnt > 0, pix0 + (root[f] != 0).sum(1), 0)
        out["root_cnt"][f] = rcnt
        out["root_base"][f] = np.cumsum(rtok) - rtok
        out["planes_base"][f] = rtok.sum()
        base0 = (int(rtok.sum()) + C + 1) // 2 * 2
        nS = lv["nS"][f].astype(np.int64)
        nZ = lv["nZ"][f].astype(np.int64)
        tz = lv["tz"][f].astype(np.int64)
        i = np.arange(S)
        l, p = (i // PMAX) % L, i % PMAX
        nRef = np.where(p < pm, i32(real[l] - nZ - nS), 0).astype(np.int64)
        order, valid = closed_order(pl, pm, L)
        V = int(valid.sum())
        out["nRef"][f], out["valid"][f] = nRef, valid
        # the chain and the unit bases: each run's composed map and chunk
        # count, then one scan of the runs
        carry0 = int(real[0]) if pm == 0 else 0

        def step_map(s):
            j = order[s]
            if s >= V:
                return 1, 0
            if nRef[j] > 0:
                return 0, 0
            return (0, int(tz[j])) if nS[j] > 0 else (1, int(nZ[j]))

        maps = []
        for a, b in runs:
            A, B, U = 1, 0, 0
            for s in range(a, b):
                x, y = step_map(s)
                A, B = A & x, (B + y if x else y)
                U += int(lnc[(order[s] // PMAX) % L])
            maps.append((A, B, U))
        pre, (A, B, U) = [], (1, 0, 0)
        for x, y, u in maps:
            pre.append((A, B, U))
            A, B, U = A & x, (B + y if x else y), U + u
        out["carry_end"][f] = i32(carry0 + B if A else B)
        cnts, sums = {}, []
        for (a, b), (pa, pb, _) in zip(runs, pre):
            carry = carry0 + pb if pa else pb
            al_sum = ref_sum = 0
            for s in range(a, b):
                j, v = order[s], s < V
                rv = int(tz[j]) if nS[j] > 0 else carry + int(nZ[j])
                rro = v and nRef[j] > 0 and rv > 0
                out["carry_in"][f, j] = out["cin_sched"][f, s] = carry
                out["refrun_val"][f, j], out["refrun_ok"][f, j] = rv, rro
                if v:
                    carry = 0 if nRef[j] > 0 else rv
                cnts[s] = 2 * int(nS[j]) + int(rro) if v else 0
                al_sum += (cnts[s] + 1) // 2 * 2
                ref_sum += int(nRef[j]) if v else 0
            sums.append((al_sum, ref_sum))
        al_pre, al_tot = _excl([x for x, _ in sums])
        ref_pre, _ = _excl([y for _, y in sums])
        for (a, b), base, pref, (_, _, ub) in zip(runs, al_pre, ref_pre, pre):
            base += base0
            for s in range(a, b):
                j, v, cs = order[s], s < V, cnts[s]
                al = (cs + 1) // 2 * 2
                out["step_base"][f, j], out["step_end"][f, j] = base, base + cs
                out["inj_pos"][f, j], out["refpfx"][f, j] = base + al, pref
                out["order"][f, s], out["base_sched"][f, s] = j, base
                out["nS_sched"][f, s] = nS[j] if v else 0
                out["valid_sched"][f, s] = v
                out["ubase_sched"][f, s] = ub
                base += al
                pref += int(nRef[j]) if v else 0
                ub += int(lnc[(j // PMAX) % L])
        out["planes_max"][f], out["T"][f] = pm, base0 + al_tot + 1
    return out


def _random_tables(rng, N, C, lnc):
    """Chunk tables whose chains meet every kind of map: small counts with
    many zeros, real sizes around the counts (nRef of both signs), last
    positions that tie across a level's chunks, planes below PMAX
    (invalid steps tie at 2^30), a frame with no planes (planes_max 0, the
    pre-step's carry) and, with three frames or more, a channel with every
    plane valid."""
    L = len(lnc)
    nchunk = sum(lnc)
    shape = (N, C, nchunk, PMAX)
    nS_ck = np.where(rng.random(shape) < 0.5, 0, rng.integers(0, 40, shape))
    lastS_ck = rng.integers(-1, 6, shape)
    z0_ck = rng.integers(0, 300, (N, C, nchunk))
    zup_ck = rng.integers(0, 50, shape)
    planes = rng.integers(0, PMAX + 1, (N, C))
    planes[0] = 0
    if N > 2:
        planes[2, 0] = PMAX  # every plane of a channel valid
    root = rng.integers(-70, 70, (N, C, 7))
    root[:, :, 3] = 0
    real = rng.integers(100, 900, L)
    lcb = np.concatenate([[0], np.cumsum(lnc)[:-1]])
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32)  # noqa
    return (t(planes), t(nS_ck), t(lastS_ck), t(z0_ck), t(zup_ck), t(root),
            t(real), t(lcb), t(lnc))


PLAN_CASES = [  # (frames, channels, each level's chunks, seed)
    (3, 3, (1, 2, 3, 1), 302),    # S = 348
    (3, 1, (2, 3), 311),          # S = 58: most threads walk no step
    (4, 3, (1, 1, 5), 433),       # shares of a row unequal
    (2, 1, (7, 1, 2), 242),       # a row of 7 chunks among rows of 1 and 2
    (3, 32, (1, 2), 5),           # S = 1,856: 64 rows, 32 channels
    (3, 2, (1,) * 30 + (2, 3, 5, 9, 40), 6),  # S = 2,030: 2 steps a thread
]


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("N,C,lnc,seed", PLAN_CASES)
def test_schedule_plan_replayed(N, C, lnc, seed, K):
    """The kernel's plan at K blocks a cluster (the kernel takes min(8, C
    * L); any K gives the same leaves) against the plain version."""
    from dwt_tpu_torch.ops import schedule as sc

    rng = np.random.default_rng(seed)
    args = _random_tables(rng, N, C, lnc)
    planes, nS_ck, lastS_ck, z0_ck, zup_ck, root, real, lcb, lnc_t = args
    want = dict(zip(sc.OUT_KEYS, sc.schedule_plain(*args)))
    L = len(lnc)
    K = min(K, C * L)
    lv, ck = _level_sums_replay(
        *(x.numpy() for x in (nS_ck, lastS_ck, z0_ck, zup_ck)),
        lcb.tolist(), list(lnc), K)
    assert np.array_equal(lv["nS"].astype(np.int32).reshape(N, C, L, PMAX),
                          want["nS"].numpy())
    for k, key in (("nZ", "nZ_ck"), ("scar", "scar_ck"),
                   ("zcar", "zcar_ck")):
        assert np.array_equal(ck[k].astype(np.int32), want[key].numpy()), key
    lv = {k: v.astype(np.int32) for k, v in lv.items()}
    got = _schedule_replay(planes.numpy(), lv, root.numpy(), real.numpy(),
                           np.asarray(lnc), C, L)
    for k, v in got.items():
        w = want[k].numpy().reshape(v.shape)
        assert v.dtype == w.dtype and np.array_equal(v, w), k
    # the chain met invalid steps and each kind of valid map
    vs, ns = want["valid_sched"], want["nS_sched"]
    nref = want["nRef"].reshape(N, -1).gather(1, want["order"].long())
    assert (~vs).any() and (vs & (nref > 0)).any()
    assert (vs & (nref <= 0) & (ns > 0)).any()
    assert (vs & (nref <= 0) & (ns == 0)).any()
    assert int(want["planes_max"][0]) == 0


@pytest.mark.parametrize("seed", range(4))
def test_closed_form_rank_equals_argsort(seed):
    """The kernel's sort in closed form against np.argsort(kind="stable")
    of the schedule keys (invalid steps at 2^30), on random planes (0 to
    PMAX) at C * L up to 70: a frame with planes_max 0 and a channel with
    every plane valid among them."""
    rng = np.random.default_rng(seed)
    draws = 0
    while draws < 40:
        C = int(rng.integers(1, 33))
        L = int(rng.integers(1, min(MAX_LEVELS, 70 // C) + 1))
        pl = rng.integers(0, PMAX + 1, C)
        if draws == 0:
            pl[:] = 0
        elif draws == 1:
            pl[rng.integers(0, C)] = PMAX
        pm = int(pl.max())
        i = np.arange(C * L * PMAX)
        c, l, p = i // (L * PMAX), (i // PMAX) % L, i % PMAX
        layers = np.where(c == 0, pm - 2 - p + l, pm - 1 - p + l)
        key = ((layers + 1) << 16) | ((c > 0) << 12) | (l << 6) | c
        key = np.where(p < pl[c], key, 2**30)
        order, valid = closed_order(pl, pm, L)
        assert np.array_equal(order, np.argsort(key, kind="stable"))
        assert np.array_equal(valid, p < pl[c])
        draws += 1


def test_chain_plain_equals_a_walk():
    """The vectorised chain against the sequential walk it replaces (the
    map of each step applied in turn), on random steps."""
    from dwt_tpu_torch.ops.schedule import chain_plain

    rng = np.random.default_rng(7)
    N, S = 5, 300
    valid = rng.random((N, S)) < 0.7
    nS = np.where(rng.random((N, S)) < 0.5, 0, rng.integers(1, 9, (N, S)))
    nZ = rng.integers(0, 50, (N, S))
    tz = rng.integers(0, 30, (N, S))
    nRef = rng.integers(-3, 3, (N, S))
    carry0 = rng.integers(0, 100, N)
    t = lambda x: torch.as_tensor(x, dtype=torch.int32)  # noqa
    got = chain_plain(t(carry0), torch.as_tensor(valid), t(nS), t(nZ), t(tz),
                      t(nRef))
    for f in range(N):
        carry = int(carry0[f])
        for s in range(S):
            rv = int(tz[f, s]) if nS[f, s] > 0 else carry + int(nZ[f, s])
            assert int(got[0][f, s]) == carry and int(got[1][f, s]) == rv
            assert bool(got[2][f, s]) == bool(valid[f, s] and nRef[f, s] > 0
                                              and rv > 0)
            if valid[f, s]:
                carry = 0 if nRef[f, s] > 0 else rv
        assert int(got[3][f]) == carry


def test_stats_from_lin_copies_planes_max_and_T():
    """Stage 1's stats carry each frame's T on the host (``T_host``, the
    one copy with planes_max), and a schedule cut keeps it current."""
    from dwt_tpu_torch.codec import encoder
    from dwt_tpu_torch.codec.stage1 import frame

    rng = np.random.default_rng(3)
    frames = _frames(rng, 96, 80, 3, ("mixed", "noise"))
    enc = encoder.Encoder(96, 80, 3, device="cpu")
    lin, stats = enc.stage1_frames(frames)
    assert "head" not in stats and stats["T_host"].dtype == np.int32
    assert np.array_equal(stats["T_host"], stats["T"].numpy())
    host = encoder.host_stats(stats)
    upd = encoder._truncate_schedule(frame(host, 1), 200, enc.pyr, 3)
    cut = encoder.patch_frames(stats, {1: upd})
    assert np.array_equal(cut["T_host"], cut["T"].numpy())
    assert cut["T_host"][1] < stats["T_host"][1]
    one = encoder.patch_stats(frame(stats, 1), upd)
    assert int(one["T_host"]) == int(one["T"])


@pytest.mark.parametrize("case", ["planes dtype", "table shape", "zeros shape",
                                  "levels", "device"])
def test_schedule_checks(case):
    """The wrapper raises on what kernel 14 does not take."""
    from dwt_tpu_torch.ops import schedule as sc

    args = list(_random_tables(np.random.default_rng(1), 2, 3, (1, 2)))
    if case == "planes dtype":
        args[0] = args[0].long()
    elif case == "table shape":
        args[2] = args[2][:, :, :1]
    elif case == "zeros shape":
        args[3] = args[3][:1]
    elif case == "levels":
        args[7] = args[7][:1]
    else:
        args[4] = torch.empty(args[4].shape, dtype=torch.int32,
                              device="meta")
    with pytest.raises(ValueError):
        sc.schedule(*args)


def _enum(path, keys) -> None:
    """The C source's ``enum Out`` names the outputs in ``keys``' order."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(__file__), "..", "dwt_tpu_torch",
                            "csrc", path)).read()
    body = re.search(r"enum Out \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "O_COUNT"

    def norm(k):
        k = k.lower()
        return k[:-3] if k.endswith("_ck") else k

    assert [norm(n[2:]) for n in names[:-1]] == [norm(k) for k in keys]


def _fake_library(monkeypatch, entry: str, calls: list) -> None:
    """The kernel library replaced by a recorder of ``entry``'s arguments,
    so the wrapper's path to its launch runs on the CPU."""
    from dwt_tpu_torch.runtime import build

    class Lib:
        def __getattr__(self, name):
            assert name == entry
            return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(build, "library", lambda: Lib())
    monkeypatch.setattr(build, "stream_of", lambda t: 0)


def _arena_checks(outs, nbytes, offsets) -> None:
    """``outs`` are views of one allocation of ``nbytes``: each at its
    offset, a multiple of 256 bytes, none overlapping another."""
    base = outs[0].untyped_storage().data_ptr()
    spans = []
    for t, off in zip(outs, offsets):
        assert t.untyped_storage().data_ptr() == base
        assert t.is_contiguous() and t.data_ptr() - base == off
        assert off % 256 == 0
        spans.append((off, off + t.numel() * t.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= nbytes == outs[0].untyped_storage().nbytes()


@pytest.mark.parametrize("N,C,L,nchunk", [(1, 3, 9, 136), (7, 3, 8, 39),
                                          (5, 1, 2, 2), (0, 3, 2, 2)])
def test_schedule_arena_layout(monkeypatch, N, C, L, nchunk):
    """Kernel 14's one allocation a call: its outputs as disjoint views at
    256-byte offsets, each of the plain version's dtype and shape, in the
    C source's order; two calls never share it; the wrapper passes the
    allocation and the offsets to its entry point and returns OUT_KEYS,
    ``planes_max`` and ``T`` views of ``head``'s rows."""
    from dwt_tpu_torch.ops import _launch
    from dwt_tpu_torch.ops import schedule as sc

    _enum("schedule.cu", sc._OUTS)
    nbytes, views, offsets = sc._layout(N, C, L, nchunk)
    assert sc._layout(N, C, L, nchunk)[2] is offsets  # cached
    offs = list(offsets.at)
    assert len(offs) == len(sc._OUTS)
    first = _launch.carve(nbytes, views, "cpu")
    second = _launch.carve(nbytes, views, "cpu")
    outs = first[:len(sc._OUTS)]
    _arena_checks(outs, nbytes, offs)
    assert (second[0].untyped_storage().data_ptr()
            != first[0].untyped_storage().data_ptr() or not nbytes)
    shapes = sc._shapes(N, C, L, nchunk)
    for k, t in zip(sc._OUTS, outs):
        dt = torch.bool if k in sc._BOOL_OUTS else torch.int32
        assert t.dtype == dt and t.shape == shapes[k], k
    head = outs[0]
    for r, t in enumerate(first[len(sc._OUTS):]):  # planes_max, T
        assert t.data_ptr() == head[r].data_ptr() and t.shape == (N,)

    if N == 0:
        return
    lnc = [1] * (L - 1) + [nchunk - L + 1]
    args = _random_tables(np.random.default_rng(N), N, C, lnc)
    calls = []
    _fake_library(monkeypatch, "dwt_schedule", calls)
    monkeypatch.setattr(sc, "_check", lambda *a: True)
    before = sc.schedule.launches
    got = dict(zip(sc.OUT_KEYS, sc.schedule(*args)))
    again = dict(zip(sc.OUT_KEYS, sc.schedule(*args)))
    assert sc.schedule.launches == before + 2 and len(calls) == 2
    want = dict(zip(sc.OUT_KEYS, sc.schedule_plain(*args)))
    for k, w_ in want.items():
        assert got[k].dtype == w_.dtype and got[k].shape == w_.shape, k
    assert got["planes"] is args[0] and got["nS_ck"] is args[1]
    assert got["planes_max"].data_ptr() == got["head"].data_ptr()
    assert got["T"].data_ptr() == got["head"][1].data_ptr()
    call = calls[0]
    assert call[-3] == got["head"].data_ptr()
    assert list(call[-2].at) == offs and call[12:16] == (N, C, L, nchunk)
    for k in sc._OUTS:
        assert got[k].data_ptr() - call[-3] == offs[sc._OUTS.index(k)], k
    assert (again["head"].untyped_storage().data_ptr()
            != got["head"].untyped_storage().data_ptr())
