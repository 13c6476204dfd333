"""Kernel 14, stage 1's level sums, step order and carry chain
(``dwt_tpu_torch/ops/schedule.py``, ``csrc/schedule.cu``), on the CPU.

* Its plain version against the JAX package's ``_stats_from_lin`` on the
  same linearized coefficients: every stats key exactly (dtype, shape and
  every slot), on noise, flat (planes_max 0), sparse and low-plane frames,
  grey and RGB, one frame and three, and a 16x16 geometry (two levels).
* The kernels' plan replayed in numpy (the level sums by warps over
  shares of a level's chunks, folded in order; the sort by counts over the
  compacted valid keys; the chain as composed maps over each thread's run
  of steps and a scan of the runs; the bases by a second scan) and held
  to the plain version on random tables whose chains meet invalid steps
  and every kind of map, with ties among the invalid keys and among the
  chunks' last positions.
* The wrapper's checks, and stage 1's one host copy of planes_max and T.

The kernels themselves run only on the card: ``tests/test_torch_card.py``
holds them against this plain version there.
"""

import numpy as np
import pytest
import torch

from imagegen import random_image
from torch_parity import STATS_KEYS

PMAX = 29
THREADS = 256  # the schedule kernel's block (csrc/schedule.cu)
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


def _level_sums_replay(nS_ck, lastS_ck, z0_ck, zup_ck, lcb, lnc, W):
    """level_sums_kernel: a block a (row, level), warp w on chunks [kb +
    kn * w / W, kb + kn * (w + 1) / W), lane p on plane p, then warp 0
    folds the shares in order and each warp writes its cumsums."""
    R, nchunk, P = nS_ck.shape
    L = len(lcb)
    lv = {k: np.zeros((R, L, P), np.uint32) for k in ("nS", "nZ", "tz")}
    ck = {k: np.zeros((R, nchunk, P), np.uint32)
          for k in ("nZ", "scar", "zcar")}
    for r in range(R):
        for l in range(L):
            kb, kn = lcb[l], lnc[l]
            shares = []
            for w in range(W):
                k0, k1 = kb + kn * w // W, kb + kn * (w + 1) // W
                sS, sZ, acc, cnt, zloc = (np.zeros(P, np.uint32)
                                          for _ in range(5))
                m = np.full(P, INT_MIN, np.int64)
                for k in range(k0, k1):
                    s = _u32(nS_ck[r, k])
                    nz = (_u32(z0_ck[r, k]) + np.cumsum(s, dtype=np.uint32)
                          - s)
                    ck["nZ"][r, k] = nz
                    ls = lastS_ck[r, k].astype(np.int64)
                    val = zloc + _u32(zup_ck[r, k])
                    gt, eq = ls > m, ls == m
                    acc = np.where(gt, val, np.where(eq, acc + val, acc))
                    cnt = np.where(gt, 1, np.where(eq, cnt + 1, cnt)).astype(
                        np.uint32)
                    m = np.maximum(m, ls)
                    sS, sZ, zloc = sS + s, sZ + nz, zloc + nz
                shares.append((k0, k1, sS, sZ, m, acc, cnt))
            Sb, Zb, ACC = (np.zeros(P, np.uint32) for _ in range(3))
            M = np.full(P, INT_MIN, np.int64)
            for k0, k1, sS, sZ, m, acc, cnt in shares:
                sc, zc = Sb.copy(), Zb.copy()
                for k in range(k0, k1):  # the second walk
                    ck["scar"][r, k], ck["zcar"][r, k] = sc, zc
                    sc, zc = sc + _u32(nS_ck[r, k]), zc + ck["nZ"][r, k]
                aj = acc + cnt * Zb
                ACC = np.where(m > M, aj, np.where(m == M, ACC + aj, ACC))
                M = np.maximum(M, m)
                Sb, Zb = Sb + sS, Zb + sZ
            lv["nS"][r, l], lv["nZ"][r, l] = Sb, Zb
            lv["tz"][r, l] = Zb - np.where(M >= 0, ACC, 0).astype(np.uint32)
    return lv, ck


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


def _schedule_replay(planes, lv, root, real, C, L):
    """schedule_kernel, a frame at a time, as its threads walk their runs
    between block scans.  Returns {stats key: numpy array}."""
    i32 = lambda x: np.asarray(x, np.int64).astype(np.uint32).astype(  # noqa
        np.int32)
    N, S = planes.shape[0], C * L * PMAX
    pix0 = root.shape[2]
    out = {k: np.zeros((N, S), np.int32) for k in (
        "nRef", "step_base", "step_end", "inj_pos", "refpfx", "carry_in",
        "refrun_val", "order", "base_sched", "nS_sched", "cin_sched")}
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
        nS = lv["nS"][f].reshape(-1).astype(np.int64)
        nZ = lv["nZ"][f].reshape(-1).astype(np.int64)
        tz = lv["tz"][f].reshape(-1).astype(np.int64)
        i = np.arange(S)
        c, l, p = i // (L * PMAX), (i // PMAX) % L, i % PMAX
        nRef = np.where(p < pm, i32(real[l] - nZ - nS), 0).astype(np.int64)
        valid = p < pl[c]
        out["nRef"][f], out["valid"][f] = nRef, valid
        # the valid steps' places: a scan of each run's count
        starts, V = _excl([valid[a:b].sum() for a, b in runs])
        vkey, vidx, order = [0] * V, [0] * V, [0] * S
        for (a, b), vp in zip(runs, starts):
            for j in range(a, b):
                if valid[j]:
                    layers = (pm - 2 if c[j] == 0 else pm - 1) - p[j] + l[j]
                    vkey[vp] = (((layers + 1) << 16) | (int(c[j] > 0) << 12)
                                | (int(l[j]) << 6) | int(c[j]))
                    vidx[vp] = j
                    vp += 1
                else:
                    order[V + j - vp] = j
        for j in range(V):  # rank by count
            r = sum((kq < vkey[j]) or (kq == vkey[j] and q < j)
                    for q, kq in enumerate(vkey))
            order[r] = vidx[j]
        order = np.asarray(order)
        # the chain: each run's composed map, then a scan of the maps
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
            A, B = 1, 0
            for s in range(a, b):
                x, y = step_map(s)
                A, B = A & x, (B + y if x else y)
            maps.append((A, B))
        pre, (A, B) = [], (1, 0)
        for x, y in maps:
            pre.append((A, B))
            A, B = A & x, (B + y if x else y)
        out["carry_end"][f] = i32(carry0 + B if A else B)
        cnts, sums = {}, []
        for (a, b), (pa, pb) in zip(runs, pre):
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
        for (a, b), base, pref in zip(runs, al_pre, ref_pre):
            base += base0
            for s in range(a, b):
                j, v, cs = order[s], s < V, cnts[s]
                al = (cs + 1) // 2 * 2
                out["step_base"][f, j], out["step_end"][f, j] = base, base + cs
                out["inj_pos"][f, j], out["refpfx"][f, j] = base + al, pref
                out["order"][f, s], out["base_sched"][f, s] = j, base
                out["nS_sched"][f, s] = nS[j] if v else 0
                out["valid_sched"][f, s] = v
                base += al
                pref += int(nRef[j]) if v else 0
        out["planes_max"][f], out["T"][f] = pm, base0 + al_tot + 1
    return out


def _random_tables(rng, N, C, lnc, nchunk_extra=0):
    """Chunk tables whose chains meet every kind of map: small counts with
    many zeros, real sizes around the counts (nRef of both signs), last
    positions that tie across a level's chunks, planes below PMAX
    (invalid steps tie at 2^30) and a frame with no planes
    (planes_max 0, the pre-step's carry)."""
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


@pytest.mark.parametrize("N,C,lnc,warps", [
    (3, 3, (1, 2, 3, 1), 2),    # S = 348: two steps a thread
    (3, 1, (2, 3), 1),          # S = 58: most threads walk no step
    (4, 3, (1, 1, 5), 3),       # shares of a level unequal
    (2, 1, (7, 1, 2), 32),      # more warps than chunks
])
def test_schedule_plan_replayed(N, C, lnc, warps):
    from dwt_tpu_torch.ops import schedule as sc

    rng = np.random.default_rng(N * 100 + C * 10 + warps)
    args = _random_tables(rng, N, C, lnc)
    planes, nS_ck, lastS_ck, z0_ck, zup_ck, root, real, lcb, lnc_t = args
    want = dict(zip(sc.OUT_KEYS, sc.schedule_plain(*args, warps)))
    R = N * C
    lv, ck = _level_sums_replay(
        *(x.reshape(R, *x.shape[2:]).numpy() for x in (nS_ck, lastS_ck,
                                                         z0_ck, zup_ck)),
        lcb.tolist(), lnc_t.tolist(), warps)
    L = len(lnc)
    assert np.array_equal(lv["nS"].astype(np.int32).reshape(N, C, L, PMAX),
                          want["nS"].numpy())
    for k, key in (("nZ", "nZ_ck"), ("scar", "scar_ck"),
                   ("zcar", "zcar_ck")):
        assert np.array_equal(ck[k].astype(np.int32).reshape(
            want[key].shape), want[key].numpy()), key
    lv = {k: v.astype(np.int32).reshape(N, C * L, PMAX) for k, v in
          lv.items()}
    got = _schedule_replay(planes.numpy(), lv, root.numpy(), real.numpy(),
                           C, L)
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
