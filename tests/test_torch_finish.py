"""The token finisher (kernel 12) and the packed elements (kernel 13) of
``dwt_tpu_torch/ops/finish.py`` on the CPU, where each wrapper runs its
plain PyTorch version.

Held exactly, dtype included:

- ``finish_tokens`` (through ``codec/tokens.py:_finish_tokens``) against
  the JAX package's ``dwt_tpu.codec.encoder._finish_tokens``, frame by
  frame on the same pairs and stats, at one frame and a 3-frame batch,
  lossless and with schedules cut by a byte budget (``_truncate_schedule``)
  and by a tiled budget's layer cap (``_truncate_schedule_to_layer``);
- ``packed_elems`` against the JAX package's ``_packed_elems``;
- ``ops/finish.py:_split_pairs`` of kernel A's pairs against the JAX
  package's ``_sig_tokens_xla`` zero-prefixes and signs;
- kernel 12's plan (``csrc/finish.cu``: the frame's step table staged with
  its inclusive carry sums, a binary search a thread of 4 pairs and a
  second one where steps start, then the special tokens a phase at a time,
  the root ranks by block scans of 256 values) replayed in numpy against
  the plain version, on step tables with ties, bases clamped at npair - 1,
  an empty first step, a ref-run token at T - 1 and a root band wider than
  a block;
- the order kernel 12 relies on: ``base_sched`` and ``base_sched / 2 +
  nS_sched`` nondecreasing on every call of the lossless, capacity, tiled
  and budgeted tiled encodes;
- the wrappers' checks.

The CUDA code itself runs only on the card (``tests/test_torch_card.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from conftest import random_image

torch.set_num_threads(1)

PMAX = 29
BLOCK = 256  # threads of the special tokens' block (csrc/finish.cu)
PAIRS = 4    # pairs a thread of the dense pass
STAT_KEYS = ("base_sched", "nS_sched", "cin_sched", "valid_sched",
             "root_cnt", "root_base", "planes_base", "planes", "refrun_ok",
             "step_base", "nS", "refrun_val", "T", "carry_end", "planes_max")


def _stage1(imgs, cut=None):
    """The port's stage 1 of (N, H, W, C) frames on the CPU, the schedule
    cut where asked ("capacity": a byte budget of T / 24 bytes, T the
    frame's token count; "layer": a tiled budget's cap at layer 2), and
    kernel A's pairs: (encoder, lin, stats, padded_T, pairs, vmag)."""
    from dwt_tpu_torch.codec import encoder, tokens
    from dwt_tpu_torch.codec.stage1 import frame

    n, h, w, c = imgs.shape
    enc = encoder.Encoder(w, h, c, device="cpu")
    lin, stats = enc.stage1_frames(imgs)
    if cut:
        host = encoder.host_stats(stats)
        upds = {}
        for i in range(n):
            sh = frame(host, i)
            upd = (encoder._truncate_schedule(sh, int(sh["T"]) // 24,
                                              enc.pyr, c)
                   if cut == "capacity" else
                   encoder._truncate_schedule_to_layer(sh, 2, enc.pyr, c))
            if upd is not None:
                upds[i] = upd
        assert upds, "the cut masks nothing"
        stats = encoder.patch_frames(stats, upds)
    padded_T = encoder._bucket(int(stats["T"].max()))
    pairs, vmag, _ = tokens._sig_tokens(lin, stats, enc.pyr, c, padded_T)
    return enc, lin, stats, padded_T, pairs, vmag


def _jax_stats(stats, i):
    import jax.numpy as jnp

    return {k: jnp.asarray(stats[k][i].numpy()) for k in STAT_KEYS}


FINISH_CASES = [  # (w, h, c, kinds of the frames, cut)
    (64, 64, 3, ("mixed",), None),
    (96, 80, 3, ("flat", "noise", "mixed"), None),
    (64, 64, 1, ("mixed", "noise", "mixed"), "capacity"),
    (128, 32, 3, ("noise", "mixed", "mixed"), "layer"),
]


@pytest.mark.parametrize("w,h,c,kinds,cut", FINISH_CASES)
def test_finish_tokens_equals_jax(rng, w, h, c, kinds, cut):
    """tok_val, tok_raw and tok_vli of one ``_finish_tokens`` call over
    the frames equal the JAX package's ``_finish_tokens`` of each frame on
    the same zero-prefixes, signs, root band and stats; the arrays are
    contiguous, rows at stride padded_T."""
    import jax

    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu_torch.codec import tokens
    from dwt_tpu_torch.ops import finish

    imgs = np.stack([random_image(rng, w, h, c, k) for k in kinds])
    enc, lin, stats, padded_T, pairs, _ = _stage1(imgs, cut)
    got = tokens._finish_tokens(pairs, lin, stats, enc.pyr, c, padded_T)
    for t, dt in zip(got, (torch.int32, torch.int32, torch.bool)):
        assert t.dtype == dt and t.shape == (len(kinds), padded_T)
        assert t.is_contiguous()
    pyr = compute_pyramid(w, h)
    fn = jax.jit(lambda zp, sg, ln, st: je._finish_tokens(
        zp, sg, ln, st, pyr, c, padded_T))
    zp, sgn = finish._split_pairs(pairs)
    for i in range(len(kinds)):
        want = fn(zp[i].numpy(), sgn[i].numpy(), lin[i].numpy(),
                  _jax_stats(stats, i))
        for g, wnt in zip(got, want):
            wnt = np.asarray(wnt)
            assert g[i].numpy().dtype == wnt.dtype
            assert np.array_equal(g[i].numpy(), wnt)


@pytest.mark.parametrize("w,h,c,n", [(64, 64, 3, 1), (96, 80, 1, 3),
                                     (33, 17, 3, 2)])
def test_packed_elems_equals_jax(rng, w, h, c, n):
    """Kernel 13's plain version over N frames: frame f's rows equal the
    JAX package's ``_packed_elems`` of frame f, and the E-element tail is
    -1, as is the JAX package's."""
    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu_torch.codec import tokens
    from dwt_tpu_torch.codec.stage1 import segs_for
    from dwt_tpu_torch.ops import compact

    imgs = np.stack([random_image(rng, w, h, c, "mixed") for _ in range(n)])
    enc, lin, _, _, _, vmag = _stage1(imgs)
    assert torch.equal(vmag, tokens._packed_elems(
        lin, segs_for(enc.pyr, lin.device)))
    flat = vmag.reshape(-1).numpy()
    segs = je._Segs(compute_pyramid(w, h))
    per = c * (lin.shape[2] - segs.root_pad)
    for f in range(n):
        want = np.asarray(je._packed_elems(lin[f].numpy(), segs)).reshape(-1)
        assert vmag.dtype == torch.int32 and want.dtype == np.int32
        assert np.array_equal(flat[f * per:(f + 1) * per], want[:per])
        assert (want[per:] == -1).all()
    assert flat.size == n * per + compact.E and (flat[n * per:] == -1).all()


@pytest.mark.parametrize("w,h,c", [(64, 64, 3), (96, 80, 1)])
def test_split_pairs_equals_sig_tokens_xla(rng, w, h, c):
    """The zero-prefixes and signs split from kernel A's pairs equal the
    JAX package's ``_sig_tokens_xla`` on the same coefficients and stats."""
    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu_torch.ops import finish

    img = random_image(rng, w, h, c, "mixed")
    _, lin, stats, padded_T, pairs, _ = _stage1(img[None])
    assert pairs.shape == (1, padded_T // 2)
    zp, sgn = finish._split_pairs(pairs)
    wz, ws = je._sig_tokens_xla(lin[0].numpy(), _jax_stats(stats, 0),
                                compute_pyramid(w, h), c, padded_T)
    assert np.array_equal(zp[0].numpy(), np.asarray(wz))
    assert np.array_equal(sgn[0].numpy(), np.asarray(ws))


# --- kernel 12's plan, replayed in numpy ---------------------------------

def _i32(x):
    return np.asarray(x, np.int64).astype(np.uint32).view(np.int32)


def _upper(key, lo, hi, x):
    while lo < hi:
        mid = (lo + hi) >> 1
        if key[mid] <= x:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _lower(key, lo, hi, x):
    while lo < hi:
        mid = (lo + hi) >> 1
        if key[mid] < x:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _replay(a: dict) -> tuple:
    """Kernel 12 in numpy: the dense pass thread by thread (4 pairs each)
    over each frame's staged table, then the special tokens' phases, a
    256-value block scan at a time for the root ranks."""
    pairs = a["pairs"].astype(np.int64)
    N, npair = pairs.shape
    padded_T = 2 * npair
    val = np.zeros((N, padded_T), np.int64)
    raw = np.zeros((N, padded_T), np.int64)
    vli = np.zeros((N, padded_T), bool)
    for f in range(N):
        b = a["base_sched"][f].astype(np.int64)
        ns = a["nS_sched"][f].astype(np.int64)
        S = b.size
        sb = b >> 1
        pos = np.clip(sb, 0, npair - 1)
        se = _i32(sb + ns).astype(np.int64)
        assert (np.diff(b) >= 0).all() and (np.diff(se) >= 0).all()
        add = np.where(a["valid_sched"][f] & (ns > 0), a["cin_sched"][f], 0)
        cum = np.cumsum(add.astype(np.int64).astype(np.uint32),
                        dtype=np.uint32).astype(np.int64)
        for p0 in range(0, npair, PAIRS):
            zprev = pairs[f, p0 - 1] >> 1 if p0 else 0
            k = _upper(pos, 0, S, p0) - 1
            for p in range(p0, p0 + PAIRS):
                if k + 1 < S and pos[k + 1] <= p:
                    k = _upper(pos, k + 1, S, p) - 1
                s_b = s_e = cadd = 0
                if k >= 0:
                    s_b, s_e = max(sb[k], 0), max(se[k], 0)
                    if pos[k] == p:
                        lo = _lower(pos, 0, k, p)
                        cadd = cum[k] - (cum[lo - 1] if lo else 0)
                zp, sg = pairs[f, p] >> 1, pairs[f, p] & 1
                in_sig = p < s_e
                run = zp - (0 if p == s_b else zprev) + cadd
                val[f, 2 * p] = run if in_sig else zp
                val[f, 2 * p + 1] = sg
                raw[f, 2 * p + 1] = in_sig
                vli[f, 2 * p] = in_sig
                zprev = zp

        def put(s, v=None, r=None, fl=None):
            if 0 <= s < padded_T:
                if v is not None:
                    val[f, s] = v
                if r is not None:
                    raw[f, s] = r
                if fl is not None:
                    vli[f, s] = fl

        root, C = a["root"][f].astype(np.int64), a["root"].shape[1]
        pix0 = root.shape[1]
        for c in range(C):
            put(int(a["root_base"][f, c]), a["root_cnt"][f, c], fl=True)
        for phase in (2, 3):
            for c in range(C):
                cnt = int(a["root_cnt"][f, c])
                if cnt <= 0:
                    continue
                before = 0
                for i0 in range(0, pix0, BLOCK):
                    x = root[c, i0:i0 + BLOCK]
                    nz = (x != 0).astype(np.int64)
                    rank = before + np.cumsum(nz) - nz
                    before += int(nz.sum())
                    for i, (xi, rk) in enumerate(zip(x, rank)):
                        s = int(a["root_base"][f, c]) + 1 + i0 + i + int(rk)
                        if phase == 2:
                            put(s, abs(int(xi)), cnt)
                        elif xi != 0:
                            put(s + 1, int(xi < 0), 1)
        for c in range(C):
            put(int(a["planes_base"][f]) + c, a["planes"][f, c], fl=True)
        ok = a["refrun_ok"][f].reshape(-1)
        sbase = a["step_base"][f].reshape(-1)
        snS = a["nS"][f].reshape(-1)
        rv = a["refrun_val"][f].reshape(-1)
        for g in np.nonzero(ok)[0]:
            put(int(sbase[g]) + 2 * int(snS[g]), rv[g], fl=True)
        put(int(a["T"][f]) - 1, a["carry_end"][f], fl=True)
    return _i32(val), _i32(raw), vli


def _tables(rng, N, C, L, pix0, kind):
    """Synthetic inputs of kernel 12 (numpy, the wrapper's argument
    names), laid out as stage 1 lays a frame: root tokens, plane counts,
    then the steps' even bases; ``kind`` adds the edge a case is about."""
    S = C * L * PMAX
    out = {k: [] for k in ("pairs", "root", "base_sched", "nS_sched",
                           "cin_sched", "valid_sched", "root_cnt",
                           "root_base", "planes_base", "planes",
                           "refrun_ok", "step_base", "nS", "refrun_val",
                           "T", "carry_end")}
    for f in range(N):
        root = np.where(rng.random((C, pix0)) < 0.4, 0,
                        rng.integers(-4000, 4000, (C, pix0)))
        top = np.abs(root).max(axis=1)
        cnt = np.where(top > 0, 1 + np.floor(np.log2(np.maximum(top, 1))),
                       0).astype(np.int64)
        cnt[rng.random(C) < 0.25] = 0  # a channel whose root is masked
        ntok = 1 + np.where(cnt > 0, pix0 + (root != 0).sum(axis=1), 0)
        root_base = np.cumsum(ntok) - ntok
        planes_base = int(ntok.sum())
        b0 = (planes_base + C + 1) // 2 * 2
        valid = rng.random(S) < 0.7
        nS = np.where(valid, rng.integers(0, 12, S), 0)
        rr = valid & (rng.random(S) < 0.4)
        if kind == "ties":  # runs of empty steps share one base
            empty = rng.random(S) < 0.5
            nS[empty], rr[empty] = 0, False
        if kind == "empty first":
            nS[:3], rr[:3] = 0, False
        cnt_al = (2 * nS + rr + 1) // 2 * 2
        base = b0 + np.cumsum(cnt_al) - cnt_al
        if kind == "ties":  # and steps with pairs that tie, nS nondecreasing
            for j in range(S - 1):
                if (valid[j] & valid[j + 1] and 0 < nS[j] <= nS[j + 1]
                        and rng.random() < 0.5):
                    base[j + 1:] -= base[j + 1] - base[j]
                    rr[j] = rr[j + 1] = False
        T = int(base[-1] + cnt_al[-1] + 1)
        if kind == "clamped":  # a cut schedule keeps the bases past it
            cut = base >= base[S // 2]
            valid, rr = valid & ~cut, rr & ~cut
            nS = np.where(cut, 0, nS)
            T = int(base[S // 2]) + 1
        if kind == "refrun at the flush":
            T = int((base + 2 * nS)[np.nonzero(rr)[0][-1]]) + 1
        order = rng.permutation(S)  # schedule slot -> grid index
        for key, v in (("refrun_ok", rr), ("step_base", base), ("nS", nS),
                       ("refrun_val", rng.integers(0, 1 << 20, S))):
            g = np.zeros(S, v.dtype)
            g[order] = v
            out[key].append(g.reshape(C, L, PMAX))
        out["root"].append(root)
        out["root_cnt"].append(cnt)
        out["root_base"].append(root_base)
        out["planes_base"].append(planes_base)
        out["planes"].append(rng.integers(0, 25, C))
        out["base_sched"].append(base)
        out["nS_sched"].append(nS)
        out["cin_sched"].append(rng.integers(-2**31, 2**31, S))
        out["valid_sched"].append(valid)
        out["T"].append(T)
        out["carry_end"].append(int(rng.integers(0, 1 << 20)))
    npair = -(-max(out["T"]) // (2 * PAIRS)) * PAIRS  # a bucket past each T
    for f in range(N):
        zp = rng.integers(0, 1 << 29, npair)
        out["pairs"].append((zp << 1) | rng.integers(0, 2, npair))
    dt = {"valid_sched": bool, "refrun_ok": bool}
    return {k: np.stack(v).astype(dt.get(k, np.int32))
            for k, v in out.items()}


ARGS = ("pairs", "root", "base_sched", "nS_sched", "cin_sched",
        "valid_sched", "root_cnt", "root_base", "planes_base", "planes",
        "refrun_ok", "step_base", "nS", "refrun_val", "T", "carry_end")


@pytest.mark.parametrize("kind,N,C,L,pix0", [
    ("random", 3, 3, 2, 40), ("ties", 2, 3, 3, 40),
    ("clamped", 2, 1, 4, 12), ("empty first", 1, 3, 2, 16),
    ("refrun at the flush", 3, 1, 3, 20), ("wide root", 2, 3, 2, 300)])
def test_finish_plan_replay(kind, N, C, L, pix0):
    """Kernel 12's plan in numpy equals the plain version on synthetic
    tables: any int32 carries (their sums wrap), steps that tie on one
    base, bases past the bucket clamped at npair - 1, an empty first step,
    a ref-run token under the flush at T - 1, a root band of more than one
    block of 256 values."""
    from dwt_tpu_torch.ops import finish

    rng = np.random.default_rng(len(kind) * 7 + N)
    a = _tables(rng, N, C, L, pix0, kind)
    npair = a["pairs"].shape[1]
    assert (a["T"] <= 2 * npair).all()
    if kind == "clamped":
        assert (a["base_sched"] // 2 > npair - 1).any()
    if kind == "ties":
        assert (np.diff(a["base_sched"], axis=1) == 0).sum() > 20
        live = a["valid_sched"] & (a["nS_sched"] > 0)
        assert (live[:, 1:] & live[:, :-1]
                & (np.diff(a["base_sched"], axis=1) == 0)).any()
    if kind == "refrun at the flush":
        ok = a["refrun_ok"].reshape(N, -1)
        slot = (a["step_base"] + 2 * a["nS"]).reshape(N, -1)
        assert all((slot[f][ok[f]] == a["T"][f] - 1).any() for f in range(N))
    got = finish.finish_tokens(*(torch.as_tensor(a[k]) for k in ARGS))
    want = _replay(a)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("path", ["lossless", "capacity", "tiled",
                                  "budgeted tiled"])
def test_schedule_order_holds(rng, monkeypatch, path):
    """Every ``finish_tokens`` call of the encodes gets step tables in the
    order kernel 12 relies on: within each frame ``base_sched`` and
    ``base_sched / 2 + nS_sched`` are nondecreasing."""
    from dwt_tpu_torch.codec import encoder, tiled, tokens

    seen = []
    real = tokens.finish_tokens

    def spy(*args):
        seen.append((args[2].clone(), args[3].clone()))
        return real(*args)

    monkeypatch.setattr(tokens, "finish_tokens", spy)
    img = random_image(rng, 96, 80, 3, "mixed")
    if path == "lossless":
        encoder.encode(img, device="cpu")
    elif path == "capacity":
        encoder.encode(img, capacity=300, device="cpu")
    else:
        full = tiled.encode_tiled(img, tile=(32, 32), device="cpu")
        if path == "budgeted tiled":
            tiled.encode_tiled(img, tile=(32, 32), budget=len(full) // 4,
                               device="cpu")
    assert seen
    for base, nS in seen:
        assert (torch.diff(base, dim=1) >= 0).all()
        assert (torch.diff((base >> 1) + nS, dim=1) >= 0).all()


def _finish_args(rng):
    a = _tables(rng, 2, 3, 2, 8, "random")
    return [torch.as_tensor(a[k]) for k in ARGS]


@pytest.mark.parametrize("case", ["pairs dtype", "flags dtype",
                                  "step table shape", "frame table shape",
                                  "grid shape", "device"])
def test_finish_tokens_checks(case):
    """The wrapper raises on what kernel 12 does not take, on the CPU as
    on the card."""
    from dwt_tpu_torch.ops import finish

    args = _finish_args(np.random.default_rng(1))
    i = {k: j for j, k in enumerate(ARGS)}
    if case == "pairs dtype":
        args[0] = args[0].long()
    elif case == "flags dtype":
        args[i["valid_sched"]] = args[i["valid_sched"]].int()
    elif case == "step table shape":
        args[i["nS_sched"]] = args[i["nS_sched"]][:, 1:]
    elif case == "frame table shape":
        args[i["T"]] = args[i["T"]][:1]
    elif case == "grid shape":
        args[i["refrun_val"]] = args[i["refrun_val"]][..., 1:]
    else:
        args[i["root"]] = args[i["root"]].to("meta")
    with pytest.raises(ValueError):
        finish.finish_tokens(*args)


@pytest.mark.parametrize("case", ["lin dtype", "mask dtype", "rows",
                                  "mask longer", "device"])
def test_packed_elems_checks(case, monkeypatch):
    """The wrapper raises on what kernel 13 does not take."""
    from dwt_tpu_torch.ops import compact, finish

    monkeypatch.setattr(compact, "E", 64)
    monkeypatch.setattr(compact, "SUBA", 32)
    lin = torch.zeros((2, 3, 40), dtype=torch.int32)
    valid = torch.ones(32, dtype=torch.bool)
    assert finish.packed_elems(lin, valid).shape == (2 * 3 * 32 // 32 + 2,
                                                     32)
    if case == "lin dtype":
        lin = lin.long()
    elif case == "mask dtype":
        valid = valid.int()
    elif case == "rows":
        valid = valid[:30]
    elif case == "mask longer":
        valid = torch.ones(41, dtype=torch.bool)
    else:
        valid = valid.to("meta")
    with pytest.raises(ValueError):
        finish.packed_elems(lin, valid)
