"""Kernel 15, kernel A's unit tables (``dwt_tpu_torch/ops/units.py``,
``csrc/units.cu``), on the CPU.

* Its plain version against the JAX package's ``_unit_common`` and
  ``_kernel_a_meta`` on the same stats: the six unit columns and the meta
  rows exactly (frame f's element rows and pair windows offset by the
  earlier frames'), at two token buckets, one frame and three; its table
  is the inverse of the units' (frame, channel, chunk, plane) index.
* The kernel's plan replayed in numpy: each unit's step by a binary
  search of the schedule's unit bases, which each thread's run of steps
  and one scan give.
* The wrapper's checks.

The kernel runs only on the card: ``tests/test_torch_card.py`` holds it
against this plain version there.
"""

import numpy as np
import pytest
import torch

from imagegen import random_image

PMAX = 29
THREADS = 256  # the kernel's block (csrc/units.cu)


def _port(w, h, c, n, seed):
    from dwt_tpu_torch.codec import encoder, stage1

    rng = np.random.default_rng(seed)
    frames = np.stack([random_image(rng, w, h, c, ("mixed", "noise", "flat")[
        i % 3]) for i in range(n)])
    enc = encoder.Encoder(w, h, c, device="cpu")
    lin, stats = enc.stage1_frames(frames)
    return enc, stats, stage1.segs_for(enc.pyr, lin.device)


@pytest.mark.parametrize("w,h,c,n", [(96, 80, 3, 1), (64, 48, 1, 3),
                                     (16, 16, 3, 3)])
@pytest.mark.parametrize("scale", [1, 4])
def test_unit_tables_plain_equals_jax(monkeypatch, w, h, c, n, scale):
    import jax.numpy as jnp

    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu_torch.codec import encoder, tokens
    from dwt_tpu_torch.ops import compact, units

    monkeypatch.setattr(je, "_use_pallas", lambda: False)
    enc, stats, segs = _port(w, h, c, n, w + n)
    padded_T = encoder._bucket(int(stats["T_host"].max())) * scale
    com, meta, pairbuf = tokens._unit_tables(stats, segs, padded_T)
    U = c * PMAX * segs.nchunk
    assert meta.shape == (n * U, 8) and meta.dtype == torch.int32
    pyr = compute_pyramid(w, h)
    jsegs = je._Segs(pyr)
    for f in range(n):
        js = {k: jnp.asarray(stats[k][f].numpy()) for k in (
            "order", "valid_sched", "step_base", "nS_ck", "nZ_ck")}
        want = je._unit_common(js, jsegs, pyr, c)
        for k in units.COM_KEYS:
            g, w_ = com[k][f].numpy(), np.asarray(want[k])
            assert g.dtype == w_.dtype and np.array_equal(g, w_), k
        wmeta, wbuf = je._kernel_a_meta(js, jsegs, want, padded_T)
        assert pairbuf == wbuf
        g = meta[f * U:(f + 1) * U].numpy().copy()
        g[:, 0] -= f * c * segs.n // compact.SUBA
        g[:, 3] -= f * pairbuf
        assert np.array_equal(g, np.asarray(wmeta))
    # the table is the inverse of flat_ck, frame f's units from f * U
    flat = (com["flat_ck"].long()
            + torch.arange(n)[:, None] * U).reshape(-1)
    table = com["table"]
    assert table.shape == (n * c * segs.nchunk, PMAX)
    assert torch.equal(table.reshape(-1)[flat],
                       torch.arange(n * U, dtype=torch.int32))
    assert torch.equal(torch.sort(table.reshape(-1)).values,
                       torch.arange(n * U, dtype=torch.int32))


def _replay_steps(order, lnc, L):
    """units_kernel's unit bases and each unit's step: per-run sums of the
    steps' chunk counts, one scan of the runs, a second walk; then a binary
    search for the last base at most u."""
    S = order.shape[0]
    per = -(-S // THREADS)
    ups = lnc[(order // PMAX) % L]
    runs = [(min(t * per, S), min(t * per + per, S)) for t in range(THREADS)]
    ub, acc = np.zeros(S, np.int64), 0
    for a, b in runs:  # the scan of the runs, then each run's walk
        for s in range(a, b):
            ub[s] = acc
            acc += ups[s]
    steps = []
    for u in range(acc):
        lo, hi = 0, S
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            lo, hi = (mid, hi) if ub[mid] <= u else (lo, mid)
        steps.append((lo, u - ub[lo]))
    return acc, steps


def test_unit_plan_replayed():
    """The replayed step search gives each unit the step and chunk that
    the plain version's searchsorted does, on a 3-frame sub-batch."""
    from dwt_tpu_torch.codec import tokens

    enc, stats, segs = _port(64, 48, 3, 3, 5)
    com, _, _ = tokens._unit_tables(stats, segs, 1 << 14)
    lnc = np.asarray(segs.level_nchunk)
    lcb = np.asarray(segs.level_chunk_base)
    L = enc.pyr.levels
    for f in range(3):
        order = stats["order"][f].numpy()
        U, steps = _replay_steps(order, lnc, L)
        assert U == 3 * PMAX * segs.nchunk
        ords = np.asarray([order[s] for s, _ in steps])
        chunk = np.asarray([lcb[(order[s] // PMAX) % L] + k
                            for s, k in steps])
        c, p = ords // (L * PMAX), ords % PMAX
        assert np.array_equal(com["flat_step"][f].numpy(), ords)
        assert np.array_equal(com["flat_ck"][f].numpy(),
                              (c * segs.nchunk + chunk) * PMAX + p)
        valid = stats["valid_sched"][f].numpy()[[s for s, _ in steps]]
        assert np.array_equal(com["valid"][f].numpy(), valid)


@pytest.mark.parametrize("case", ["order dtype", "valid dtype",
                                  "chunk tables", "chunk starts", "device"])
def test_unit_tables_checks(case):
    """The wrapper raises on what kernel 15 does not take."""
    from dwt_tpu_torch.ops import units

    enc, stats, segs = _port(16, 16, 3, 2, 1)
    args = [stats["order"], stats["valid_sched"], stats["step_base"],
            stats["nS_ck"], stats["scar_ck"], stats["zcar_ck"],
            segs.level_nchunk_t, segs.level_chunk_base_t, segs.ch_start_t,
            segs.ch_len_t, segs.n, 1 << 13]
    if case == "order dtype":
        args[0] = args[0].long()
    elif case == "valid dtype":
        args[1] = args[1].to(torch.int32)
    elif case == "chunk tables":
        args[4] = args[4][:1]
    elif case == "chunk starts":
        args[8] = args[8][:-1]
    else:
        args[5] = torch.empty(args[5].shape, dtype=torch.int32,
                              device="meta")
    with pytest.raises(ValueError):
        units.unit_tables(*args)
