"""The encoder's VLI order scan (``dwt_tpu_torch/ops/vli_scan.py``) on the
CPU, where the wrapper runs its plain PyTorch version.

Held exactly, dtype included:

- ``codec/tokens.py:_vli_orders`` (two transposes around the scan)
  against the JAX package's ``dwt_tpu.codec.encoder._vli_orders``, frame
  by frame, and against ``dwt_tpu.specmodel.VliWriter``'s order read
  before each VLI value it writes (vli.h:67-84), at 1-3 frames and
  blocks of 128, 64 and 16 tokens;
- edge cases: no VLI token, every token a VLI value, the largest values;
- a batch of frames against each frame's own scan;
- ``vli_orders_plain`` on any transition parameters (the order clamped at
  30 included) against a numpy replay token by token;
- the three kernels' decomposition (``csrc/vli_scan.cu``: maps two
  states a 32-bit word with Hopper's DPX max, and segment aggregates; a
  walk a frame over the segments in chunks; a replay a segment) replayed
  in numpy at the kernels' sizes and at small ones.  The CUDA code
  itself runs only on the card (``tests/test_torch_card.py``,
  ``chip_smoke.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "dwt_tpu_torch" / "csrc"
# (tokens a block, padded_T): 20, 37 and 83 blocks of a frame.
BLOCKS = ((128, 128 * 20), (64, 64 * 37), (16, 16 * 83))


def _tokens(rng, n, padded_T, kind="mixed"):
    """(n, padded_T) int32 VLI values and bool flags."""
    if kind == "largest":
        val = rng.integers(2**30, 2**31, (n, padded_T))
    else:
        val = rng.integers(0, 2**20, (n, padded_T)) \
            >> rng.integers(0, 20, (n, padded_T))
    vli = {"mixed": rng.random((n, padded_T)) < 0.6,
           "inactive": np.zeros((n, padded_T), bool)}.get(
               kind, np.ones((n, padded_T), bool))
    return val.astype(np.int32), vli


def _specmodel_orders(val, vli):
    """Each token's order before it: the reference writer's state, read
    before each VLI value it writes (a frame starts at order 0)."""
    from dwt_tpu import specmodel

    out = np.zeros(val.shape, np.int32)
    for f in range(val.shape[0]):
        w = specmodel.VliWriter(specmodel.BitWriter())
        for i in range(val.shape[1]):
            out[f, i] = w.order
            if vli[f, i]:
                w.put(int(val[f, i]))
    return out


def _port_orders(val, vli, padded_T):
    from dwt_tpu_torch.codec import tokens

    got = tokens._vli_orders(torch.from_numpy(val), torch.from_numpy(vli),
                             padded_T)
    assert got.dtype == torch.int32 and got.shape == val.shape
    return got.numpy()


def _jax_orders(val, vli, padded_T):
    import jax.numpy as jnp

    from dwt_tpu.codec import encoder as je

    return np.stack([np.asarray(je._vli_orders(
        jnp.asarray(v), jnp.asarray(f), padded_T)).astype(np.int32)
        for v, f in zip(val, vli)])


@pytest.mark.parametrize("tb,padded_T", BLOCKS)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_orders_equal_jax_and_specmodel(n, tb, padded_T):
    from dwt_tpu_torch.codec import tokens

    TB = tokens.VLI_BLOCK
    while padded_T % TB:
        TB //= 2
    assert TB == tb
    val, vli = _tokens(np.random.default_rng(n * padded_T), n, padded_T)
    got = _port_orders(val, vli, padded_T)
    assert np.array_equal(got, _jax_orders(val, vli, padded_T))
    assert np.array_equal(got, _specmodel_orders(val, vli))
    assert got.max() > 3


@pytest.mark.parametrize("kind", ["inactive", "active", "largest"])
@pytest.mark.parametrize("n", [1, 3])
def test_orders_at_the_edges(n, kind):
    """No VLI token (every order 0), every token a VLI value, and values
    of 2^30 and more (orders up to 29, the most an int32 value reaches)."""
    tb, padded_T = BLOCKS[1]
    val, vli = _tokens(np.random.default_rng(7), n, padded_T, kind)
    got = _port_orders(val, vli, padded_T)
    assert np.array_equal(got, _jax_orders(val, vli, padded_T))
    assert np.array_equal(got, _specmodel_orders(val, vli))
    if kind == "inactive":
        assert not got.any()
    if kind == "largest":
        assert got.max() == 29


@pytest.mark.parametrize("tb,padded_T", BLOCKS)
def test_batch_orders_equal_single_frames(tb, padded_T):
    """Three frames in one scan: each frame's orders equal its own scan's
    (no state carries from one frame to the next)."""
    val, vli = _tokens(np.random.default_rng(tb), 3, padded_T)
    got = _port_orders(val, vli, padded_T)
    for f in range(3):
        one = _port_orders(val[f:f + 1], vli[f:f + 1], padded_T)
        assert np.array_equal(got[f:f + 1], one)


def _replay(x, nblk):
    """Numpy, token by token: frame f's tokens are columns f * nblk ...
    of the (TB, R) parameters, each column's TB tokens in order."""
    TB, R = x.shape
    n = R // nblk
    xs = x.reshape(TB, n, nblk).astype(np.int64)
    out = np.zeros((TB, n, nblk), np.int8)
    s = np.zeros(n, np.int64)
    for i in range(nblk):
        for t in range(TB):
            out[t, :, i] = s
            v = xs[t, :, i]
            a, b = (v - 1) & 31, ((v - 1) >> 5) & 31
            ns = np.clip(np.maximum(s, a + (s >= b)) - 2, 0, 30)
            s = np.where(v > 0, ns, s)
    return out.reshape(TB, R)


def _params(rng, tb, r, kind):
    """(tb, r) int32 transition parameters: every (a, b) pair, 0, and
    values outside [0, 1024] (kind "any"), or ones that hold the order at
    30 (a = 31, b = 0)."""
    if kind == "saturating":
        x = np.where(rng.random((tb, r)) < 0.8, 32, 0)
    else:
        x = rng.integers(-3, 1026, (tb, r))
        x[rng.random((tb, r)) < 0.01] = 2**31 - 1
    return x.astype(np.int32)


@pytest.mark.parametrize("kind", ["any", "saturating"])
@pytest.mark.parametrize("tb,nblk,n", [(128, 5, 1), (64, 7, 3), (16, 19, 2),
                                       (1, 33, 2)])
def test_plain_equals_token_replay(tb, nblk, n, kind):
    from dwt_tpu_torch.ops import vli_scan

    x = _params(np.random.default_rng(tb + nblk), tb, n * nblk, kind)
    got = vli_scan.vli_orders_plain(torch.from_numpy(x), nblk)
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert np.array_equal(got.numpy(), _replay(x, nblk))
    if kind == "saturating":
        assert got.max() == 30


# --- the kernels' decomposition, replayed -----------------------------------

def _const(name):
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / "vli_scan.cu").read_text())
    return int(m.group(1))


def _halves(w):
    """uint32 words -> their (low, high) 16-bit halves, as int64."""
    w = np.asarray(w, np.int64)
    return w & 0xFFFF, w >> 16


def vimax3_u16x2(a, b, c):
    """Hopper's DPX max of three, on each 16-bit half of uint32 words."""
    (a0, a1), (b0, b1), (c0, c1) = _halves(a), _halves(b), _halves(c)
    lo = np.maximum(np.maximum(a0, b0), c0)
    hi = np.maximum(np.maximum(a1, b1), c1)
    return (lo | hi << 16).astype(np.uint32)


def byte_perm_6420(x, y):
    """``__byte_perm(x, y, 0x6420)``: bytes 0 and 2 of x, then of y."""
    x, y = np.asarray(x, np.int64), np.asarray(y, np.int64)
    return ((x & 0xFF) | (x >> 16 & 0xFF) << 8 | (y & 0xFF) << 16
            | (y >> 16 & 0xFF) << 24).astype(np.uint32)


def _kernel_plan(x, nblk, seg, chunk):
    """``csrc/vli_scan.cu`` in numpy: the same grid, segments, 32-bit
    words of two 16-bit states, byte maps and walks, with ``seg`` columns
    a segment and ``chunk`` aggregates a staged walk."""
    TB, R = x.shape
    n = R // nblk
    nseg = -(-nblk // seg)
    x64 = x.astype(np.int64)
    # vli_maps_kernel: every column's map, two states a word.
    m = np.tile((0x00010000 + 0x00020002 * np.arange(16)).astype(np.uint32),
                (R, 1))
    two = np.uint32(0x00020002)
    for t in range(TB):
        v = x64[t]
        p = (v - 1) & 0xFFFFFFFF
        aa = ((p & 31) * 0x00010001).astype(np.uint32)[:, None]
        bb = (((p >> 5) & 31) * 0x00010001).astype(np.uint32)[:, None]
        ge = (((m | np.uint32(0x80008000)) - bb) >> np.uint32(15)) \
            & np.uint32(0x00010001)
        new = vimax3_u16x2(m, aa + ge, two) - two
        m = np.where((v > 0)[:, None], new, m)
    w = byte_perm_6420(m[:, 0::2], m[:, 1::2])
    maps = np.ascontiguousarray(w).view(np.uint8).reshape(R, 32)

    def segment(g):
        f, j = divmod(g, nseg)
        return f * nblk + j * seg, min(seg, nblk - j * seg)

    agg = np.zeros((n * nseg, 32), np.uint8)
    for g in range(n * nseg):
        r0, cnt = segment(g)
        s = np.arange(32)
        for c in range(cnt):
            s = maps[r0 + c][s]
        agg[g] = s
    # vli_entry_kernel: a walk a frame, ``chunk`` aggregates at a time.
    seg_in = np.zeros(n * nseg, np.uint8)
    for f in range(n):
        s = 0
        for j0 in range(0, nseg, chunk):
            for c in range(min(chunk, nseg - j0)):
                seg_in[f * nseg + j0 + c] = s
                s = agg[f * nseg + j0 + c][s]
    # vli_replay_kernel: each segment's entry states, then a column's
    # tokens from its own.
    entry = np.zeros(R, np.int64)
    for g in range(n * nseg):
        r0, cnt = segment(g)
        s = int(seg_in[g])
        for c in range(cnt):
            entry[r0 + c] = s
            s = maps[r0 + c][s]
    out = np.zeros((TB, R), np.int8)
    s = entry
    for t in range(TB):
        out[t] = s
        v = x64[t]
        a, b = (v - 1) & 31, ((v - 1) >> 5) & 31
        ns = np.minimum(np.maximum(np.maximum(s, a + (s >= b)) - 2, 0), 30)
        s = np.where(v > 0, ns, s)
    return out


@pytest.mark.parametrize("sizes", ["kernel", "small"])
@pytest.mark.parametrize("tb,nblk,n,kind", [
    (128, 300, 1, "any"), (64, 37, 3, "any"), (16, 83, 2, "saturating"),
    (8, 600, 2, "any"), (1, 9, 3, "any")])
def test_kernel_plan_equals_plain(tb, nblk, n, kind, sizes):
    """At the kernels' SEG and CHUNK (300 and 600 blocks: a ragged second
    and third segment) and at 4 and 3 (many segments, ragged ends)."""
    from dwt_tpu_torch.ops import vli_scan

    seg, chunk = (_const("SEG"), _const("CHUNK")) if sizes == "kernel" \
        else (4, 3)
    x = _params(np.random.default_rng(nblk), tb, n * nblk, kind)
    want = vli_scan.vli_orders_plain(torch.from_numpy(x), nblk).numpy()
    assert np.array_equal(_kernel_plan(x, nblk, seg, chunk), want)


def test_wrapper_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; it refuses what the kernels do not take."""
    from dwt_tpu_torch.ops import vli_scan

    assert vli_scan.SEG == _const("SEG")
    x = torch.from_numpy(_params(np.random.default_rng(1), 16, 10, "any"))
    before = vli_scan.vli_orders.launches
    got = vli_scan.vli_orders(x, 5)
    assert vli_scan.vli_orders.launches == before
    assert torch.equal(got, vli_scan.vli_orders_plain(x, 5))
    with pytest.raises(ValueError, match="int32"):
        vli_scan.vli_orders(x.long(), 5)
    with pytest.raises(ValueError, match="2-D"):
        vli_scan.vli_orders(x.reshape(-1), 5)
    with pytest.raises(ValueError, match="whole number"):
        vli_scan.vli_orders(x, 3)
    with pytest.raises(ValueError, match="contiguous"):
        vli_scan.vli_orders(x.T.contiguous().T, 5)
    with pytest.raises(ValueError, match="device"):
        vli_scan.vli_orders(torch.zeros((2, 4), dtype=torch.int32,
                                        device="meta"), 2)


def test_kernel_names_hold_no_other():
    """The benchmark finds a kernel's profiler events by a substring of
    its name, so no kernel of ``csrc/`` may have another's name in its
    own."""
    names = set()
    for src in CSRC.glob("*.cu"):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(\w+)", src.read_text()))
    assert {"vli_maps_kernel", "vli_entry_kernel",
            "vli_replay_kernel", "transpose_kernel"} <= names
    for a in names:
        assert not [b for b in names if a != b and a in b], a
