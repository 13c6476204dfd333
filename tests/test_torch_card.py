"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same CUDA tensors (exact), at ragged shapes the 4K main
path of chip_smoke.py does not reach, and the encoder on the card against
the same encoder on the CPU.  Skipped where there is no CUDA card.

On a machine with a card (no JAX needed):

    python3 -m pytest --noconftest -m card tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from imagegen import random_image

pytestmark = pytest.mark.card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _elements(rng, n):
    mag = np.where(rng.random(n) < 0.35, 0,
                   (1 << rng.integers(0, 13, n)) + rng.integers(0, 64, n))
    v = (mag | (rng.integers(0, 2, n) << 30)).astype(np.int64)
    v[rng.random(n) < 0.02] = -1
    return v.astype(np.int32)


def _meta(rng, nunits, E, sub, col4_max):
    """Units at consecutive E-element chunks with ragged valid lengths,
    random planes and carries, a few skipped; counts generous (the kernels
    cap at the true count themselves)."""
    rows, base = [], 0
    for u in range(nunits):
        elen = E - int(rng.integers(0, 1000)) if u % 2 else E
        cnt = 0 if u % 7 == 6 else E
        rows.append([u * E // sub, elen, int(rng.integers(0, 10)), base,
                     int(rng.integers(0, col4_max)),
                     int(rng.integers(0, 5000)), cnt, 0])
        base += E // 4 + 256  # disjoint output ranges
    return torch.as_tensor(np.asarray(rows, np.int32))


def test_compact_kernels_equal_plain(cuda):
    from dwt_tpu_torch.ops import compact

    rng = np.random.default_rng(31)
    E, nunits = compact.E, 12
    vmag = torch.as_tensor(_elements(rng, (nunits + 1) * E)).reshape(
        -1, compact.SUBA).to(cuda)
    meta = _meta(rng, nunits, E, compact.SUBA, 100).to(cuda)
    npairs = int(meta[-1, 3]) + E + 512
    got = compact.compact_tokens(vmag, meta, npairs)
    want = compact.compact_tokens_plain(vmag, meta, npairs)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int((want != 0).sum()) > 10000

    meta_b = meta.clone()
    meta_b[:, 3] = meta[:, 3] // 4  # word windows of the bit ranges
    nwords = int(meta_b[-1, 3]) + E // 32 + 512
    words = torch.as_tensor(rng.integers(-2**31, 2**31, nwords, dtype=np.int64)
                            .astype(np.int32)).to(cuda)
    got = compact.scatter_refbits(vmag, meta_b, words.clone())
    want = compact.scatter_refbits_plain(vmag, meta_b, words.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not torch.equal(got, words)


@pytest.mark.parametrize("n", [1, 31, 12345, 1 << 20])
def test_pack_kernel_equals_plain(cuda, n):
    from dwt_tpu_torch.ops import pack

    rng = np.random.default_rng(n)
    steps = rng.integers(0, 4, n)
    steps[rng.random(n) < 0.001] += 5000  # injection-like jumps
    widx = torch.as_tensor(np.cumsum(steps).astype(np.int32)).to(cuda)
    cs = [torch.as_tensor(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                          .astype(np.int32)).to(cuda) for _ in range(3)]
    nwords = int(widx[-1]) + 3
    got = pack.pack_words(widx, *cs, nwords)
    want = pack.pack_words_plain(widx, *cs, nwords)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_pack_kernel_rejects_unsorted_widx(cuda):
    from dwt_tpu_torch.ops import pack

    c = torch.ones(64, dtype=torch.int32, device=cuda)
    widx = torch.arange(64, dtype=torch.int32, device=cuda)
    widx[40] = 3  # one step back
    before = pack.pack_words.launches
    with pytest.raises(ValueError, match="nondecreasing"):
        pack.pack_words(widx, c, c, c, 80)
    assert pack.pack_words.launches == before


def test_engine_probe_launches_once_a_device(cuda):
    from dwt_tpu_torch.ops import hilbert_gather as hg

    hg._PROBED.clear()
    before = hg.engine_supported.launches
    assert hg.engine_supported(cuda) and hg.engine_supported(cuda)
    assert hg.engine_supported.launches == before + 1
    co, src = hg.probe_tile(cuda)
    assert torch.equal(hg.engine_probe(co, src),
                       hg.hilbert_gather_plain(co, src))


@pytest.mark.parametrize("w,h,c", [(321, 239, 3), (64, 48, 1), (8, 8, 3)])
def test_gather_kernel_equals_plain(cuda, w, h, c):
    from dwt_tpu_torch.codec.stage1 import gather_source
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import hilbert_gather as hg

    rng = np.random.default_rng(w)
    co = torch.as_tensor(rng.integers(-2**20, 2**20, (h, w, c))
                         .astype(np.int32)).to(cuda)
    src = torch.as_tensor(gather_source(compute_pyramid(w, h))).to(cuda)
    got = hg.hilbert_gather(co, src)
    want = hg.hilbert_gather_plain(co, src)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("w,h,c,kind", [(64, 64, 1, "mixed"),
                                        (96, 80, 3, "noise"),
                                        (321, 239, 1, "mixed"),
                                        (9, 8, 3, "noise"),
                                        (64, 64, 3, "flat"),
                                        (320, 240, 3, "mixed")])
def test_encoder_on_card_equals_cpu(cuda, w, h, c, kind):
    from dwt_tpu_torch.codec import encoder
    from dwt_tpu_torch.ops import compact, hilbert_gather, pack

    img = random_image(np.random.default_rng(7), w, h, c, kind)
    fns = (hilbert_gather.hilbert_gather, compact.compact_tokens,
           compact.scatter_refbits, pack.pack_words)
    before = [f.launches for f in fns]
    got = encoder.Encoder(w, h, c).encode(img)
    assert got == encoder.Encoder(w, h, c, device="cpu").encode(img)
    moved = [f.launches - b for f, b in zip(fns, before)]
    assert moved == [1, 1, 1, 1], moved
