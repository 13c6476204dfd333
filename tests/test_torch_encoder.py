"""The port's encoder against the JAX package and the spec model.

Every intermediate of the port's encode path — ``lin``, every ``stats``
key, the kernel metadata, the tokens and VLI orders, the stream words
before and after the refinement bits, the bit partials and layer ends —
must equal the JAX package's on the same image, and the stream must equal
``specmodel.encode``'s.  Exact: all of it is integer.  On the CPU each
kernel wrapper runs its plain PyTorch version.
"""

import numpy as np
import pytest
import torch

from conftest import random_image
from dwt_tpu import specmodel
from torch_parity import STATS_KEYS, jax_pipeline, to_np

torch.set_num_threads(1)

CASES = [  # tests/test_encoder.py's
    (64, 64, 1, "mixed"),
    (64, 64, 3, "mixed"),
    (96, 80, 3, "noise"),
    (321, 239, 1, "mixed"),
    (8, 8, 1, "mixed"),
    (9, 8, 3, "noise"),
    (64, 64, 3, "flat"),
    (128, 32, 1, "mixed"),
    (320, 240, 3, "mixed"),
]


def _port_pipeline(img):
    from dwt_tpu_torch.codec import emit, encoder, stage1, tokens

    h, w, c = img.shape
    enc = encoder.Encoder(w, h, c, device="cpu")
    pyr = enc.pyr
    lin, stats = stage1._transform_and_stats(torch.as_tensor(img), pyr, c,
                                             c == 1, enc._src)
    padded_T = encoder._bucket(int(stats["T"]))
    zp, sgn, vmag, com = tokens._sig_tokens(lin, stats, pyr, c, padded_T)
    segs = stage1.segs_for(pyr, lin.device)
    meta_a, _ = tokens._kernel_a_meta(stats, segs, com, padded_T)
    tv, tr, tf, orders, vmag2, com2 = tokens._stage2_tokens(lin, stats, pyr,
                                                            c, padded_T)
    nwords = emit._stream_words(pyr, c, padded_T)
    words_tok, parts, wild, off, refstart = emit._pack_bits(
        lin, stats, tv, tr, tf, orders, pyr, c, padded_T, nwords)
    meta_b = emit._kernel_b_meta(stats, segs, com, refstart, pyr, padded_T,
                                 nwords)
    words, bits_parts, wild, ends = emit._stage2_emit(
        lin, stats, tv, tr, tf, orders, vmag2, com2, pyr, c, padded_T)
    out = dict(lin=lin, zp=zp, sgn=sgn, meta_a=meta_a, meta_b=meta_b, tv=tv,
               tr=tr, tf=tf, orders=orders, words_tok=words_tok, words=words,
               bits_parts=bits_parts, layer_ends=ends,
               **{f"com_{k}": v for k, v in com.items()})
    out = {k: to_np(v) for k, v in out.items()}
    out["stats"] = {k: to_np(stats[k]) for k in STATS_KEYS}
    out["padded_T"], out["wild"] = padded_T, wild
    out["stream"] = enc.encode(img)
    return out


def _same(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype == np.uint32:  # stream words: int32 bit patterns here
        got = got.view(np.uint32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert np.array_equal(got, want), name


@pytest.mark.parametrize("w,h,c,kind", CASES)
def test_encoder_parity(rng, monkeypatch, w, h, c, kind):
    img = random_image(rng, w, h, c, kind)
    got = _port_pipeline(img)
    want = jax_pipeline(img, monkeypatch)
    assert got["padded_T"] == want["padded_T"]
    for k in STATS_KEYS:
        _same(f"stats[{k}]", got["stats"][k], want["stats"][k])
    for k in ("lin", "zp", "sgn", "meta_a", "meta_b", "tv", "tr", "tf",
              "orders", "words_tok", "words", "bits_parts", "layer_ends",
              "com_elem", "com_elen", "com_p", "com_flat_step",
              "com_flat_ck", "com_valid"):
        _same(k, got[k], want[k])
    assert got["wild"] == int(want["wild"]) == 0
    assert got["stream"][6:] == want["payload"]
    assert got["stream"] == specmodel.encode(img, gray=(c == 1))
