"""Property-style fuzz of the port (tests/test_fuzz.py mirrored): random
geometries and content classes through the port's encoder and decoder,
held to the sequential spec model, whole and at random truncation points.
Exact.  On the CPU each kernel wrapper runs its plain PyTorch version."""

import numpy as np
import pytest
import torch

from conftest import random_image
from dwt_tpu import specmodel

torch.set_num_threads(1)


@pytest.mark.parametrize("case", range(12))
def test_fuzz_roundtrip(case):
    from dwt_tpu_torch.codec import decoder, encoder

    rng = np.random.default_rng(9000 + case)
    w = int(rng.integers(8, 200))
    h = int(rng.integers(8, 200))
    c = int(rng.choice([1, 3]))
    kind = ["mixed", "noise", "flat"][case % 3]
    img = random_image(rng, w, h, c, kind)
    what = str((w, h, c, kind))

    stream = encoder.encode(img, device="cpu")
    assert stream == specmodel.encode(img, gray=(c == 1)), what

    out, _ = decoder.decode(stream, device="cpu")
    want, _ = specmodel.decode(stream)
    np.testing.assert_array_equal(out, want.astype(np.uint8), err_msg=what)

    for cap in sorted(rng.integers(8, max(len(stream), 10), 2).tolist()):
        cut = stream[:cap]
        try:
            want, _ = specmodel.decode(cut)
        except ValueError:
            with pytest.raises(ValueError):
                decoder.decode(cut, device="cpu")
            continue
        got, _ = decoder.decode(cut, device="cpu")
        np.testing.assert_array_equal(got, want.astype(np.uint8),
                                      err_msg=f"{what} cap={cap}")
