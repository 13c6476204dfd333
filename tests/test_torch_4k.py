"""The 4K constants of chip_smoke.py, reproduced through both packages on
the CPU: the port (plain versions of its kernels) and the JAX package must
both write the stream whose length, token count and SHA-256 chip_smoke.py
holds the card's stream to.  Full size: marked slow, outside tier-1."""

import hashlib

import numpy as np
import pytest
import torch

from conftest import random_image

torch.set_num_threads(1)


@pytest.mark.slow
def test_4k_reference_constants():
    import chip_smoke
    from dwt_tpu.codec.encoder import get_encoder as jax_encoder
    from dwt_tpu_torch.codec.encoder import Encoder

    W, H, C = chip_smoke.W, chip_smoke.H, chip_smoke.C
    img = random_image(np.random.default_rng(0), W, H, C, "mixed")
    want = (chip_smoke.REF_BYTES, chip_smoke.REF_TOKENS,
            chip_smoke.REF_SHA256)
    for stream, info in (jax_encoder(W, H, C).encode_with_stats(img),
                         Encoder(W, H, C, device="cpu").encode_with_stats(img)):
        got = (len(stream), info["tokens"], hashlib.sha256(stream).hexdigest())
        assert got == want
