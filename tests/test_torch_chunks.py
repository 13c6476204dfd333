"""Sub-batch sizing of the batch mode (``codec/tiled.py:BatchEncoder``).

Every sub-batch that ``_chunks`` yields must fit stage 2's int32 indices
(``encoder._check_batch``) at the largest token bucket a frame of its
geometry can reach (``encoder.max_tokens``), for square tiles of 8 to 32
pixels, grey and RGB; where the pixel bound is the tighter one (24x24 RGB
and above) the count is the pixel bound's, as before.  Frames are a
zero-stride view: nothing of the frames' size is allocated.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SIDES = list(range(8, 33))


def _encoder(side, c):
    from dwt_tpu_torch.codec import tiled

    return tiled.BatchEncoder(side, side, c, "cpu")


def _sizes(enc, n):
    view = np.broadcast_to(np.zeros((1,) + (enc.pyr.height, enc.pyr.width,
                                            enc.channels), np.uint8),
                           (n, enc.pyr.height, enc.pyr.width, enc.channels))
    return [b.shape[0] for b in enc._chunks(view)]


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("side", SIDES)
def test_sub_batches_fit_the_int32_indices(side, c):
    from dwt_tpu_torch.codec import encoder

    enc = _encoder(side, c)
    pyr, nlin = enc.pyr, enc.enc._src.numel()
    bucket = encoder._bucket(encoder.max_tokens(pyr, c))
    old = enc.MAX_PIXELS_PER_DISPATCH // pyr.total
    n = 2 * old + 5
    sizes = _sizes(enc, n)
    assert sum(sizes) == n and len(set(sizes[:-1])) == 1
    for k in set(sizes):
        encoder._check_batch(k, nlin, pyr, c, bucket)
    # The largest count that passes: one more frame does not.
    with pytest.raises(ValueError, match="int32"):
        encoder._check_batch(enc.max_frames + 1, nlin, pyr, c, bucket)
    assert sizes[0] == min(old, enc.max_frames)
    if c == 3 and side >= 24:
        assert sizes[0] == old


def test_small_tiles_of_one_image_are_split_where_the_old_count_raised():
    """2736x2736 RGB in 16x16 tiles: 29,241 tiles of one geometry, more
    than one sub-batch can hold (the pixel bound alone gave 62,500 frames
    a sub-batch, which ``_check_batch`` refuses)."""
    from dwt_tpu_torch.codec import encoder, tiled

    img = np.broadcast_to(np.zeros((1, 1, 3), np.uint8), (2736, 2736, 3))
    groups, n_tiles = tiled.group_tiles(img, (16, 16))
    assert n_tiles == 29_241 and list(groups) == [(16, 16)]
    enc = _encoder(16, 3)
    pyr, nlin = enc.pyr, enc.enc._src.numel()
    bucket = encoder._bucket(encoder.max_tokens(pyr, 3))
    old = enc.MAX_PIXELS_PER_DISPATCH // pyr.total
    assert old >= n_tiles
    with pytest.raises(ValueError, match="int32"):
        encoder._check_batch(n_tiles, nlin, pyr, 3, bucket)
    sizes = _sizes(enc, n_tiles)
    assert sizes == [enc.max_frames, n_tiles - enc.max_frames]


@pytest.mark.parametrize("w,h,c,kind", [(8, 8, 1, "noise"),
                                        (16, 16, 3, "noise"),
                                        (23, 17, 3, "mixed")])
def test_max_tokens_bounds_a_frame(rng, w, h, c, kind):
    """The format's bound on the token slots holds on frames that need
    many of them (noise), and the bucket it gives covers their T."""
    from imagegen import random_image

    from dwt_tpu_torch.codec import encoder

    enc = encoder.Encoder(w, h, c, device="cpu")
    frames = np.stack([random_image(rng, w, h, c, kind) for _ in range(4)])
    _, stats = enc.stage1_frames(frames)
    bound = encoder.max_tokens(enc.pyr, c)
    assert int(stats["T"].max()) <= bound
    assert encoder._bucket(int(stats["T"].max())) <= encoder._bucket(bound)
