"""The port's 2-D transpose (kernel 6) and the VLI order scan that ran it
until the scan read the token arrays in place, against the JAX package:
``dwt_tpu.ops.pallas_transpose.transpose2d`` in Pallas interpret mode on
the cases of its own test, and ``dwt_tpu.codec.encoder._vli_orders``.
Exact, output dtype included.  On the CPU each wrapper runs its plain
PyTorch version."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _case(shape, dtype):
    rng = np.random.default_rng(3)
    if dtype == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    if dtype == "uint32":
        return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("shape,dtype", [  # tests/test_pallas_compact.py's
    ((40, 256), "int32"), ((256, 40), "int32"), ((384, 512), "uint32"),
    ((300, 300), "int32"), ((129, 257), "int8"),
])
def test_transpose_equals_jax(shape, dtype):
    from dwt_tpu.ops.pallas_transpose import transpose2d as jax_transpose
    from dwt_tpu_torch.ops import transpose

    x = _case(shape, dtype)
    want = np.asarray(jax_transpose(x, interpret=True))
    before = transpose.transpose2d.launches
    got = transpose.transpose2d(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert transpose.transpose2d.launches == before  # plain path: no launch
    assert np.array_equal(
        transpose.transpose2d_plain(torch.from_numpy(x)).numpy(), want)


def test_transpose_refuses_other_inputs():
    from dwt_tpu_torch.ops import transpose

    with pytest.raises(ValueError, match="2-D"):
        transpose.transpose2d(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32, uint32 or int8"):
        transpose.transpose2d(torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        transpose.transpose2d(torch.zeros((3, 2), dtype=torch.int32).T)
    with pytest.raises(ValueError, match="device"):
        transpose.transpose2d(torch.zeros((2, 2), dtype=torch.int8,
                                          device="meta"))
    assert transpose.transpose2d(
        torch.zeros((0, 5), dtype=torch.int8)).shape == (5, 0)


@pytest.mark.parametrize("padded_T", [4096, 6144 + 64])
def test_vli_orders_equal_jax(padded_T):
    """Random VLI values and flags through the port's scan and the JAX
    package's; 6208 tokens make the plain version's blocks 64 tokens."""
    import jax.numpy as jnp

    from dwt_tpu.codec import encoder as je
    from dwt_tpu_torch.codec import tokens

    rng = np.random.default_rng(padded_T)
    val = (rng.integers(0, 2**20, padded_T)
           >> rng.integers(0, 20, padded_T)).astype(np.int32)
    vli = rng.random(padded_T) < 0.6
    want = np.asarray(je._vli_orders(jnp.asarray(val), jnp.asarray(vli),
                                     padded_T))
    got = tokens._vli_orders(torch.from_numpy(val)[None],
                             torch.from_numpy(vli)[None], padded_T)[0].numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want.astype(np.int32)) and got.max() > 3
