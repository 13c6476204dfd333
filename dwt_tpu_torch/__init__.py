"""dwt_tpu_torch — the PyTorch/CUDA port of the dwt_tpu codec for NVIDIA Hopper.

A second package beside ``dwt_tpu`` (the JAX reference).  It writes the
same ``.dwt`` bytes; the Pallas kernels of the JAX package become CUDA C++
kernels under ``csrc/``, built at first use by one ``nvcc`` process a
source (``runtime/build.py``) and bound with ``ctypes``.  Importing this package
has no side effects and imports neither JAX nor ``dwt_tpu``.

Port state: the single-stream encoder (``dwt_tpu_torch.codec.encoder``:
lossless, or cut to a byte budget), the single-stream decoder
(``dwt_tpu_torch.codec.decoder``: lossless, truncated and reduced-resolution
decodes, its bit parse in host C++ under ``native/``), the batch encoder,
batch decode and the tiled ``.dwtt`` container
(``dwt_tpu_torch.codec.tiled``).
"""

__version__ = "0.1.0"
