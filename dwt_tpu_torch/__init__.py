"""dwt_tpu_torch — the PyTorch/CUDA port of the dwt_tpu codec for NVIDIA Hopper.

A second package beside ``dwt_tpu`` (the JAX reference).  It writes the
same ``.dwt`` bytes; the Pallas kernels of the JAX package become CUDA C++
kernels under ``csrc/``, built with one ``nvcc`` call at first use
(``runtime/build.py``) and bound with ``ctypes``.  Importing this package
has no side effects and imports neither JAX nor ``dwt_tpu``.

Port state: the single-stream lossless encoder
(``dwt_tpu_torch.codec.encoder``).
"""

__version__ = "0.1.0"
