"""Global truncation allocation across the tiles of a ``.dwtt`` container.

Port of ``dwt_tpu/parallel/tiled.py:allocate_budget``.  The module's halo
transforms (multi-device lifting) belong to the multi-GPU slice.
"""

from __future__ import annotations

import numpy as np


def allocate_budget(layer_bytes, budget: int) -> np.ndarray:
    """Cut a fleet of tile streams to a global byte budget.

    ``layer_bytes``: (n_tiles, n_layers) integers (numpy or a CPU tensor),
    the bytes each tile adds at each quality layer of the shared
    progressive schedule (layer 0 = header and root).  Returns (n_tiles,)
    int64 byte lengths: every tile keeps its stream prefix through the
    deepest layer k such that the total over all tiles of layers <= k fits
    the budget; the remainder within layer k is handed out tile by tile
    (the reference truncates mid-layer, bytes.h:75-78, here coordinated
    across tiles).

    Sums are int64.  The JAX package sums in int32, so the two agree
    wherever its sums do not wrap (totals below 2^31 bytes)."""
    lb = np.asarray(layer_bytes, dtype=np.int64)
    cum = lb.sum(axis=0).cumsum()
    k = int((cum <= budget).sum())  # full layers afforded
    nl = lb.shape[1]
    taken = lb[:, :k].sum(axis=1)
    rem = max(budget - (int(cum[k - 1]) if k > 0 else 0), 0)
    nxt = lb[:, k] if k < nl else np.zeros(lb.shape[0], np.int64)
    pfx = np.cumsum(nxt) - nxt
    return taken + np.clip(rem - pfx, 0, nxt)
