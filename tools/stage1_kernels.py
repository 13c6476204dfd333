#!/usr/bin/env python3
"""Stage 1's two kernels on one CUDA card, launch by launch.

    python3 tools/stage1_kernels.py [--root DIR] [--reps N]

``--root`` names the checkout whose ``dwt_tpu_torch`` is measured (default:
this one), so one command can measure two trees in turns; the measuring
code is this checkout's ``chip_smoke.py`` (``launch_ms``, ``time_ms``).
Two shapes: one 3840x2160 RGB frame (``tests/imagegen.py``'s "mixed"
image, seed 0) and a sub-batch of seven 1920x1080 frames (seeds 0-6), as
the encoder hands them to its two stage-1 kernels:

* the forward transform (``ops/lifting.py:forward_transform``, uint8,
  colour on);
* the plane statistics (``ops/plane_stats.py:plane_stats``) of the
  frames' linearized coefficients.

For each, every launch of one call, in launch order, with its kernel and
device time (torch.profiler, means of ``--reps`` calls after a warm one;
the launches a call are the wrapper's ``launches`` count), their sum, and
CUDA events around the whole call, which include the gaps between
launches and the wrapper's zero fills.  Prints one JSON line a shape, with
the card's name and power limit.  Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frames(root: str, w: int, h: int, n: int):
    import numpy as np

    gen = load("imagegen", os.path.join(root, "tests", "imagegen.py"))
    return np.stack([gen.random_image(np.random.default_rng(s), w, h, 3,
                                      "mixed") for s in range(n)])


def launches(smoke, torch, wrapper, fn, match: str, reps: int) -> dict:
    """Each launch of one ``fn()`` (``wrapper.launches`` of them) whose
    kernel name holds ``match``: [kernel, device ms] in launch order, or
    None where the profiler dropped events; the sum; the events' ms."""
    before = wrapper.launches
    fn()
    per_call = wrapper.launches - before
    ms = smoke.launch_ms(torch, fn, match, per_call, reps)
    return {"launches": ms, "device_ms": None if ms is None else
            sum(m for _, m in ms),
            "events_ms": smoke.time_ms(torch, fn, reps=reps)}


def measure(smoke, torch, x, reps: int) -> dict:
    """Both kernels on the (N, H, W, 3) uint8 frames ``x``."""
    from dwt_tpu_torch.codec import stage1
    from dwt_tpu_torch.codec.encoder import get_encoder
    from dwt_tpu_torch.ops import lifting, plane_stats

    n, h, w, c = x.shape
    enc = get_encoder(w, h, c)
    pyr = enc.pyr
    ft = lifting.forward_transform
    lin = stage1._linearize(ft(x, pyr, True), enc._src, pyr, c)
    segs = stage1.segs_for(pyr, lin.device)
    args = (lin.reshape(n * c, -1), segs.valid_t, segs.idx_local,
            segs.block_chunk, segs.unit_chunk_t, segs.chunk_base_t)
    return {"transform": launches(smoke, torch, ft,
                                  lambda: ft(x, pyr, True), "lift", reps),
            "statistics": launches(
                smoke, torch, plane_stats.plane_stats,
                lambda: plane_stats.plane_stats(*args), "plane_", reps)}


def line(res: dict) -> str:
    if res["launches"] is None:
        return (f"not measured (the profiler dropped kernel events), "
                f"events {res['events_ms']:.4f} ms")
    return ", ".join(f"{k} {m:.4f}" for k, m in res["launches"]) \
        + (f"; device {res['device_ms']:.4f} ms, events "
           f"{res['events_ms']:.4f} ms")


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("stage1_kernels: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    smoke = load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for label, (w, h, n) in (("4K frame", (3840, 2160, 1)),
                             ("7 1080p frames", (1920, 1080, 7))):
        x = torch.as_tensor(frames(root, w, h, n)).cuda()
        res = measure(smoke, torch, x, args.reps)
        print(json.dumps({"root": root, "shape": label, "card": card,
                          **res}), flush=True)
        print(f"{label}: transform {line(res['transform'])}; statistics "
              f"{line(res['statistics'])} on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
