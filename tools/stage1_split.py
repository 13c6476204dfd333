#!/usr/bin/env python3
"""Where the port's encoder stage 1 spends its time, pass by pass, on one
CUDA card.

    python3 tools/stage1_split.py [--root DIR] [--reps N]

``--root`` names the checkout whose ``dwt_tpu_torch`` is measured (default:
this one), so one command can split two trees in turns.  Two shapes: one
3840x2160 RGB frame (``tests/imagegen.py``'s "mixed" image, seed 0) and a
sub-batch of seven 1920x1080 frames (seeds 0-6), as the batch mode sends
them.  Each pass is timed by the host clock between synchronised marks and
by CUDA events:

* upload: the frames to the card (the encoder's ``_upload`` where the tree
  has one, else ``torch.as_tensor``, as its ``stage1_frames`` does);
* colour and lifting: from the start of ``stage1._transform_and_stats`` to
  the start of ``_linearize``;
* gather: ``_linearize`` (the gather kernel and the root band);
* statistics: the plane statistics (``_detail_q`` and ``_plane_stats``, or
  ``plane_stats`` and ``_level_stats``, whichever the tree calls: a tree
  with kernel 14 calls ``plane_stats`` alone, the level sums being
  kernel 14's);
* schedule and carry: the rest of ``_stats_from_lin`` (with kernel 14,
  its one call and the one device-to-host copy of planes_max and T;
  before, the level sums' and the schedule's small launches, a
  device-to-host copy, the host carry chain, a host-to-device copy and
  the token bases).

``split`` measures the tree that ``enc`` (an ``Encoder``) comes from, so
``chip_smoke.py --parent`` splits two trees in turns in one process.

The marks synchronise the card, so the passes add up to more than an
unmarked stage 1; the unmarked ``stage1_frames`` is timed beside them.
A pass's event time is the card's clock between its marks, idle gaps
included, not its busy time.
The means of ``--reps`` runs after one warm run are printed as one JSON
line a shape, with the card's name and power limit.  Needs a card; exits
1 without one.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

STATS_NAMES = ("_detail_q", "_plane_stats", "plane_stats", "_level_stats")


def frames(root: str, w: int, h: int, n: int):
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "imagegen", os.path.join(root, "tests", "imagegen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return np.stack([mod.random_image(np.random.default_rng(s), w, h, 3,
                                      "mixed") for s in range(n)])


def split_once(torch, enc, imgs) -> dict:
    """One stage 1 of ``imgs`` with its passes marked: {pass: (host ms,
    device ms)}, and "stage1" for the marked whole."""
    stage1 = importlib.import_module(
        type(enc).__module__.rsplit(".", 1)[0] + ".stage1")

    marks = {}

    def mark(name):
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.setdefault(name, []).append((time.perf_counter(), ev))

    def spans(prefix):
        return [(a, b) for a, b in zip(marks.get(prefix + "+", []),
                                       marks.get(prefix + "-", []))]

    def timed(name, fn):
        def run(*args, **kwargs):
            mark(name + "+")
            out = fn(*args, **kwargs)
            mark(name + "-")
            return out
        return run

    names = ["_linearize", "_stats_from_lin"] + [
        n for n in STATS_NAMES if hasattr(stage1, n)]
    saved = {n: getattr(stage1, n) for n in names}
    upload = getattr(enc, "_upload", None) or (
        lambda a: torch.as_tensor(a, device=enc.device))
    for n in names:
        setattr(stage1, n, timed(n, saved[n]))
    try:
        mark("upload+")
        x = upload(imgs)
        mark("upload-")
        mark("stage1+")
        stage1._transform_and_stats(x, enc.pyr, enc.channels, enc.gray,
                                    enc._src)
        mark("stage1-")
    finally:
        for n in names:
            setattr(stage1, n, saved[n])
    torch.cuda.synchronize()

    def ms(a, b):
        return 1e3 * (b[0] - a[0]), a[1].elapsed_time(b[1])

    def total(prefixes):
        parts = [ms(a, b) for p in prefixes for a, b in spans(p)]
        return tuple(sum(x[i] for x in parts) for i in range(2))

    (s0, s1), = spans("stage1")
    (l0, l1), = spans("_linearize")
    stats = total([n for n in STATS_NAMES if n in names])
    whole = total(["_stats_from_lin"])
    out = {"upload": total(["upload"]),
           "colour and lifting": ms(s0, l0),
           "gather": ms(l0, l1),
           "statistics": stats,
           "schedule and carry": tuple(w - s for w, s in zip(whole, stats)),
           "stage1": ms(s0, s1)}
    return out


def split(torch, enc, imgs, reps: int) -> dict:
    """Means over ``reps`` marked runs after a warm one, and the unmarked
    ``stage1_frames`` (host clock, synchronised after) beside them."""
    split_once(torch, enc, imgs)
    runs = [split_once(torch, enc, imgs) for _ in range(reps)]
    out = {k: [sum(r[k][i] for r in runs) / reps for i in range(2)]
           for k in runs[0]}
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.stage1_frames(imgs)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    out["stage1_frames unmarked"] = [sum(walls) / reps, None]
    return out


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("stage1_split: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from dwt_tpu_torch.codec.encoder import get_encoder

    for label, (w, h, n) in (("4K frame", (3840, 2160, 1)),
                             ("7 1080p frames", (1920, 1080, 7))):
        imgs = frames(root, w, h, n)
        enc = get_encoder(w, h, 3)
        res = split(torch, enc, imgs, args.reps)
        print(json.dumps({"root": root, "shape": label, "card": card,
                          "ms_host_device": res}), flush=True)
        print(f"{label}: " + "; ".join(
            f"{k} {v[0]:.2f} ms" + (f" ({v[1]:.2f} device)"
                                    if v[1] is not None else "")
            for k, v in res.items()) + f" on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
