#!/usr/bin/env python3
"""Where the port's encoder emit half spends its time, pass by pass, on
one CUDA card.

    python3 tools/emit_split.py [--root DIR] [--reps N]

``--root`` names the checkout whose ``dwt_tpu_torch`` is measured (default:
this one), so one command can split two trees in turns.  Two shapes: one
3840x2160 RGB frame (``tests/imagegen.py``'s "mixed" image, seed 0) and a
sub-batch of seven 1920x1080 frames (seeds 0-6), as the batch mode sends
them.  Stage 1 runs once, outside the split; then ``Encoder.emit_frames``
runs with these passes marked, each by the host clock between
synchronised marks and by CUDA events:

* pieces: ``emit._codeword_contribs`` (the codeword lengths, offsets,
  word indices and pieces; in a tree before kernel 17, also each step's
  first refinement bit);
* step tables: ``emit.emit_tables`` (kernel 17: each step's first
  refinement bit, the bit partials, kernel B's meta and the layer ends);
* zero fill and pack: ``emit.pack_words`` (the zeroed word buffer and the
  pack kernel);
* bit partials: ``emit._bit_partials`` (a tree before kernel 17);
* kernel B's meta: ``emit._kernel_b_meta`` (likewise);
* kernel B: ``emit.scatter_refbits``;
* layer boundaries: ``emit._layer_boundaries`` (likewise);
* host totals: ``encoder._host_totals`` (its one device-to-host copy);
* download: from the end of ``_host_totals`` to the end of
  ``emit_frames``, the stream bytes to the host;
* rest: the emit half less the passes above (the glue between them).

The tokens half (``encoder._stage2_tokens``), which ``emit_frames`` runs
first, is marked and left out.  The split wraps these names only, those
a tree has, so it measures any tree that keeps them.  The marks
synchronise the card, so the passes add up to more than an unmarked emit
half, which is timed beside them: ``emit_frames`` with only the tokens
half marked, from its end to the call's end.  A pass's event time is the
card's clock between its marks, idle gaps included, not its busy time.  The means of
``--reps`` runs after one warm run are printed as one JSON line a shape,
with the card's name and power limit.  Needs a card; exits 1 without
one.
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

# (module, name) of each marked call -> its pass.
PASSES = {("emit", "_codeword_contribs"): "pieces",
          ("emit", "emit_tables"): "step tables",
          ("emit", "pack_words"): "zero fill and pack",
          ("emit", "_bit_partials"): "bit partials",
          ("emit", "_kernel_b_meta"): "kernel B's meta",
          ("emit", "scatter_refbits"): "kernel B",
          ("emit", "_layer_boundaries"): "layer boundaries",
          ("encoder", "_host_totals"): "host totals"}


def frames(root: str, w: int, h: int, n: int):
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "imagegen", os.path.join(root, "tests", "imagegen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return np.stack([mod.random_image(np.random.default_rng(s), w, h, 3,
                                      "mixed") for s in range(n)])


def codec_modules(enc) -> dict:
    """The ``encoder`` and ``emit`` modules of the tree ``enc`` comes
    from."""
    pkg = type(enc).__module__.rsplit(".", 1)[0]
    return {name: importlib.import_module(f"{pkg}.{name}")
            for name in ("encoder", "emit")}


def split_once(torch, enc, lin, stats, padded_T: int,
               passes: dict = PASSES) -> dict:
    """One ``enc.emit_frames`` with ``passes`` and the tokens half marked:
    {pass: (host ms, device ms)}, with "emit half" (the tokens' end to the
    call's end), "download" and "rest"."""
    mods = codec_modules(enc)
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, time.perf_counter(), ev))

    def timed(name, fn):
        def run(*args, **kwargs):
            mark(name + "+")
            out = fn(*args, **kwargs)
            mark(name + "-")
            return out
        return run

    sites = {k: v for k, v in {**passes, ("encoder", "_stage2_tokens"):
                               "tokens"}.items()
             if hasattr(mods[k[0]], k[1])}
    saved = {k: getattr(mods[k[0]], k[1]) for k in sites}
    for k, name in sites.items():
        setattr(mods[k[0]], k[1], timed(name, saved[k]))
    try:
        enc.emit_frames(lin, stats, padded_T)
        mark("end")
    finally:
        for k, fn in saved.items():
            setattr(mods[k[0]], k[1], fn)
    torch.cuda.synchronize()

    def ms(a, b):
        return 1e3 * (b[1] - a[1]), a[2].elapsed_time(b[2])

    out: dict = {}
    for a, b in zip(marks, marks[1:]):
        if a[0].endswith("+") and b[0] == a[0][:-1] + "-":
            out[a[0][:-1]] = ms(a, b)
    at = {m[0]: m for m in marks}
    whole = ms(at["tokens-"], at["end"])
    del out["tokens"]
    if "host totals-" in at:
        out["download"] = ms(at["host totals-"], at["end"])
    out["rest"] = tuple(w - sum(p[i] for p in out.values())
                        for i, w in enumerate(whole))
    out["emit half"] = whole
    return out


def split(torch, enc, lin, stats, padded_T: int, reps: int) -> dict:
    """Means over ``reps`` marked runs after a warm one, and the emit half
    of ``reps`` runs with only the tokens half marked beside them ("emit
    half unmarked")."""
    split_once(torch, enc, lin, stats, padded_T)
    runs = [split_once(torch, enc, lin, stats, padded_T)
            for _ in range(reps)]
    out = {k: [sum(r[k][i] for r in runs) / reps for i in range(2)]
           for k in runs[0]}
    bare = [split_once(torch, enc, lin, stats, padded_T, passes={})
            for _ in range(reps)]
    out["emit half unmarked"] = [sum(r["emit half"][i] for r in bare) / reps
                                 for i in range(2)]
    return out


def stage1(torch, enc, imgs) -> tuple:
    """Stage 1 of ``imgs`` on ``enc``: (lin, stats, padded_T)."""
    mods = codec_modules(enc)
    lin, stats = enc.stage1_frames(imgs)
    padded_T = mods["encoder"]._bucket(int(stats["T"].max()))
    torch.cuda.synchronize()
    return lin, stats, padded_T


def line(res: dict) -> str:
    return "; ".join(f"{k} {h:.2f} ms ({d:.2f} events)"
                     for k, (h, d) in res.items())


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
        print("emit_split: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from dwt_tpu_torch.codec.encoder import get_encoder

    for label, (w, h, n) in (("4K frame", (3840, 2160, 1)),
                             ("7 1080p frames", (1920, 1080, 7))):
        enc = get_encoder(w, h, 3)
        res = split(torch, enc, *stage1(torch, enc, frames(root, w, h, n)),
                    args.reps)
        print(json.dumps({"root": root, "shape": label, "card": card,
                          "ms_host_device": res}), flush=True)
        print(f"{label}: {line(res)} on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
