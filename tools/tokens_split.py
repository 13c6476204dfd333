#!/usr/bin/env python3
"""Where the port's encoder tokens half spends its time, pass by pass, on
one CUDA card.

    python3 tools/tokens_split.py [--root DIR] [--reps N]

``--root`` names the checkout whose ``dwt_tpu_torch`` is measured (default:
this one), so one command can split two trees in turns.  Two shapes: one
3840x2160 RGB frame (``tests/imagegen.py``'s "mixed" image, seed 0) and a
sub-batch of seven 1920x1080 frames (seeds 0-6), as the batch mode sends
them.  Stage 1 runs once, outside the split; then
``tokens._stage2_tokens`` runs with these passes marked, each by the host
clock between synchronised marks and by CUDA events:

* unit tables: ``tokens.unit_tables``, kernel 15 (each unit's step,
  chunk and plane, kernel A's meta rows and unit table), in a tree that
  has it; in one before it:
* unit indexing: ``tokens._unit_common`` (each unit's step, chunk and
  plane);
* kernel A's meta, table and histograms: ``tokens._kernel_a_meta``,
  ``tokens._kernel_a_table`` and ``compact.hist_for`` (with kernel 15,
  ``compact.hist_for`` alone);
* packed elements: ``tokens._packed_elems``;
* kernel A: ``tokens.compact_tokens`` (its zeroed pair buffer and its
  count and place launches);
* finisher: ``tokens._finish_tokens``;
* VLI scan: ``tokens._vli_orders``;
* rest: the tokens half less the passes above (the glue between them).

The split wraps these names only, those the tree has, so it measures
any tree that keeps some of them.  The marks synchronise the card, so
the passes add up to more than an unmarked tokens half, which is timed
beside them ("tokens half unmarked": the call alone between two
synchronised marks).  A pass's event time is the card's clock between
its marks, idle gaps included, not its busy time.  The means of ``--reps`` runs after one warm run are
printed as one JSON line a shape, with the card's name and power limit.
Needs a card; exits 1 without one.
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

HERE = os.path.dirname(os.path.abspath(__file__))
META = "kernel A's meta, table and histograms"
# (module, name) of each marked call -> its pass.
PASSES = {("tokens", "unit_tables"): "unit tables",
          ("tokens", "_unit_common"): "unit indexing",
          ("tokens", "_kernel_a_meta"): META,
          ("tokens", "_kernel_a_table"): META,
          ("compact", "hist_for"): META,
          ("tokens", "_packed_elems"): "packed elements",
          ("tokens", "compact_tokens"): "kernel A",
          ("tokens", "_finish_tokens"): "finisher",
          ("tokens", "_vli_orders"): "VLI scan"}


def emit_split():
    """``tools/emit_split.py``, whose frames and stage 1 this split shares."""
    spec = importlib.util.spec_from_file_location(
        "emit_split", os.path.join(HERE, "emit_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def modules(enc) -> dict:
    """The ``tokens`` and ``compact`` modules of the tree ``enc`` comes
    from."""
    pkg = type(enc).__module__.rsplit(".", 2)[0]
    return {"tokens": importlib.import_module(f"{pkg}.codec.tokens"),
            "compact": importlib.import_module(f"{pkg}.ops.compact")}


def split_once(torch, enc, lin, stats, padded_T: int,
               passes: dict = PASSES) -> dict:
    """One ``_stage2_tokens`` with ``passes`` marked: {pass: (host ms,
    device ms)}, a pass's calls summed, with "rest" and "tokens half"."""
    mods = modules(enc)
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

    passes = {k: v for k, v in passes.items() if hasattr(mods[k[0]], k[1])}
    saved = {k: getattr(mods[k[0]], k[1]) for k in passes}
    for k, name in passes.items():
        setattr(mods[k[0]], k[1], timed(name, saved[k]))
    try:
        mark("start")
        mods["tokens"]._stage2_tokens(lin, stats, enc.pyr, enc.channels,
                                      padded_T)
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
            h, d = ms(a, b)
            ph, pd = out.get(a[0][:-1], (0.0, 0.0))
            out[a[0][:-1]] = (ph + h, pd + d)
    whole = ms(marks[0], marks[-1])
    out["rest"] = tuple(w - sum(p[i] for p in out.values())
                        for i, w in enumerate(whole))
    out["tokens half"] = whole
    return out


def split(torch, enc, lin, stats, padded_T: int, reps: int) -> dict:
    """Means over ``reps`` marked runs after a warm one, and the tokens
    half of ``reps`` unmarked runs beside them ("tokens half unmarked")."""
    split_once(torch, enc, lin, stats, padded_T)
    runs = [split_once(torch, enc, lin, stats, padded_T)
            for _ in range(reps)]
    out = {k: [sum(r[k][i] for r in runs) / reps for i in range(2)]
           for k in runs[0]}
    bare = [split_once(torch, enc, lin, stats, padded_T, passes={})
            for _ in range(reps)]
    out["tokens half unmarked"] = [
        sum(r["tokens half"][i] for r in bare) / reps for i in range(2)]
    return out


def line(res: dict) -> str:
    return "; ".join(f"{k} {h:.2f} ms ({d:.2f} events)"
                     for k, (h, d) in res.items())


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("tokens_split: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from dwt_tpu_torch.codec.encoder import get_encoder

    es = emit_split()
    for label, (w, h, n) in (("4K frame", (3840, 2160, 1)),
                             ("7 1080p frames", (1920, 1080, 7))):
        enc = get_encoder(w, h, 3)
        res = split(torch, enc, *es.stage1(torch, enc,
                                           es.frames(root, w, h, n)),
                    args.reps)
        print(json.dumps({"root": root, "shape": label, "card": card,
                          "ms_host_device": res}), flush=True)
        print(f"{label}: {line(res)} on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
