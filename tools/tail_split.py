#!/usr/bin/env python3
"""Where the port's decode tail (``codec/decoder.py:_Tail.batch``) spends
its time, pass by pass, on one CUDA card.

    python3 tools/tail_split.py [--root DIR] [--reps N]

``--root`` names the checkout whose ``dwt_tpu_torch`` is measured (default:
this one).  The tails of the three decode cells, on inputs parsed from
streams of a 3840x2160 RGB frame (``tests/imagegen.py``'s "mixed" image,
seed 0) that the tree encodes:

* 4K: the lossless stream decoded whole (``uhd4k-decode``; no plane is
  missing, so no bias runs);
* preview: its 65,536-byte prefix at ``pixels_max=518400``, a 480x270
  image (``uhd4k-preview``'s request);
* 16K tile group: 480 512x512 tiles of one tail call, as ``decode_tiled``
  hands ``uhd16k-tiled``'s to ``decode_batch``: the frame's 28 512x512
  tiles (``encode_tiled``'s), each payload cut to a third of its bytes,
  repeated to 480 (the tiles that decode to every level).

Each pass is timed by the host clock between synchronised marks and by
CUDA events:

* scatter: ``hilbert_scatter`` (kernel 5);
* inverse transform: ``inverse_transform`` (kernel 16), where the tree
  has it; in a tree before it, the inverse lifting (``dwt2d_inv``) and
  then the colour, clamp and cast (the rest of ``_Tail.batch``);
* views: ``_Tail._views`` less the scatter inside it (the views of the
  scatter's output and of the root band), and bias table:
  ``_Tail.bias_table`` (the table made in pinned memory and its upload,
  where planes are missing), where the tree has them;
* rest: what else ``_Tail.batch`` spends (its own Python and the marks'
  own cost);
* in a tree whose tail still biases and permutes eagerly (before kernel
  16 read the scatter's output in place): bias, ``_Tail._bias``, the
  midpoint bias, where planes are missing, and root crop and permute, the
  rest of ``_Tail.pyramid``; hooks a tree lacks are skipped.

``split`` measures the tree that ``decoder`` (a ``codec.decoder`` module)
comes from on inputs that ``inputs`` made, so ``chip_smoke.py --parent``
splits two trees in turns on the same inputs.  The marks synchronise the
card, so the passes add up to more than an unmarked tail; the unmarked
``_Tail.batch`` is timed beside them.  The means of ``--reps`` runs after
one warm run are printed as one JSON line a shape, with the card's name
and power limit.  Needs a card; exits 1 without one.
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

PREVIEW_BYTES = 65_536  # uhd4k-preview's prefix
PREVIEW_PIXELS = 518_400  # its pixels_max: 480x270 of a 4K frame
TILE = (512, 512)
GROUP_TILES = 480  # uhd16k-tiled's 512x512 tiles, one tail call


def frame(root: str, w: int, h: int):
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "imagegen", os.path.join(root, "tests", "imagegen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.random_image(np.random.default_rng(0), w, h, 3, "mixed")


def inputs(torch, decoder, encoder, tiled, img) -> list:
    """[(label, (W, H, levels, C, gray), coeffs on the card, missing)]: the
    three tails' inputs, parsed from streams of ``img`` that ``encoder``
    and ``tiled`` (a tree's ``codec`` modules) make, by ``decoder``'s
    parsers."""
    import numpy as np

    dev = torch.device("cuda")
    H, W, C = img.shape
    stream = encoder.get_encoder(W, H, C).encode(img)
    out = []
    for label, s, px in (("4K", stream, 0),
                         ("preview", stream[:PREVIEW_BYTES],
                          PREVIEW_PIXELS)):
        w, h, gray, coeffs, missing, levels = decoder._parse(s, px, dev)
        out.append((label, (w, h, levels, C, gray), coeffs.to(dev)[None],
                    missing[None]))
    th, tw = TILE
    tiles = np.stack([t for _, t in tiled.group_tiles(img, TILE)[0][TILE]])
    pls, _ = tiled.get_batch_encoder(tw, th, C).encode_raw(tiles)
    pls = [p[:len(p) // 3] for p in pls]
    pls = (pls * -(-GROUP_TILES // len(pls)))[:GROUP_TILES]
    pyr = decoder.compute_pyramid(tw, th)
    buf = torch.zeros((len(pls), C, pyr.total), dtype=torch.int32,
                      pin_memory=True)
    _, missing, level, _, rc = decoder.native.entropy_decode_batch(
        pls, C, pyr.levels, pyr.levels, pyr.pixels, 0, buf.numpy())
    keep = np.nonzero((level == level.max()) & (rc == 0))[0]
    coeffs = buf.to(dev)[torch.as_tensor(keep, device=dev)]
    out.append((f"16K tile group ({keep.size} of {GROUP_TILES} tiles)",
                (tw, th, int(level.max()) + 1, C, False), coeffs,
                missing[keep]))
    return out


def split_once(torch, decoder, tail, coeffs, missing) -> dict:
    """One ``tail.batch`` with its passes marked: {pass: (host ms, device
    ms)}, and "tail" for the marked whole."""
    marks: dict = {}

    def mark(name):
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.setdefault(name, []).append((time.perf_counter(), ev))

    def timed(name, fn):
        def run(*args, **kwargs):
            mark(name + "+")
            out = fn(*args, **kwargs)
            mark(name + "-")
            return out
        return run

    names = [n for n in ("hilbert_scatter", "inverse_transform", "dwt2d_inv")
             if hasattr(decoder, n)]
    saved = {n: getattr(decoder, n) for n in names}
    for n in names:
        setattr(decoder, n, timed(n, saved[n]))
    # On the instance, over the class's; a tree without them skips them.
    own = [n for n in ("_bias", "pyramid", "_views", "bias_table")
           if hasattr(tail, n)]
    for n in own:
        setattr(tail, n, timed(n, getattr(tail, n)))
    try:
        mark("tail+")
        tail.batch(coeffs, missing)
        mark("tail-")
    finally:
        for n in names:
            setattr(decoder, n, saved[n])
        for n in own:
            delattr(tail, n)
    torch.cuda.synchronize()

    def total(name):
        parts = [(1e3 * (b[0] - a[0]), a[1].elapsed_time(b[1]))
                 for a, b in zip(marks.get(name + "+", []),
                                 marks.get(name + "-", []))]
        return tuple(sum(p[i] for p in parts) for i in range(2))

    def minus(a, *bs):
        return tuple(a[i] - sum(b[i] for b in bs) for i in range(2))

    bias, scatter, pyramid = total("_bias"), total("hilbert_scatter"), \
        total("pyramid")
    whole = total("tail")
    out = {"scatter": scatter}
    if "_bias" in own:
        out = {"bias": bias, "scatter": scatter,
               "root crop and permute": minus(pyramid, bias, scatter)}
    elif "_views" in own:
        out["views"] = minus(total("_views"), scatter)
        out["bias table"] = total("bias_table")
    if "inverse_transform" in names:
        out["inverse transform"] = total("inverse_transform")
        out["rest"] = minus(whole, *out.values())
    else:
        lift = total("dwt2d_inv")
        out["inverse lifting"] = lift
        out["colour, clamp and cast"] = minus(whole, pyramid, lift)
    out["tail"] = whole
    return out


def split(torch, decoder, inp, reps: int) -> dict:
    """Means over ``reps`` marked runs after a warm one, and the unmarked
    ``_Tail.batch`` (host clock, synchronised after) beside them."""
    _, (w, h, levels, C, gray), coeffs, missing = inp
    tail = decoder._tail(w, h, levels, C, gray, coeffs.device)
    split_once(torch, decoder, tail, coeffs, missing)
    runs = [split_once(torch, decoder, tail, coeffs, missing)
            for _ in range(reps)]
    out = {k: [sum(r[k][i] for r in runs) / reps for i in range(2)]
           for k in runs[0]}
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tail.batch(coeffs, missing)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    out["tail unmarked"] = [sum(walls) / reps, None]
    return out


def line(res: dict) -> str:
    return "; ".join(f"{k} {h:.3f} ms" + ("" if d is None
                                          else f" ({d:.3f} events)")
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
        print("tail_split: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    mods = [importlib.import_module(f"dwt_tpu_torch.codec.{m}")
            for m in ("decoder", "encoder", "tiled")]
    for inp in inputs(torch, *mods, frame(root, 3840, 2160)):
        res = split(torch, mods[0], inp, args.reps)
        print(json.dumps({"root": root, "shape": inp[0], "card": card,
                          "ms_host_device": res}), flush=True)
        print(f"{inp[0]}: {line(res)} on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
