#!/usr/bin/env python3
"""Where the host time of kernels 14's and 15's wrappers goes, on one CUDA
card.

    python3 tools/wrapper_split.py [--root DIR] [--reps N]

``--root`` names the checkout whose ``dwt_tpu_torch`` is measured (default:
this one), so one command can split two trees in turns.  Two shapes, as
``tools/stage1_split.py`` takes them: one 3840x2160 RGB frame and a
sub-batch of seven 1920x1080 frames.  Stage 1 and the unit tables run once
with the wrappers' arguments kept; then each wrapper
(``ops/schedule.py:schedule``, ``ops/units.py:unit_tables``) is called
``--reps`` times after a warm run, three ways:

* whole: the host clock around each call (the card runs behind; no
  synchronisation between calls);
* events: CUDA events around each call, synchronised after it (as
  ``chip_smoke.py``'s ``time_ms``);
* split: the call with its parts timed by the host clock around each:
  the checks (the module's ``_check``), the allocations (every
  ``torch.empty`` the wrapper makes, or its ``carve``: the one allocation
  and the views of its outputs), the ctypes call (the C entry point
  called once more with zero frames, which returns before it launches
  anything: the arguments' conversion and the call) and the launch (the
  entry point's real call less that); "rest" is the split call less those
  parts (the argument plumbing, the pointer array, the returned tuple).
  The timers' own cost inflates "rest"; "whole" is the uninstrumented
  figure.

Prints the means in microseconds (and the medians of whole and events,
which the host's noise moves less) as one JSON line a shape and wrapper,
with the card's name and power limit.  Needs a card; exits 1 without one.
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
# The argument of each C entry point that counts the frames.
NFRAMES_ARG = {"dwt_schedule": 12, "dwt_unit_tables": 10}
PARTS = ("checks", "allocations", "ctypes call", "launch")


def stage1_split():
    """``tools/stage1_split.py``, whose frames this split shares."""
    spec = importlib.util.spec_from_file_location(
        "stage1_split", os.path.join(HERE, "stage1_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kept_args(torch, enc, imgs) -> dict:
    """{wrapper: (module, its arguments)} of one stage 1 and one call of
    the unit tables on ``enc``'s tree."""
    pkg = type(enc).__module__.rsplit(".", 2)[0]
    stage1 = importlib.import_module(f"{pkg}.codec.stage1")
    tokens = importlib.import_module(f"{pkg}.codec.tokens")
    encoder = importlib.import_module(f"{pkg}.codec.encoder")
    kept = {}

    def keep(mod, name, wrapper):
        fn = getattr(mod, name)

        def run(*args):
            kept[name] = (wrapper, args)
            return fn(*args)
        return fn, run

    saved = [(stage1, "schedule"), (tokens, "unit_tables")]
    wrappers = [importlib.import_module(f"{pkg}.ops.schedule"),
                importlib.import_module(f"{pkg}.ops.units")]
    fns = []
    for (mod, name), w in zip(saved, wrappers):
        fn, run = keep(mod, name, w)
        fns.append(fn)
        setattr(mod, name, run)
    try:
        lin, stats = enc.stage1_frames(imgs)
        padded_T = encoder._bucket(int(stats["T_host"].max()))
        tokens._unit_tables(stats, stage1.segs_for(enc.pyr, lin.device),
                            padded_T)
    finally:
        for (mod, name), fn in zip(saved, fns):
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    return kept


class _Parts:
    """Host seconds by part, summed over the calls of one run."""

    def __init__(self):
        self.s = dict.fromkeys(PARTS, 0.0)

    def timed(self, part, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            self.s[part] += time.perf_counter() - t
            return out
        return run


def instrument(mod, parts: _Parts):
    """Wraps ``mod``'s ``_check``, ``torch.empty``, ``carve`` (where it
    has one) and its library's entry points with ``parts``' timers;
    returns the undo."""
    import torch

    build = mod.build
    saved = {"_check": mod._check, "torch": mod.torch, "build": build}
    if hasattr(mod, "carve"):
        saved["carve"] = mod.carve
        mod.carve = parts.timed("allocations", saved["carve"])

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

    tp = Torch()
    tp.empty = parts.timed("allocations", torch.empty)

    class Lib:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            fn = getattr(self.lib, name)
            if name not in NFRAMES_ARG:
                return fn

            def call(*args):
                zero = list(args)
                zero[NFRAMES_ARG[name]] = 0
                t0 = time.perf_counter()
                fn(*zero)
                t1 = time.perf_counter()
                out = fn(*args)
                t2 = time.perf_counter()
                parts.s["ctypes call"] += t1 - t0
                parts.s["launch"] += (t2 - t1) - (t1 - t0)
                return out
            return call

    class Build:
        def __getattr__(self, name):
            return getattr(build, name)

        def library(self):
            return Lib(build.library())

    mod._check = parts.timed("checks", saved["_check"])
    mod.torch = tp
    mod.build = Build()

    def undo():
        for k, v in saved.items():
            setattr(mod, k, v)
    return undo


def split(torch, mod, fn, args, reps: int) -> dict:
    """Microseconds: the means of whole, events and the split's parts,
    and the medians of whole and events."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    whole = []
    for _ in range(reps):
        t = time.perf_counter()
        fn(*args)
        whole.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        events.append(a.elapsed_time(b) * 1e-3)
    parts = _Parts()
    undo = instrument(mod, parts)
    try:
        fn(*args)
        torch.cuda.synchronize()
        parts.s = dict.fromkeys(PARTS, 0.0)
        t = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        inst = time.perf_counter() - t
    finally:
        undo()
    torch.cuda.synchronize()
    out = {"whole": sum(whole) / reps, "events": sum(events) / reps,
           **{k: v / reps for k, v in parts.s.items()}}
    # the instrumented call less its parts and the zero-frame call
    out["rest"] = (inst - sum(parts.s.values()) - parts.s["ctypes call"]) \
        / reps
    out["whole, median"] = sorted(whole)[reps // 2]
    out["events, median"] = sorted(events)[reps // 2]
    return {k: round(v * 1e6, 2) for k, v in out.items()}


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("wrapper_split: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from dwt_tpu_torch.codec.encoder import get_encoder

    s1 = stage1_split()
    for label, (w, h, n) in (("4K frame", (3840, 2160, 1)),
                             ("7 1080p frames", (1920, 1080, 7))):
        enc = get_encoder(w, h, 3)
        kept = kept_args(torch, enc, s1.frames(root, w, h, n))
        for name, (mod, fargs) in kept.items():
            res = split(torch, mod, getattr(mod, name), fargs, args.reps)
            print(json.dumps({"root": root, "shape": label, "wrapper": name,
                              "card": card, "us": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
