#!/usr/bin/env python3
"""Where the host time of kernels 14's, 15's and 17's wrappers goes, and
their device time, on one CUDA card.

    python3 tools/wrapper_split.py [--root DIR] [--reps N] [--emit-only]
                                   [--sweep]

``--root`` names the checkout whose ``dwt_tpu_torch`` is measured (default:
this one), so one command can split two trees in turns.  Four shapes: one
3840x2160 RGB frame and a sub-batch of seven 1920x1080 frames, as
``tools/stage1_split.py`` takes them; a sub-batch of 61 512x512 RGB tiles
(``encode_tiled``'s on a 15360x8640 frame) and one of 29,126 16x16 RGB
tiles of a 2736x2736 frame (the larger of its two sub-batches).  Stage 1
and the emit half run once with the wrappers' arguments kept; then each
wrapper (``ops/schedule.py:schedule``, ``ops/units.py:unit_tables``,
``ops/emit_tables.py:emit_tables``; ``--emit-only``: the last alone) is
called ``--reps`` times after a warm run, four ways:

* whole: the host clock around each call (the card runs behind; no
  synchronisation between calls);
* events: CUDA events around each call, synchronised after it (as
  ``chip_smoke.py``'s ``time_ms``);
* device: the wrapper's kernels' device time a call, by torch.profiler;
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
with kernel 17's byte bound (each input its function needs read once,
``off`` at a step's end and base; its outputs once; over 3.35 TB/s) and
the card's name and power limit.  ``--sweep`` (a tree with kernel 17's launch plan)
adds a line a shape of kernel 17's device and event times at other
plans, outputs held equal: its sort forced (an ``order`` that is no
permutation); for a frame of several blocks 1, 2 or 8 units a thread
(8 only at 4 keys a thread or fewer, as the kernel's instances allow);
for smaller frames a frame a block and the plan of a larger frame.
Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# The argument of each C entry point that counts the frames, by the
# entry point's argument count (kernel 17's took 19 pointers before its
# schedule order and level scans, 22 since).
NFRAMES_ARG = {("dwt_schedule", 19): 12, ("dwt_unit_tables", 19): 10,
               ("dwt_emit_tables", 31): 19, ("dwt_emit_tables", 35): 22}
PARTS = ("checks", "allocations", "ctypes call", "launch")
# Kernel 17's inputs that its function needs besides the (N, S) step
# tables: not kernel 14's schedule order and level scans, nor the
# pyramid's vcar, which stand in for a sort and a level scan.
EMIT_READS = ("chunks", "planes", "planes_max", "nS_ck", "nZ_ck", "elem",
              "elen", "p", "flat_step", "flat_ck", "valid", "ch_valid",
              "level_chunk_base", "level_nchunk")
# (label, (width, height, frames)).
SHAPES = (("4K frame", (3840, 2160, 1)), ("7 1080p frames", (1920, 1080, 7)),
          ("61 512x512 tiles", (512, 512, 61)),
          ("29,126 16x16 tiles", (16, 16, 29_126)))
HBM_BYTES_PER_S = 3.35e12


def stage1_split():
    """``tools/stage1_split.py``, whose frames this split shares."""
    spec = importlib.util.spec_from_file_location(
        "stage1_split", os.path.join(HERE, "stage1_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tile_frames(root: str, w: int, h: int, n: int):
    """The first ``n`` ``w`` x ``h`` tiles of one "mixed" RGB frame of
    171 tiles a side (``chip_smoke.py``'s small tiles at 16x16)."""
    import numpy as np

    side = 171
    img = stage1_split().frames(root, w * side, h * side, 1)[0]
    tiles = img.reshape(side, h, side, w, 3).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(tiles.reshape(-1, h, w, 3)[:n])


def kept_args(torch, enc, imgs) -> dict:
    """{wrapper: (module, its arguments)} of one stage 1 and one emit of
    ``imgs`` on ``enc``'s tree (the unit tables and the step tables are
    the emit half's)."""
    pkg = type(enc).__module__.rsplit(".", 2)[0]
    stage1 = importlib.import_module(f"{pkg}.codec.stage1")
    tokens = importlib.import_module(f"{pkg}.codec.tokens")
    emit = importlib.import_module(f"{pkg}.codec.emit")
    encoder = importlib.import_module(f"{pkg}.codec.encoder")
    kept = {}

    def keep(mod, name, wrapper):
        fn = getattr(mod, name)

        def run(*args):
            kept.setdefault(name, (wrapper, args))
            return fn(*args)
        return fn, run

    saved = [(stage1, "schedule"), (tokens, "unit_tables"),
             (emit, "emit_tables")]
    wrappers = [importlib.import_module(f"{pkg}.ops.{m}")
                for m in ("schedule", "units", "emit_tables")]
    fns = []
    for (mod, name), w in zip(saved, wrappers):
        fn, run = keep(mod, name, w)
        fns.append(fn)
        setattr(mod, name, run)
    try:
        lin, stats = enc.stage1_frames(imgs)
        enc.emit_frames(lin, stats, encoder._bucket(int(
            stats["T_host"].max())))
    finally:
        for (mod, name), fn in zip(saved, fns):
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    return kept


def emit_bound(fn, args) -> dict:
    """Kernel 17's bytes and byte bound on ``args`` (either tree's
    arguments, by name), as ``chip_smoke.py:emit_tables_work`` counts
    them: what the function needs read once (``off`` at a step's end and
    base, the five (N, S) step tables, ``EMIT_READS``), refstart, the
    32-byte meta rows and the head written once."""
    a = inspect.signature(fn).bind(*args).arguments
    N, S = a["nref_step"].shape
    U = a["elem"].shape[1]
    K = -(-a["chunks"].shape[1] // 512) + -(-S // 8)
    nin = 4 * 7 * N * S + sum(a[k].numel() * a[k].element_size()
                              for k in EMIT_READS)
    nout = 4 * N * S + 32 * N * U + 4 * (1 + N * (K + 64))
    return {"bytes": nin + nout,
            "bound_us": round((nin + nout) / HBM_BYTES_PER_S * 1e6, 4)}


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
            if name not in {k for k, _ in NFRAMES_ARG}:
                return fn

            def call(*args):
                zero = list(args)
                zero[NFRAMES_ARG[(name, len(args))]] = 0
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


def device_us(torch, fn, args, reps: int) -> tuple:
    """The device time a call of ``fn(*args)``'s kernels (torch.profiler;
    no copy or fill is the wrapper's), and their names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = sorted({e.name.split("(")[0].removeprefix("void ")
                    for e in ev})
    return sum(e.time_range.elapsed_us() for e in ev) / reps, names


def split(torch, mod, fn, args, reps: int) -> dict:
    """Microseconds: the means of whole, events, device and the split's
    parts, and the medians of whole and events."""
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
    out = {k: round(v * 1e6, 2) for k, v in out.items()}
    out["device"], out["kernels"] = device_us(torch, fn, args, reps)
    out["device"] = round(out["device"], 3)
    return out


def sweep(torch, mod, args, reps: int) -> dict:
    """Kernel 17 at the variants of ``--sweep``: {variant: [device us,
    events us]}, each call's outputs equal to the plan's."""
    fn = mod.emit_tables
    want = fn(*args)
    S, U = args[2].shape[1], args[14].shape[1]
    plan = mod.launch_plan(S, U)

    def larger(upt):
        """A larger frame's plan at ``upt`` units a thread."""
        blocks = -(-U // (mod.BLOCK * upt))
        return plan[0], mod.BLOCK, 1, 1 + blocks, -(-U // blocks)

    unsorted = list(args)
    unsorted[4] = torch.zeros_like(args[4])
    variants = {"plan": (plan, args), "sort forced": (plan, unsorted)}
    if plan[3] > 1:
        for upt in (1, 2, 8):
            if upt <= 4 or plan[0] <= 4 * plan[1]:
                variants[f"{upt} units a thread"] = (larger(upt), args)
    else:
        variants["a frame a block"] = (plan[:2] + (1,) + plan[3:], args)
        variants["as a larger frame"] = (larger(mod.UPT), args)
    real, out = mod.launch_plan, {}
    try:
        for name, (p, a) in variants.items():
            mod.launch_plan = lambda *_, p=p: p
            mod._layout.cache_clear()
            got = fn(*a)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"kernel 17 at {name} differs")
            ev = []
            for _ in range(reps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn(*a)
                e1.record()
                e1.synchronize()
                ev.append(e0.elapsed_time(e1) * 1e3)
            out[name] = [round(device_us(torch, fn, a, reps)[0], 3),
                         round(sum(ev) / reps, 2), list(p)]
    finally:
        mod.launch_plan = real
        mod._layout.cache_clear()
    return out


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--emit-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
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
    for label, (w, h, n) in SHAPES:
        enc = get_encoder(w, h, 3)
        imgs = (tile_frames(root, w, h, n) if w == 16
                else s1.frames(root, w, h, n))
        kept = kept_args(torch, enc, imgs)
        del imgs
        for name, (mod, fargs) in kept.items():
            if args.emit_only and name != "emit_tables":
                continue
            res = split(torch, mod, getattr(mod, name), fargs, args.reps)
            line = {"root": root, "shape": label, "wrapper": name,
                    "card": card, "us": res}
            if name == "emit_tables":
                line.update(emit_bound(getattr(mod, name), fargs))
            print(json.dumps(line), flush=True)
            if (args.sweep and name == "emit_tables"
                    and hasattr(mod, "launch_plan")):
                print(json.dumps({"root": root, "shape": label,
                                  "sweep": sweep(torch, mod, fargs,
                                                 args.reps),
                                  "card": card}), flush=True)
        del kept
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
