#!/usr/bin/env python3
"""Where kernel 17 (``csrc/emit_tables.cu``) spends its time inside one
launch, phase by phase, on one CUDA card.

    python3 tools/emit_stamps.py [--reps N]

Builds ``csrc/emit_tables.cu`` alone with ``-DDWT_STAMPS`` into
``build/dwt_tpu_torch/stamps/`` (thread 0 of each group of threads, a
frame's, then writes the card's global timer at the end of each phase),
keeps kernel 17's arguments of ``tools/wrapper_split.py``'s four shapes
(one 3840x2160 RGB frame, seven 1920x1080 frames, 61 512x512 tiles,
29,126 16x16 tiles), and calls the stamped kernel in place of the
library's ``--reps`` times after three warm calls, each call's outputs
held equal to the library kernel's.  Prints one JSON line a shape, with
the card's name and power limit: the launch's span (the last group's end
less the first group's start), each group's life (its end less its
start; median and 90th percentile over groups, means over calls), the
median over groups of each phase's length, the first block's groups
apart (they alone write a larger frame's step tables), and the spread of
the groups' starts.  Needs a card and ``nvcc``; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# The stamps, in the order the kernel writes them.
PHASES = ("start", "init", "loads and keys", "token parts and layers",
          "order check", "refinement parts and sort", "scan and first bits",
          "layer ends", "meta rows")
SLOTS, NSTAMP = 1 << 15, 10  # csrc/emit_tables.cu g_stamps (9 written)


def wrapper_split():
    spec = importlib.util.spec_from_file_location(
        "wrapper_split", os.path.join(HERE, "wrapper_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stamped_library(build):
    """The kernel's source built alone with ``-DDWT_STAMPS``: its
    ``dwt_emit_tables`` and ``dwt_emit_stamps``."""
    src = build.CSRC / "emit_tables.cu"
    out = build.BUILD_ROOT / "stamps" / "libemit_stamps.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DDWT_STAMPS",
                    "-shared", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.dwt_emit_tables.argtypes = list(
        build.ENTRY_POINTS["dwt_emit_tables"])
    lib.dwt_emit_tables.restype = ctypes.c_int
    lib.dwt_emit_stamps.argtypes = [ctypes.c_void_p]
    lib.dwt_emit_stamps.restype = ctypes.c_int
    return lib


def summary(np, calls: list, N: int, plan: tuple) -> dict:
    """The stamps of ``calls`` ((SLOTS, NSTAMP) arrays, ns) of a launch of
    N frames at ``plan``: microseconds."""
    fpb, bpf = plan[2], plan[3]
    slot = np.arange(SLOTS)
    blk, g = slot // 8, slot % 8
    mine = ((g < fpb) & (blk // bpf * fpb + g < N)
            & (blk < -(-N // fpb) * bpf))
    first = mine & (blk % bpf == 0)
    spans, life, p90, phases, firsts, spread = [], [], [], [], [], []
    for st in calls:
        t = st[mine, :len(PHASES)].astype(np.int64)
        spans.append(t[:, -1].max() - t[:, 0].min())
        life.append(np.median(t[:, -1] - t[:, 0]))
        p90.append(np.percentile(t[:, -1] - t[:, 0], 90))
        phases.append(np.median(np.diff(t, axis=1), axis=0))
        firsts.append(np.median(np.diff(
            st[first, :len(PHASES)].astype(np.int64), axis=1), axis=0))
        spread.append(t[:, 0].max() - t[:, 0].min())

    def us(x):
        return round(float(np.mean(x)) / 1e3, 3)

    def by_phase(x):
        return dict(zip(PHASES[1:], (round(float(v) / 1e3, 3)
                                     for v in np.mean(x, axis=0))))

    out = {"groups": int(mine.sum()), "span_us": us(spans),
           "group_life_us": us(life), "group_life_p90_us": us(p90),
           "starts_spread_us": us(spread), "phase_us": by_phase(phases)}
    if bpf > 1:
        out["first_block_phase_us"] = by_phase(firsts)
    return out


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("emit_stamps: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from dwt_tpu_torch.codec.encoder import get_encoder
    from dwt_tpu_torch.runtime import build

    lib = stamped_library(build)
    ws = wrapper_split()
    s1 = ws.stage1_split()
    for label, (w, h, n) in ws.SHAPES:
        enc = get_encoder(w, h, 3)
        imgs = (ws.tile_frames(ROOT, w, h, n) if w == 16
                else s1.frames(ROOT, w, h, n))
        mod, fargs = ws.kept_args(torch, enc, imgs)["emit_tables"]
        del imgs
        want = mod.emit_tables(*fargs)
        N, S = fargs[2].shape
        plan = mod.launch_plan(S, fargs[14].shape[1])
        blocks = -(-N // plan[2]) * plan[3]
        stamps = np.zeros((SLOTS, NSTAMP), np.uint64)
        calls = []
        saved = mod.build.library
        mod.build.library = lambda: lib
        try:
            for r in range(3 + args.reps):
                got = mod.emit_tables(*fargs)
                torch.cuda.synchronize()
                build.check(lib.dwt_emit_stamps(stamps.ctypes.data),
                            "emit_stamps")
                if not all(torch.equal(g, x) for g, x in zip(got, want)):
                    raise AssertionError("the stamped kernel differs")
                if r >= 3:
                    calls.append(stamps.copy())
        finally:
            mod.build.library = saved
        print(json.dumps({"shape": label, "card": card, "plan": list(plan),
                          "blocks": blocks,
                          **summary(np, calls, N, plan)}),
              flush=True)
        del fargs, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
