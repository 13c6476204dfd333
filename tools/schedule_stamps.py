#!/usr/bin/env python3
"""Where kernel 14 (``csrc/schedule.cu``) spends its time inside one launch,
phase by phase, on one CUDA card.

    python3 tools/schedule_stamps.py [--reps N]

Builds ``csrc/schedule.cu`` alone with ``-DDWT_STAMPS`` into
``build/dwt_tpu_torch/stamps/`` (thread 0 of each block of frame 0's
cluster then writes the card's global timer at the end of each phase),
runs stage 1 of one 3840x2160 RGB frame and of a 7-frame 1080p sub-batch
(``tools/stage1_split.py``'s frames) with the stamped kernel in place of
the library's, and prints for each block of the cluster the median over
``--reps`` calls (after five warm ones) of each stamp in nanoseconds after
the cluster's first stamp, one JSON line a shape, with the card's name and
power limit.  Every call's leaves are held equal to the library kernel's.
Needs a card and ``nvcc``; exits 1 without a card.
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
# The stamps, in the order the kernel writes them (block 0 alone past 6).
PHASES = ("start", "planning", "sort", "first walk", "cluster wait",
          "fold and push", "second walk", "peers landed", "chain scan",
          "bases scan", "end")
SLOTS = 16  # stamps a block (csrc/schedule.cu g_stamps)


def wrapper_split():
    spec = importlib.util.spec_from_file_location(
        "wrapper_split", os.path.join(HERE, "wrapper_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stamped_library(build):
    """The kernel's source built alone with ``-DDWT_STAMPS``: its
    ``dwt_schedule`` and ``dwt_schedule_stamps``."""
    src = build.CSRC / "schedule.cu"
    out = build.BUILD_ROOT / "stamps" / "libschedule_stamps.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DDWT_STAMPS",
                    "-shared", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.dwt_schedule.argtypes = list(build.ENTRY_POINTS["dwt_schedule"])
    lib.dwt_schedule.restype = ctypes.c_int
    lib.dwt_schedule_stamps.argtypes = [ctypes.c_void_p]
    lib.dwt_schedule_stamps.restype = ctypes.c_int
    return lib


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("schedule_stamps: no CUDA device; nothing was run",
              file=sys.stderr)
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
    for label, (w, h, n) in (("4K frame", (3840, 2160, 1)),
                             ("7 1080p frames", (1920, 1080, 7))):
        enc = get_encoder(w, h, 3)
        mod, fargs = ws.kept_args(torch, enc, s1.frames(ROOT, w, h, n))[
            "schedule"]
        want = mod.schedule(*fargs)
        K = min(8, fargs[0].shape[1] * fargs[6].numel())
        stamps = np.zeros((8, SLOTS), np.uint64)
        runs = []
        saved = mod.build.library
        mod.build.library = lambda: lib
        try:
            for r in range(5 + args.reps):
                stamps[:] = 0
                got = mod.schedule(*fargs)
                torch.cuda.synchronize()
                build.check(lib.dwt_schedule_stamps(stamps.ctypes.data),
                            "schedule_stamps")
                if not all(torch.equal(g, x) for g, x in zip(got, want)):
                    raise AssertionError("the stamped kernel differs")
                t = stamps[:K, :len(PHASES)].astype(np.int64)
                t0 = t[t > 0].min()
                if r >= 5:
                    runs.append(np.where(t > 0, t - t0, -1))
        finally:
            mod.build.library = saved
        med = np.median(np.stack(runs), axis=0).astype(np.int64)
        print(json.dumps({"shape": label, "card": card, "cluster": K,
                          "phases": PHASES,
                          "ns_by_block": med.tolist()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
