#!/usr/bin/env python3
"""Kernels 18 and 19, the halo levels, on one CUDA card, launch by launch.

    python3 tools/halo_kernels.py [--reps N]

In a process of its own (a long process's profiler sessions lose the
device records of some launches), on the 3840x2160 RGB frame of
``tests/imagegen.py`` ("mixed", seed 0), at world size 1 on an NCCL
process group of one rank (as ``chip_smoke.py`` phase 7 runs the sharded
routes):

* ``halo_dwt2d_fwd`` of the frame's uint8 rows with the colour
  (``parallel/tiled.py``; kernel 18, one launch a halo level);
* ``halo_dwt2d_inv`` of its fine block to uint8 pixels (kernel 19).

For each: every launch of the kernel in one call, in launch order, with
its level's (stride, columns, rows) and device time (torch.profiler,
means of ``--reps`` calls after a warm one, ``chip_smoke.py``'s
``launch_ms``), their sum; the kernel's launches in one call (the
wrapper's count); every device launch of one call by torch.profiler
(kernels, copies and memsets, the coarse tail's and the all-gather's
too; up to three sessions, until one holds each of the kernel's
launches); CUDA events around the whole call; and the call's host time,
synchronised, three runs.  Prints one JSON line a call, with the card's
name and power limit.  Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_launches(torch, fn, kernel: str, want: int) -> tuple:
    """({device launch name: count} of one ``fn()`` by torch.profiler, the
    session that held ``want`` launches of ``kernel``, or 0 where none of
    three did)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for session in (1, 2, 3):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                k = e.name.split("(")[0].split("<")[0].split()[-1]
                names[k] = names.get(k, 0) + 1
        if names.get(kernel, 0) == want:
            return names, session
    return names, 0


def main(argv: list) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("halo_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    smoke = load("chip_smoke_for_halo", os.path.join(HERE, "chip_smoke.py"))
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import halo
    from dwt_tpu_torch.parallel import hosts, tiled

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{smoke.free_port()}", world_size=1, rank=0)
    try:
        W, H, C = smoke.W, smoke.H, smoke.C
        img = smoke.random_image(W, H, C, 0)
        pyr, mesh = compute_pyramid(W, H), hosts.global_mesh()
        rows = tiled.rank_rows(img, mesh, pyr)
        fine, _ = tiled.halo_dwt2d_fwd(rows, mesh, pyr, colour=True)
        for what, fn, inverse, wrapper, kernel in (
                ("halo_dwt2d_fwd", lambda: tiled.halo_dwt2d_fwd(
                    rows, mesh, pyr, colour=True), False, halo.halo_forward,
                 smoke.HALO_FWD_NAME),
                ("halo_dwt2d_inv", lambda: tiled.halo_dwt2d_inv(
                    fine, mesh, pyr, to_bytes=True), True,
                 halo.halo_inverse, smoke.HALO_INV_NAME)):
            levels = [tuple(lp.level[:3]) for lp in
                      tiled.launch_plan(pyr, 1, 0, inverse)]
            launches = smoke.launch_ms(torch, fn, kernel, len(levels),
                                       args.reps)
            per = None if launches is None else [
                {"level": lv, "device_ms": ms}
                for lv, (_, ms) in zip(levels, launches)]
            before = wrapper.launches
            fn()
            torch.cuda.synchronize()
            count = wrapper.launches - before
            names, session = device_launches(torch, fn, kernel, count)
            host = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                host.append(1e3 * (time.perf_counter() - t0))
            print(json.dumps({
                "call": what, "kernel": kernel,
                "wrapper": wrapper.__name__, "launches": per,
                "device_ms": None if per is None else sum(
                    p["device_ms"] for p in per),
                "kernel_launches": count, "halo_levels": len(levels),
                "device_launches": names, "profiler_session": session,
                "event_ms": smoke.time_ms(torch, fn, reps=args.reps),
                "host_ms": host, "card": card}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
