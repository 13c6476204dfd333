#!/usr/bin/env python3
"""Kernels 18 and 19, the halo levels, on one CUDA card, launch by launch.

    python3 tools/halo_kernels.py [--reps N] [--ranks 2 [--root DIR]]

In a process of its own (a long process's profiler sessions lose the
device records of some launches), on the 3840x2160 RGB frame of
``tests/imagegen.py`` ("mixed", seed 0), at world size 1 on an NCCL
process group of one rank (as ``chip_smoke.py`` phase 7 runs the sharded
routes):

* ``halo_dwt2d_fwd`` of the frame's uint8 rows with the colour
  (``parallel/tiled.py``; kernel 18, the launches of ``launch_plan``);
* ``halo_dwt2d_inv`` of its fine block to uint8 pixels (kernel 19).

For each: every launch of the kernel in one call, in launch order, with
the levels it covers (each level's stride, columns, rows) and its device
time (torch.profiler, means of ``--reps`` calls after a warm one,
``chip_smoke.py``'s ``launch_ms``), their sum; the kernel's launches in
one call (the wrapper's count); every device launch of one call by
torch.profiler (kernels, copies and memsets, the coarse tail's and the
all-gather's too; up to three sessions, until one holds each of the
kernel's launches); CUDA events around the whole call; and the call's
host time, synchronised, seven runs.  Prints one JSON line a call, with
the card's name and power limit.  Needs a card; exits 1 without one.

With ``--ranks 2``: two ranks on NCCL in spawned processes (``cuda:0``,
``cuda:1``), each on its rows of the same frame; a JSON line a rank and
call with the kernel's device time a call summed over its launches (one
torch.profiler session of ``--reps`` calls after a warm one, every rank
making the same calls, so that their exchanges pair), its launches a
call, and the call's host time.  ``--root DIR`` measures the
``dwt_tpu_torch`` of another tree (a parent unpacked there) through the
same entry points.  Needs two cards.
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


def rank_worker(rank: int, n: int, port: int, root: str, reps: int,
                card: str) -> None:
    """One rank of ``--ranks n``: its device time of kernels 18 and 19 a
    call, by torch.profiler, and its host time a call."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sys.path.insert(0, root)
    smoke = load("chip_smoke_for_halo", os.path.join(HERE, "chip_smoke.py"))
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.parallel import hosts, tiled

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        W, H, C = smoke.W, smoke.H, smoke.C
        img = smoke.random_image(W, H, C, 0)
        pyr, mesh = compute_pyramid(W, H), hosts.global_mesh()
        rows = tiled.rank_rows(img, mesh, pyr)
        fine, _ = tiled.halo_dwt2d_fwd(rows, mesh, pyr, colour=True)
        for what, fn, kernel in (
                ("halo_dwt2d_fwd", lambda: tiled.halo_dwt2d_fwd(
                    rows, mesh, pyr, colour=True), smoke.HALO_FWD_NAME),
                ("halo_dwt2d_inv", lambda: tiled.halo_dwt2d_inv(
                    fine, mesh, pyr, to_bytes=True), smoke.HALO_INV_NAME)):
            fn()
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA and kernel in e.name]
            host = []
            for _ in range(7):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                host.append(1e3 * (time.perf_counter() - t0))
            print(json.dumps({
                "call": what, "kernel": kernel, "rank": rank, "ranks": n,
                "root": root, "device_ms": sum(us) / reps / 1e3,
                "launches": len(us) / reps, "host_ms": host, "card": card}),
                flush=True)
    finally:
        dist.destroy_process_group()


def main(argv: list) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("halo_kernels: no CUDA device", file=sys.stderr)
        return 1
    if args.ranks > 1:
        if torch.cuda.device_count() < args.ranks:
            print(f"halo_kernels: {args.ranks} ranks need as many cards",
                  file=sys.stderr)
            return 1
        import torch.multiprocessing as mp

        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        smoke = load("chip_smoke_for_halo", os.path.join(HERE,
                                                         "chip_smoke.py"))
        sys.path.insert(0, os.path.abspath(args.root))
        from dwt_tpu_torch.runtime import build  # built once, not a rank each

        build.library()
        mp.spawn(rank_worker, args=(args.ranks, smoke.free_port(),
                                    os.path.abspath(args.root), args.reps,
                                    card), nprocs=args.ranks, join=True)
        return 0
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
            plan = tiled.launch_plan(pyr, 1, 0, inverse)
            groups = [[tuple(lv[:3]) for lv in la.levels] for la in plan]
            launches = smoke.launch_ms(torch, fn, kernel, len(plan),
                                       args.reps)
            per = None if launches is None else [
                {"levels": g, "device_ms": ms}
                for g, (_, ms) in zip(groups, launches)]
            before = wrapper.launches
            fn()
            torch.cuda.synchronize()
            count = wrapper.launches - before
            names, session = device_launches(torch, fn, kernel, count)
            host = []
            for _ in range(7):
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
                "kernel_launches": count, "planned_launches": len(plan),
                "halo_levels": sum(map(len, groups)),
                "device_launches": names, "profiler_session": session,
                "event_ms": smoke.time_ms(torch, fn, reps=args.reps),
                "host_ms": host, "card": card}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
