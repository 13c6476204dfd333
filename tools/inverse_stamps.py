#!/usr/bin/env python3
"""Where kernel 16 (``csrc/lifting_inv.cu``) spends its time inside its
launches, phase by phase, on one CUDA card.

    python3 tools/inverse_stamps.py [--root DIR] [--reps N] [--sweep]

Builds DIR's ``csrc/lifting_inv.cu`` (default: this checkout's) alone with
``-DDWT_STAMPS`` into ``build/dwt_tpu_torch/stamps/`` and runs DIR's
``inverse_transform`` with that build in place of the library's, on
seeded coefficients of three shapes: a 3840x2160 RGB frame, the preview's
480x270 and a 16K tile group of 480 512x512 tiles, each as DIR's decoder
hands them over (where DIR's ``inverse_transform`` takes a ``bias`` table,
the scatter's (H, W, N, C) output as an uncopied (N, H, W, C) view, the
root band as a view of the parsed (N, C, total) coefficients and a bias
table; else the contiguous pyramid).  Every call's output is held equal
to the library kernel's.  A source without the hooks (a tree from before
them) gets them inserted at the same places of its phases (``HOOKS``),
in a copy.

The stamped build writes:

* the coarse tail (block 0, thread 0): the global timer and the SM clock
  at the start, after the table set-up, after the loads, after each
  level and after the store;
* each of the first ``STAMP_WARPS`` warps of each large level's launch:
  the SM cycles it spends in each phase of its walk (the prologue, the
  loads' issue, the column walk, the row shuffles, the store), summed
  over its steps.  The last launch, the finest level, writes last.

Prints, for each shape, the device time of each launch of the library's
kernel (torch.profiler, means of 20 calls), and the medians over
``--reps`` calls of the stamped build (after five warm ones): the tail's
phases in ns from its first stamp (by the global timer,
and by the SM clock at the clock rate those stamps give), and the finest
level's warps' mean and median cycles a phase, in ns at that rate; one
JSON line a shape, with the card's name and power limit; first, one
line with ptxas's registers and shared memory for each kernel of the
source built without the stamps.  With ``--sweep`` (this tree's plan
only), also the library kernel's device time by launch at each setting
of the plan's knobs (``SWEEP``).  Needs a card and ``nvcc``; exits 1
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STAMP_WARPS = 8192  # warps of a level launch that stamp (csrc STAMP_WARPS)
WARP_PHASES = ("prologue", "load issue", "column walk", "row shuffles",
               "store")
TAIL_SLOTS = 32  # the tail's stamps: 0 start, 1 tables, 2 loads, 3.. levels
TAIL_END = 31  # the tail's store

# The stamps as csrc/lifting_inv.cu defines them; inserted into a source
# from before them, with the calls below.
STAMP_MACROS = r"""
#ifdef DWT_STAMPS
constexpr int STAMP_WARPS = %d;
__device__ unsigned long long g_tail_stamps[2][32];
__device__ long long g_warp_cycles[STAMP_WARPS][8];
#define TAIL_STAMP(k)                                                   \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {      \
      unsigned long long t_;                                            \
      asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_));           \
      g_tail_stamps[0][k] = t_;                                         \
      g_tail_stamps[1][k] = (unsigned long long)clock64();              \
    }                                                                   \
  } while (0)
#define WARP_T0                        \
  long long t_w = clock64();           \
  long long acc_w[6] = {0, 0, 0, 0, 0, 0}
#define WARP_LAP(k)                    \
  do {                                 \
    const long long t_ = clock64();    \
    acc_w[k] += t_ - t_w;              \
    t_w = t_;                          \
  } while (0)
#define WARP_STEP ++acc_w[5]
#define WARP_END(gw)                                          \
  do {                                                        \
    if ((threadIdx.x & 31) == 0 && (gw) < STAMP_WARPS)        \
      for (int q_ = 0; q_ < 6; ++q_)                          \
        g_warp_cycles[gw][q_] = acc_w[q_];                    \
  } while (0)
extern "C" int dwt_unlift_stamps(void* tail, void* warps) {
  cudaError_t e = cudaMemcpyFromSymbol(tail, g_tail_stamps,
                                       sizeof(g_tail_stamps));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(warps, g_warp_cycles,
                                   sizeof(g_warp_cycles));
}
#else
#define TAIL_STAMP(k) \
  do {                \
  } while (0)
#define WARP_T0 \
  do {          \
  } while (0)
#define WARP_LAP(k) \
  do {              \
  } while (0)
#define WARP_STEP \
  do {            \
  } while (0)
#define WARP_END(gw) \
  do {               \
  } while (0)
#endif
""" % STAMP_WARPS

# (the text after which a hook goes, the hook): the places in the
# kernels of PR 24 (eaf2087), each text found exactly once.
HOOKS = (
    ('#include "common.cuh"\n', STAMP_MACROS),
    ("  if (gw >= nwarps) return;  // uniform over the warp\n",
     "  WARP_T0;\n"),
    ("  if (i0 + 1 < he) {\n    load_s(i0 + 1, sN);\n    load_d(i0 + 1, dN);"
     "\n  }\n", "  WARP_LAP(0);\n"),
    ("      load_s(i + 2, s2);\n      load_d(i + 2, d2);\n    }\n",
     "    WARP_LAP(1);\n"),
    ("    for (int k = 0; k < 2 * C; ++k) o[k] = D[k] + (E[k] + EN[k]) / 2;"
     "\n", "    WARP_LAP(2);\n"),
    ("    if (odd) unlift_row<C>(o, o + C, j, w, px[1][0], px[1][1]);\n",
     "    WARP_LAP(3);\n"),
    ("        for (int e = lane; e < npx * C; e += 32) d[e] = v[e];\n"
     "      }\n    }\n    __syncwarp();\n", "    WARP_LAP(4);\n    WARP_STEP;\n"),
    ("      dN[k] = d2[k];\n    }\n  }\n", "  WARP_END(gw);\n"),
    ("  extern __shared__ int t[];\n", "  TAIL_STAMP(0);\n"),
    ("    else ex[i - ht] = axis_entry(i - ht, ch.w, L);\n  }\n"
     "  __syncthreads();\n", "  TAIL_STAMP(1);\n"),
    ("          __ldg(row + (int64_t)b * C + c);\n    }\n  }\n"
     "  __syncthreads();\n", "  TAIL_STAMP(2);\n"),
    ("        x[jj * st] += (x[(jj - 1) * st] + x[right * st]) / 2;\n"
     "      }\n    }\n    __syncthreads();\n", "    TAIL_STAMP(2 + k);\n"),
    ("        d[(int64_t)x * C + (e - x * CB)] = at(e);\n      }\n    }\n"
     "  }\n", "  __syncthreads();\n  TAIL_STAMP(31);\n"),
)


def hooked(text: str) -> str:
    """``text`` with ``HOOKS`` inserted; raises unless each anchor is
    found exactly once."""
    for anchor, hook in HOOKS:
        if text.count(anchor) != 1:
            raise ValueError(f"inverse_stamps: {anchor!r} found "
                             f"{text.count(anchor)} times")
        text = text.replace(anchor, anchor + hook)
    return text


def stamped_library(build, flags=("-DDWT_STAMPS",), report=None):
    """The tree's kernel 16 built alone with ``flags`` (the stamps, or
    none); ``report``, a list, gets ptxas's lines of registers and shared
    memory."""
    text = (build.CSRC / "lifting_inv.cu").read_text()
    if "DWT_STAMPS" not in text:
        text = hooked(text)
    key = hashlib.sha256((text + " ".join(flags)).encode()).hexdigest()[:12]
    out = os.path.join(ROOT, "build", "dwt_tpu_torch", "stamps", key)
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "lifting_inv.cu"), os.path.join(
        out, "liblifting_inv_stamps.so")
    with open(src, "w") as f:
        f.write(text)
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, *flags,
                        "-Xptxas", "-v", f"-I{build.CSRC}", "-shared", "-o",
                        lib, src], check=True, capture_output=True, text=True)
    if report is not None:
        report.extend(ln.split("info    : ")[-1] for ln in
                      r.stderr.splitlines() if "registers" in ln
                      or "Compiling entry" in ln)
    lib = ctypes.CDLL(lib)
    for name, types in build.ENTRY_POINTS.items():
        if name.startswith("dwt_unlift"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(types), ctypes.c_int
    if "-DDWT_STAMPS" in flags:
        lib.dwt_unlift_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.dwt_unlift_stamps.restype = ctypes.c_int
    return lib


def registers(build, card) -> None:
    """One JSON line: ptxas's registers and shared memory for each kernel
    of the tree's source built without the stamps."""
    report = []
    stamped_library(build, (), report)
    names = [ln.split("(")[0].split("_cu_")[-1] for ln in report
             if "Compiling" in ln]
    print(json.dumps({"card": card, "ptxas": list(zip(
        names, [ln for ln in report if "registers" in ln]))}), flush=True)


def calls(torch, lifting, pyramid_chain, compute_pyramid) -> list:
    """[(label, args)]: seeded coefficients of the three shapes, as the
    tree's decoder hands them to ``inverse_transform``."""
    fresh = "bias" in inspect.signature(lifting.inverse_transform).parameters
    gen = torch.Generator(device="cuda").manual_seed(16)
    out = []
    for label, (n, h, w, c) in (("4K", (1, 2160, 3840, 3)),
                                ("preview", (1, 270, 480, 3)),
                                ("16K tile group", (480, 512, 512, 3))):
        pyr = compute_pyramid(w, h)
        chain = pyramid_chain(pyr)
        x = torch.randint(-700, 700, (h, w, n, c), dtype=torch.int32,
                          device="cuda", generator=gen)
        if not fresh:
            out.append((label, (x.permute(2, 0, 1, 3).contiguous(), chain,
                                True, True), {}))
            continue
        h0, w0 = pyr.heights[0], pyr.widths[0]
        lin = torch.randint(-700, 700, (n, c, pyr.pixels[1]),
                            dtype=torch.int32, device="cuda",
                            generator=gen)
        root = lin[..., :h0 * w0].view(n, c, h0, w0).permute(0, 2, 3, 1)
        bias = (1 << torch.randint(0, 4, (n, c, 16), dtype=torch.int32,
                                   device="cuda", generator=gen)) // 2
        out.append((label, (x.permute(2, 0, 1, 3), chain, True, True),
                    {"bias": bias, "root": root}))
    return out


def launch_ms(torch, fn, n: int = 20) -> list | None:
    """Device ms of each kernel-16 launch of one ``fn()``, in launch order,
    means of ``n`` calls after a warm one, by torch.profiler; None where
    it recorded a count of launches that ``n`` calls cannot make."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and "inverse_" in e.name), key=lambda e: e.time_range.start)
    if not ev or len(ev) % n:
        return None
    k = len(ev) // n
    return [sum(ev[r * k + i].time_range.elapsed_us() for r in range(n))
            / n / 1e3 for i in range(k)]


# The plan's knobs swept by --sweep (ops/lifting.py): the tail's cap on
# its top level's samples a channel, its largest cluster, the warps a
# large level's launch aims for (its row pairs a warp), and on interleaved
# frames the frames a warp of a large level reads together and the tail's
# own cap.
SWEEP = {"UNLIFT_TAIL_SAMPLES": (16384, 32768, 131072),
         "CLUSTER_MAX": (1, 8), "WARP_TARGET": (4096, 8192, 16384),
         "LANE_FRAMES": (1, 2),
         "INTERLEAVED_TAIL_SAMPLES": (1024, 4096, 16384)}
INTERLEAVED_ONLY = ("LANE_FRAMES", "INTERLEAVED_TAIL_SAMPLES")


def sweep(torch, lifting, cases, card) -> None:
    """Kernel 16's device time by launch on ``cases`` at each setting of
    the plan's knobs (``SWEEP``; the frames a warp only where the frames
    are interleaved), each output held equal to the default plan's: one
    JSON line a shape and setting."""
    import itertools

    saved = {k: getattr(lifting, k) for k in SWEEP}
    for label, fargs, kw in cases:
        want = lifting.inverse_transform(*fargs, **kw)
        inter = fargs[0].shape[0] > 1
        for values in itertools.product(*SWEEP.values()):
            knobs = dict(zip(SWEEP, values))
            if not inter and any(knobs[k] != saved[k]
                                 for k in INTERLEAVED_ONLY):
                continue
            if inter and knobs["UNLIFT_TAIL_SAMPLES"] != saved[
                    "UNLIFT_TAIL_SAMPLES"]:
                continue  # interleaved frames take their own cap
            try:
                for k, v in knobs.items():
                    setattr(lifting, k, v)
                lifting._plan.cache_clear()
                plan = lifting.plan_of(*fargs)
                if not torch.equal(lifting.inverse_transform(*fargs, **kw),
                                   want):
                    raise AssertionError(f"{label} {knobs}: differs")
                ms = launch_ms(torch, lambda: lifting.inverse_transform(
                    *fargs, **kw))
            finally:
                for k, v in saved.items():
                    setattr(lifting, k, v)
                lifting._plan.cache_clear()
            print(json.dumps({
                "shape": label, "card": card, "knobs": knobs,
                "plan": [[list(p.levels), p.cb, p.K, p.F] for p in plan],
                "launch_ms": ms, "device_ms": sum(ms) if ms else None}),
                flush=True)
        del want
        torch.cuda.empty_cache()


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true",
                    help="also time the plan's knobs (SWEEP), this tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("inverse_stamps: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting
    from dwt_tpu_torch.runtime import build

    lib = stamped_library(build)
    tail = np.zeros((2, TAIL_SLOTS), np.uint64)
    warps = np.zeros((STAMP_WARPS, 8), np.int64)
    registers(build, card)
    cases = calls(torch, lifting, lifting.pyramid_chain, compute_pyramid)
    if args.sweep:
        sweep(torch, lifting, cases, card)
    for label, fargs, kw in cases:
        want = lifting.inverse_transform(*fargs, **kw)
        ms = launch_ms(torch, lambda: lifting.inverse_transform(*fargs, **kw))
        groups = ([p.levels for p in lifting.plan_of(*fargs)]
                  if hasattr(lifting, "plan_of")
                  else lifting.unlift_levels(fargs[1]))
        runs_t, runs_w, ghz = [], [], []
        saved = lifting.build.library
        lifting.build.library = lambda: lib
        try:
            for r in range(5 + args.reps):
                tail[:] = 0
                warps[:] = 0
                got = lifting.inverse_transform(*fargs, **kw)
                torch.cuda.synchronize()
                build.check(lib.dwt_unlift_stamps(tail.ctypes.data,
                                                  warps.ctypes.data),
                            "inverse_stamps")
                if not torch.equal(got, want):
                    raise AssertionError("the stamped kernel differs")
                if r < 5:
                    continue
                t = tail.astype(np.int64)
                if t[0, 0] > 0:
                    ns, cyc = t[0] - t[0, 0], t[1] - t[1, 0]
                    ghz.append(cyc[TAIL_END] / max(ns[TAIL_END], 1))
                    runs_t.append(np.stack([np.where(t[0] > 0, ns, -1),
                                            np.where(t[1] > 0, cyc, -1)]))
                live = warps[:, 5] > 0
                if live.any():
                    runs_w.append(warps[live, :6])
        finally:
            lifting.build.library = saved
        rate = float(np.median(ghz)) if ghz else None
        res = {"shape": label, "card": card, "launches": len(groups),
               "levels_by_launch": [list(g) for g in groups],
               "sm_ghz_from_tail_stamps": rate,
               "launch_ms_unstamped": ms,
               "device_ms_unstamped": sum(ms) if ms else None}
        if runs_t:
            med = np.median(np.stack(runs_t), axis=0)
            slots = [0, 1, 2] + [3 + k for k in range(len(groups[0]))] \
                + [TAIL_END]
            names = (["start", "tables", "loads"]
                     + [f"level {k + 1}" for k in range(len(groups[0]))]
                     + ["store"])
            res["tail_ns_from_start"] = {
                n: float(med[0, s]) for n, s in zip(names, slots)}
            res["tail_cycles_from_start"] = {
                n: float(med[1, s]) for n, s in zip(names, slots)}
        if runs_w:
            w = np.concatenate(runs_w)
            per = w[:, :5] / w[:, 5:6].clip(1)
            res["finest_warps"] = int(w.shape[0] // len(runs_w))
            res["finest_steps_median"] = float(np.median(w[:, 5]))
            res["finest_cycles_mean"] = dict(zip(
                WARP_PHASES, map(float, w[:, :5].mean(axis=0))))
            res["finest_cycles_median"] = dict(zip(
                WARP_PHASES, map(float, np.median(w[:, :5], axis=0))))
            res["finest_cycles_a_step_median"] = dict(zip(
                WARP_PHASES, map(float, np.median(per, axis=0))))
            if rate:
                res["finest_ns_mean"] = {
                    k: v / rate for k, v in res["finest_cycles_mean"].items()}
        print(json.dumps(res), flush=True)
        del want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
