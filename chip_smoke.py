#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``dwt_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``, and imports neither JAX nor the JAX
package.  Phases, each ending in a flushed progress line with the elapsed
seconds:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — the kernel library, built from ``dwt_tpu_torch/csrc`` by one
             ``nvcc`` call (into ``build/dwt_tpu_torch/``).
3. e2e     — the main path: an encoder built by ``get_encoder`` (which
             runs the gather kernel's one-time probe) encodes a 3840x2160
             RGB frame made from seed 0.  Every kernel's launch count is
             set to 0 just before and read just after; each must be > 0.  The stream's length, token count and SHA-256 must
             equal the JAX package's (constants below).  The inputs of each
             kernel are kept from this run.
4. kernels — each kernel again on those inputs, held against its plain
             PyTorch version on the same CUDA tensors (exact: integers),
             and timed beside the plain version and, where one PyTorch call
             computes the same function, that call.
5. timing  — three warm encodes of the frame, in MP/s, then where one
             warm encode spends its time (stage times; device busy time
             and idle share from torch.profiler, three readings).

Any failure raises, so the exit code is not 0 and no result line is
printed.  On success the last three lines are the kernels' JSON, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

W, H, C = 3840, 2160, 3
# The JAX package's stream for this frame, made on the CPU with
#   JAX_PLATFORMS=cpu python3 -c 'import hashlib, numpy as np, sys;
#     sys.path[:0] = [".", "tests"]; from imagegen import random_image;
#     from dwt_tpu.codec.encoder import get_encoder;
#     img = random_image(np.random.default_rng(0), 3840, 2160, 3, "mixed");
#     s, info = get_encoder(3840, 2160, 3).encode_with_stats(img);
#     print(len(s), info["tokens"], hashlib.sha256(s).hexdigest())'
REF_BYTES = 12_604_029
REF_TOKENS = 29_420_237
REF_SHA256 = "4bd23205c77d3029962c42d1dd3bdf72de160c86cd691c1f7190270490bb638d"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def progress(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def random_image(w: int, h: int, c: int, seed: int) -> np.ndarray:
    """tests/imagegen.py's "mixed" image (loaded by path: numpy only)."""
    spec = importlib.util.spec_from_file_location(
        "imagegen", os.path.join(ROOT, "tests", "imagegen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.random_image(np.random.default_rng(seed), w, h, c, "mixed")


class Kernels:
    """The kernel wrappers of the encode path (the four kernels and the
    gather's probe), their sources and the TPU kernels they replace."""

    def __init__(self):
        from dwt_tpu_torch.codec import emit, stage1, tokens
        from dwt_tpu_torch.ops import compact, hilbert_gather, pack

        # The codec modules call the kernel wrappers by these names.
        self.sites = [(stage1, "hilbert_gather"), (tokens, "compact_tokens"),
                      (emit, "pack_words"), (emit, "scatter_refbits")]
        self.rows = [
            ("hilbert_gather", hilbert_gather.hilbert_gather,
             "dwt_tpu_torch/csrc/hilbert_gather.cu",
             "dwt_tpu/ops/pallas_hilbert.py:284"),
            # The probe's count lives on engine_supported, which launches
            # the gather kernel through engine_probe once per device.
            ("engine_supported", hilbert_gather.engine_supported,
             "dwt_tpu_torch/csrc/hilbert_gather.cu",
             "dwt_tpu/ops/pallas_hilbert.py:107"),
            ("compact_tokens", compact.compact_tokens,
             "dwt_tpu_torch/csrc/compact.cu",
             "dwt_tpu/ops/pallas_compact.py:404"),
            ("pack_words", pack.pack_words,
             "dwt_tpu_torch/csrc/pack.cu",
             "dwt_tpu/ops/pallas_pack.py:235"),
            ("scatter_refbits", compact.scatter_refbits,
             "dwt_tpu_torch/csrc/compact.cu",
             "dwt_tpu/ops/pallas_compact.py:548"),
        ]

    def reset(self) -> None:
        for _, fn, _, _ in self.rows:
            fn.launches = 0

    def counts(self) -> dict:
        return {name: fn.launches for name, fn, _, _ in self.rows}

    @contextlib.contextmanager
    def capture(self, store: dict):
        """Keep a copy of each kernel's inputs while the encoder runs."""
        sites = self.sites
        saved = [getattr(mod, name) for mod, name in sites]

        def keeper(name, fn):
            def run(*args):
                store[name] = tuple(a.clone() if hasattr(a, "clone") else a
                                    for a in args)
                return fn(*args)
            return run

        for (mod, name), fn in zip(sites, saved):
            setattr(mod, name, keeper(name, fn))
        try:
            yield
        finally:
            for (mod, name), fn in zip(sites, saved):
                setattr(mod, name, fn)


def time_ms(torch, fn, setup=lambda: (), reps: int = 10, warm: int = 1):
    """Mean device time of ``fn(*setup())`` over ``reps`` runs, by CUDA
    events around the call only (``setup`` runs outside them)."""
    for _ in range(warm):
        fn(*setup())
    total = 0.0
    for _ in range(reps):
        args = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def u32(t):
    return t.long() & 0xFFFFFFFF


def covered(torch, starts, ends, n: int) -> int:
    """How many positions of [0, n) lie in at least one of the half-open
    ranges [starts, ends) (int64 tensors): a difference array, summed."""
    d = torch.zeros(n + 1, dtype=torch.int32, device=starts.device)
    one = torch.ones_like(starts, dtype=torch.int32)
    d.index_add_(0, starts.clamp(0, n), one)
    d.index_add_(0, ends.clamp(0, n), -one)
    return int((torch.cumsum(d, 0)[:n] > 0).sum())


def unit_elements(torch, vmag, meta, E: int) -> int:
    """Packed elements that the live units of kernel A or B (meta col 6 >
    0) cover: each must be read at least once."""
    live = meta[meta[:, 6] > 0].long()
    start = live[:, 0] * vmag.shape[1]
    return covered(torch, start, start + live[:, 1].clamp(0, E),
                   vmag.numel())


def check_kernels(torch, K: Kernels, got: dict, launches: dict) -> list:
    """Phase 4: each kernel against its plain version, and its times."""
    from dwt_tpu_torch.codec.stage1 import ALIGN
    from dwt_tpu_torch.hilbert import padded_layout
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import compact, hilbert_gather, pack

    from dwt_tpu_torch.ops.compact import E

    out = []

    def row(name, kernel_out, plain_out, ms, plain_ms, nbytes, library_ms):
        if kernel_out.shape != plain_out.shape:
            raise AssertionError(f"{name}: shape {tuple(kernel_out.shape)} "
                                 f"!= plain {tuple(plain_out.shape)}")
        err = int((u32(kernel_out) - u32(plain_out)).abs().max()) \
            if kernel_out.numel() else 0
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        src, rep = next((s, r) for n, _, s, r in K.rows if n == name)
        out.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=library_ms))
        progress(f"kernels: {name} equal to its plain version; "
                 f"{ms:.3f} ms (plain {plain_ms:.3f} ms, library "
                 f"{'n/a' if library_ms is None else f'{library_ms:.3f} ms'}, "
                 f"bound {out[-1]['bound_ms']:.3f} ms)")

    # 1. gather: (H, W, C) coefficients -> (C, nlin)
    co, src = got["hilbert_gather"]
    k = hilbert_gather.hilbert_gather(co, src)
    p = hilbert_gather.hilbert_gather_plain(co, src)
    perm = torch.as_tensor(padded_layout(compute_pyramid(W, H), ALIGN)[0],
                           device=co.device).long()
    lib_ms = time_ms(torch, lambda: co.reshape(-1, C)[perm].T.contiguous())
    row("hilbert_gather", k, p,
        time_ms(torch, lambda: hilbert_gather.hilbert_gather(co, src)),
        time_ms(torch, lambda: hilbert_gather.hilbert_gather_plain(co, src),
                reps=3),
        4 * (src.numel() + co.numel() + k.numel()), lib_ms)

    # 1b. the gather's probe: one 32x32 tile (as engine_supported runs it)
    co, src = hilbert_gather.probe_tile(co.device)
    k = hilbert_gather.engine_probe(co, src)
    p = hilbert_gather.hilbert_gather_plain(co, src)
    row("engine_supported", k, p,
        time_ms(torch, lambda: hilbert_gather.engine_probe(co, src)),
        time_ms(torch, lambda: hilbert_gather.hilbert_gather_plain(co, src)),
        4 * (src.numel() + co.numel() + k.numel()),
        time_ms(torch, lambda: co.reshape(-1, 1)[src.long()].T.contiguous()))

    # 2. kernel A: reads the elements its live units cover, writes one
    # pair per newly significant element (meta col 6)
    vmag, meta, npairs = got["compact_tokens"]
    k = compact.compact_tokens(vmag, meta, npairs)
    p = compact.compact_tokens_plain(vmag, meta, npairs)
    row("compact_tokens", k, p,
        time_ms(torch, lambda: compact.compact_tokens(vmag, meta, npairs)),
        time_ms(torch, lambda: compact.compact_tokens_plain(vmag, meta,
                                                            npairs), reps=2),
        4 * (unit_elements(torch, vmag, meta, E) + meta.numel()
             + min(npairs, int(meta[:, 6].clamp(min=0).sum()))), None)

    # 3. pack: 16 B read a token, and the words up to the last token's
    # third piece written (widx is nondecreasing); three index_add_ on
    # int64 words are the library yardstick
    widx, c0, c1, c2, nwords = got["pack_words"]
    k = pack.pack_words(widx, c0, c1, c2, nwords)
    p = pack.pack_words_plain(widx, c0, c1, c2, nwords)
    idx = [widx.long() + j for j in range(3)]
    cs = [u32(c) for c in (c0, c1, c2)]

    def library_pack(acc):
        for i, c in zip(idx, cs):
            acc.index_add_(0, i, c)

    lib_ms = time_ms(torch, library_pack, setup=lambda: (torch.zeros(
        nwords + 2, dtype=torch.int64, device=widx.device),))
    row("pack_words", k, p,
        time_ms(torch, lambda: pack.pack_words(widx, c0, c1, c2, nwords)),
        time_ms(torch, lambda: pack.pack_words_plain(widx, c0, c1, c2,
                                                     nwords), reps=3),
        4 * (4 * widx.numel() + min(nwords, int(widx[-1]) + 3)), lib_ms)

    # 4. kernel B (in place on the packed words: a fresh copy each run):
    # reads the elements its live units cover and reads and writes each
    # word that holds one of their refinement bits
    vmag, meta, words = got["scatter_refbits"]
    live = meta[meta[:, 6] > 0].long()
    bit0 = 32 * live[:, 3] + live[:, 4]
    ref_words = covered(torch, bit0 >> 5, ((bit0 + live[:, 6] - 1) >> 5) + 1,
                        words.numel())
    k = compact.scatter_refbits(vmag, meta, words.clone())
    p = compact.scatter_refbits_plain(vmag, meta, words.clone())
    row("scatter_refbits", k, p,
        time_ms(torch, compact.scatter_refbits,
                setup=lambda: (vmag, meta, words.clone())),
        time_ms(torch, compact.scatter_refbits_plain,
                setup=lambda: (vmag, meta, words.clone()), reps=2),
        4 * (unit_elements(torch, vmag, meta, E) + meta.numel()
             + 2 * ref_words), None)
    return out


def busy_ms(events, DeviceType) -> float:
    """Device busy time: the union of the device events' intervals
    (kernels, copies, sets), so work on several streams is not counted
    twice."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def profile(torch, enc, img) -> None:
    """Where a warm 4K encode spends its time: host-clock stage times
    (synchronised), then, from torch.profiler, the device's busy time (the
    union of its events' intervals) against the host wall time of the
    encode, and the device time by kernel.  Three profiled encodes follow
    one that pays the profiler's start-up; each reading is printed.  A
    reading with no device time, or with more device time than wall time,
    prints "not measured".  The profiler slows the host, so the idle share
    read here is an upper bound on the unprofiled one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dwt_tpu_torch.codec import emit, encoder, stage1, tokens

    pyr, C = enc.pyr, enc.channels
    x = torch.as_tensor(img, device=enc.device)
    marks = [time.perf_counter()]
    lin, stats = stage1._transform_and_stats(x, pyr, C, enc.gray, enc._src)
    T = int(stats["T"])
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    padded_T = encoder._bucket(T)
    tv, tr, tf, orders, vmag, com = tokens._stage2_tokens(lin, stats, pyr, C,
                                                          padded_T)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    emit._stage2_emit(lin, stats, tv, tr, tf, orders, vmag, com, pyr, C,
                      padded_T)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    progress(f"profile: stage1 {ms[0]:.1f} ms, tokens {ms[1]:.1f} ms, "
             f"emit {ms[2]:.1f} ms (host clock, synchronised)")
    del lin, stats, tv, tr, tf, orders, vmag, com

    readings = []
    for i in range(4):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            enc.encode(img)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        if i == 0:
            continue
        events = prof.events()
        busy = busy_ms(events, DeviceType)
        if 0 < busy <= wall:
            readings.append(f"busy {busy:.1f} ms of {wall:.1f} ms wall, "
                            f"idle share {1 - busy / wall:.3f}")
        else:
            readings.append(f"not measured (device busy {busy:.1f} ms, "
                            f"wall {wall:.1f} ms)")
    per_name: dict = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            t, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    progress("profile: device time of three profiled encodes: "
             + "; ".join(readings))
    progress("profile: top device time (last one): " + "; ".join(
        f"{name[:60]} {t / 1e3:.2f} ms x{n}" for name, (t, n) in top))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    progress(f"device: {kind} ({card}); torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}")

    # 2. build
    from dwt_tpu_torch.runtime import build

    path, secs = build.build()
    build.library()
    progress(f"build: {len(build.sources())} sources, one nvcc call, "
             f"{secs:.1f} s -> {os.path.relpath(path, ROOT)}")

    # 3. e2e: the main path, with the kernels' launch counts
    from dwt_tpu_torch.codec.encoder import get_encoder

    img = random_image(W, H, C, seed=0)
    K = Kernels()
    got: dict = {}
    K.reset()
    with K.capture(got):
        enc = get_encoder(W, H, C)
        stream, info = enc.encode_with_stats(img)
    torch.cuda.synchronize()
    launches = K.counts()
    digest = hashlib.sha256(stream).hexdigest()
    progress(f"e2e: {W}x{H}x{C} encoded, {len(stream)} bytes, "
             f"T={info['tokens']}, sha256 {digest[:16]}, "
             f"{info['seconds']:.2f} s cold; launches {launches}")
    if (len(stream), info["tokens"], digest) != (REF_BYTES, REF_TOKENS,
                                                 REF_SHA256):
        raise AssertionError(
            f"stream differs from the JAX package's: {len(stream)} bytes, "
            f"T={info['tokens']}, sha256 {digest} (want {REF_BYTES}, "
            f"{REF_TOKENS}, {REF_SHA256})")
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")

    # 4. kernels against their plain versions, on the main path's inputs
    rows = check_kernels(torch, K, got, launches)
    del got
    torch.cuda.empty_cache()

    # 5. timing: warm encodes
    mps = []
    for _ in range(3):
        s, inf = enc.encode_with_stats(img)
        if s != stream:
            raise AssertionError("a warm encode differs from the first")
        mps.append(inf["mps"])
    progress(f"timing: warm 4K encode {', '.join(f'{m:.2f}' for m in mps)} "
             f"MP/s on {card}")
    profile(torch, enc, img)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
