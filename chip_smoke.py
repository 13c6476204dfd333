#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``dwt_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``, and imports neither JAX nor the JAX
package.  Phases, each ending in a flushed progress line with the elapsed
seconds:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — the kernel library, built from ``dwt_tpu_torch/csrc`` by one
             ``nvcc`` process a source, all started together, and a link
             (into ``build/dwt_tpu_torch/``).
3. e2e     — the two main paths.  Encode: an encoder built by
             ``get_encoder`` (which runs the tile engines' one-time probe)
             encodes a 3840x2160 RGB frame made from seed 0; the stream's
             length, token count and SHA-256 must equal the JAX package's
             (constants below).  Decode: ``decoder.decode`` reads that
             stream back, and the pixels must equal the frame.  Every
             kernel's launch count is set to 0 just before each path and
             read just after; each kernel of the path must be > 0.  The
             inputs of each kernel are kept from these runs.  Then two
             lossy decodes of the same stream, a 1,000,000-byte prefix
             (which must leave planes missing, so the midpoint bias runs)
             and a reduced decode capped at 960x540 (``pixels_max=518400``),
             whose shapes and pixels' SHA-256 must equal the JAX package's
             (constants below), each with its launch counts and its
             scatter and inverse-transform calls held to the plain
             versions, and a root-only decode (``pixels_max`` at the root
             band's pixel count: kernel 16 once, on the root size) equal
             to the same stream decoded on the CPU.  Then a capacity
             encode (1,000,000 bytes), which must equal the lossless
             stream's prefix with fewer tokens.  Then the tiled paths:
             ``encode_tiled`` of the frame in 512x512 tiles (40 tiles, 4
             geometries, each one sub-batch of the batch mode, so each
             encode kernel launches once a geometry: the lossless encode's
             counts must say so), lossless and cut to a third of its
             size, both held to the JAX package's container digests, and
             ``decode_tiled`` of each container: the lossless one must
             give the frame back, the budgeted one the JAX package's
             pixels (its line counts the tiles that the budgeted encode
             emitted again unmasked).  The capacity encode and each tiled path
             also run with the launch counts reset before and read after
             (each kernel of the path must be > 0) and with their kernel
             inputs kept: one call of each kernel for each distinct set of
             input shapes (a tile geometry, a token bucket, the batched
             scatter of N tiles as N*C channels), held at once against
             its plain version on the same CUDA tensors (exact).  Then
             small tiles (``small_tiles``): a 2736x2736 RGB frame in
             16x16 tiles, 29,241 of one geometry, more than one
             sub-batch holds within stage 2's int32 indices; it encodes
             in two sub-batches (counts reset and read), equal to the same
             container in sub-batches of 4,096, decodes back to the
             frame, and stage 1's kernels (kernel 14 too) and kernel 15
             equal their plain versions on 256 of its tiles, and kernel
             17 on its calls of both sub-batches.
4. kernels — each kernel again on the 4K main paths' inputs, held against
             its plain PyTorch version on the same CUDA tensors (exact:
             integers), and timed beside the plain version and, where one
             PyTorch call computes the same function, that call: first
             stage 1's forward transform (colour and lifting, a launch a
             large level and one for the coarse tail) and plane
             statistics (one kernel); the
             wrappers of the pack kernel and kernels A and B also in their
             parts (zero fill, order check or unit table, launches);
             kernel B also with its own count launch and unit table, and
             its refinement bits, 1-bits and block runs counted; kernel 5
             with the run table the decoder keeps and with the one its
             wrapper derives, the table's size, and kernel 5 at the tiled
             decode's kept calls, held also at other channel groups;
             kernel 6, which no path runs since the VLI order scan reads
             the token arrays in place, on seeded tensors of the shapes
             the scan gave it (the 4K frame's int32 and int8 and the
             7-frame batch's), with the bytes a thread moves, the int8
             one held also by the element kernel; the VLI order scan's
             one kernel (bound by bytes or by integer operations,
             whichever is larger), how its rows and tiles collapsed on
             the 4K tokens, and one whole 4K ``_vli_orders`` by CUDA
             events and by the host clock, in turns with the parent
             tree's where ``--parent DIR`` names one; kernel 11, the
             codeword pieces (one kernel on the 4K token arrays and step
             tables), beside ``torch.cumsum`` of its int32 lengths as the
             yardstick of its scan alone; kernels 12 and 13, the token
             finisher (on the 4K pairs in a pair buffer's rows, as kernel
             A leaves them) and the packed elements, each beside its
             plain version and bound (no PyTorch call computes either);
             kernels 14 and 15, the schedule (level sums, step order,
             carry chain and token bases, on the 4K chunk tables; beside
             ``torch.argsort`` of its keys as the sort's yardstick) and
             kernel A's unit tables, and both on a seeded sweep of channel
             and level counts up to the kernel's 2,048 steps a frame
             (``schedule_sweep``); kernel 16, the decoder's inverse
             transform (on the 4K decode's inputs; no PyTorch call
             computes it), with its bound with and without the LL
             buffers, and on a seeded sweep of sizes from 2x2 up, 1 and 3
             channels, up to 40 frames, contiguous and as the decoder
             hands it over (``inverse_sweep``); kernel 17, the emit
             half's step tables (on the 4K encode's kernel 11 outputs,
             stats and unit columns; no PyTorch call computes it), and on
             a seeded sweep of channels, of levels up to its 2,048 steps a
             frame and of frames up to a 16x16 sub-batch's 29,126, on
             random orders (its sort) and on tables in schedule order
             from kernel 14's plain version (no sort) (``emit_sweep``),
             with its device time on 3 frames of 2,030 steps and on
             29,126 frames; the tile engines' probe
             as its one
             host call, and one cold ``engine_supported`` by the host
             clock.
5. timing  — three warm encodes of the frame, in MP/s, then where one
             warm encode spends its time (stage times; stage 1 by pass,
             ``tools/stage1_split.py``: upload, colour and lifting,
             gather, statistics, schedule and carry, in turns with the
             parent tree's where ``--parent DIR`` names one; device busy
             time and idle share from torch.profiler, three readings; the
             device-to-host and host-to-device copies of one, which must
             hold one host-to-device copy at most, the upload; the CUDA
             kernels of one ``_codeword_contribs``: kernel 11 and the
             small ones of its (N, S) inputs; the emit half by pass,
             ``tools/emit_split.py``: the pieces, the step tables (kernel
             17; a parent's bit partials, kernel B's meta and layer
             boundaries), the zero fill and pack, kernel B, the host
             totals and the download, in turns with the parent tree's
             where ``--parent DIR`` names one; the emit half gated
             (``emit_gate``: from kernel 11's end to the download only
             the pack, kernel 17 and kernel B kernels and the host
             totals' one copy, the plain step tables made to raise); the
             tokens half by pass, ``tools/tokens_split.py``: the unit
             tables (kernel 15; the parent's unit indexing and kernel A's
             meta and table), the histograms, the packed elements, kernel
             A, the finisher and the VLI scan, in turns with the parent's
             likewise); three
             warm decodes in MP/s, and one decode split into host parse,
             upload, device tail and download, with the scatter kernel's
             share of the tail; the decode tail gated (``tail_gate``:
             on the 1,000,000-byte prefix, the lossless 4K, the preview
             and a budgeted 16K tile group, the tail launches the scatter
             and kernel 16 and no other kernel, with the eager bias and
             the pyramid route made to raise) and by pass
             (``tools/tail_split.py``: the scatter, kernel 16 and the
             rest; a parent's bias, root crop and permute where it has
             them, or the inverse lifting and then the colour, clamp and
             cast) at 4K, at the preview's 480x270 and at a 16K tile
             group of 480 512x512 tiles, in turns with the parent tree's
             where ``--parent DIR`` names one; three warm tiled encodes
             (lossless and at a third) and decodes in MP/s, and one
             ``decode_tiled`` split, by timers wrapped around its own
             calls, into the thread-pooled host parse, the
             upload, the batched tails and the rest (download, mosaic).
6. device  — the device time of kernels 5 and 6 by torch.profiler,
             beside their bounds: kernel 5 at 4K and at the tiled
             decode's calls (there also at other channel groups), kernel
             6 on its seeded tensors (the int8 one also by the element
             kernel), the VLI order scan's kernel, stage 1's three
             kernels, kernel 11, kernels 12-15 and 17 (the finisher's
             dense pass and special tokens, the packed elements, the
             schedule, the unit tables, the step tables' two kernels;
             kernels 14 and 15 also by CUDA events, in turns with the
             parent's where ``--parent DIR`` names one), and the
             forward transform launch by launch with the levels each
             lifts (the scan, stage 1, kernels 11-15 and 17 also at the
             batch's 7-frame shape in phase 9); kernel 16 launch by
             launch with the levels each lifts, at 4K, at the preview's
             480x270 and at the 16K tiled decode's two tile groups
             (seeded coefficients), each held to its plain version, beside
             its bounds (the 480-tile group in the kernels' JSON as its
             ``batch_*`` keys); kernel 16's stamps
             (``tools/inverse_stamps.py``: the tail's and the finest
             level's phases inside their launches) of this tree and, with
             ``--parent DIR``, of the parent's.
             After the timing phase, so that no profiler session runs
             before it.
7. sharded — the multi-GPU routes (``dwt_tpu_torch/parallel``) at world
             size 1: an NCCL process group of rank 0 on ``cuda:0`` (a free
             ``tcp://127.0.0.1`` port), so their all-gathers and
             all-reduces go through NCCL on the card.  Each route runs
             inside ``Kernels.path`` (launch counts reset and read, kernel
             inputs kept and held against the plain versions) and is held
             to the gates of its single-device twin: ``ShardedEncoder`` to
             the stream's length and digest ("sharded encode"),
             ``ShardedDecoder`` of the stream to the frame and of the
             1,000,000-byte prefix to the prefix's shape and digest
             ("sharded decode"; its coarse tail through ``dwt2d_inv``,
             kernel 16's int32 route, unless the coarse region is the
             root band alone, which has no coarse tail to lift), and
             ``encode_tiled_sharded`` lossless and at a third of its size
             to the two container digests ("sharded tiled encode",
             "budgeted sharded tiled encode").  The sharded encode's
             halo levels are kernel 18's launches and the decode's
             kernel 19's (at world size 1 seven a call at 4K: levels 0
             and 1 in one, then one a level; their JSON rows
             from these calls: held to their plain versions, timed
             by CUDA events and torch.profiler beside the plain versions
             and their byte bounds); the two routes are run again with
             the halo levels' plain versions, the eager colour
             transforms and the eager row pad made to raise
             (``halo_gate``); both kernels are held to their plain
             versions on ``HALO_SWEEP`` (odd geometries up to 4K, 1-3
             ranks played on the card by ``tiled.play_ranks``, uint8 RGB
             with the colour to uint8 pixels, uint8 and int32 rows to
             int32); ``tools/halo_kernels.py``, in a process of its own
             on an NCCL group of one rank, times each launch of one warm
             4K ``halo_dwt2d_fwd`` and ``halo_dwt2d_inv`` by
             torch.profiler with the levels each covers, counts the
             call's device launches and times it by the host clock.  The sharded encode
             reaches stage 1's transform kernel only through the halo
             DWT's coarse tail (``dwt2d_fwd`` on the
             levels below the halo levels) and its plane statistics
             through ``_stats_from_lin``; the tiled routes reach both
             through the batch mode's stage 1.  Then warm
             rates of the three, each beside its single-device twin's in
             turns, and where one warm sharded encode and decode spend
             their time by pass (``profile:`` lines; with ``--parent
             DIR`` in turns with that tree's).  With two cards or more,
             two ranks (``cuda:0``, ``cuda:1``) in spawned processes run
             the same routes and gates, and hold each rank's halo
             exchanges (``hosts.comm_log``) and results through the
             kernels to the plain route's (``halo_exchanges``); with one
             card a line says that this did not run.
8. entry points — ``python -m dwt_tpu_torch.cli`` in processes of its
             own: ``encode`` of the frame (written as PNM), whose stream
             must have the JAX package's digest; ``decode`` of it, which
             must give the frame back; ``tiled-encode`` in 512x512 tiles
             at a third of the lossless container, which must have the
             JAX package's budgeted digest; one encode under
             ``DWT_SELFCHECK=1``; one encode of a 512x512 crop under
             ``DWT_TRACE``, whose trace must name the gather and pack
             kernels.  Then ``python -m dwt_tpu_torch.selftest``, every
             configuration of which must be ok.  Last, the budgeted tiled
             encode on small cases (``BUDGET_CASES``): ``encode_tiled`` on
             the card must equal ``encode_tiled_sharded`` at world size 1
             on NCCL (lossless, then cut).
9. batch   — the batch throughput mode, BASELINE config 4: 64 RGB
             1920x1080 frames (seeds 0-63) through
             ``BatchEncoder.encode_batch``, 10 sub-batches (9 of 7
             frames, 1 of 1), in ``Kernels.path``: the streams' total
             bytes and SHA-256 must equal the JAX package's (constants
             below), each encode kernel must launch once a sub-batch (10;
             the forward transform ``launch_levels`` a sub-batch, 50),
             and each stream must equal the single-stream encoder's.  How
             the VLI order scan's rows and tiles collapsed on a 7-frame
             sub-batch's tokens.  Then warm MP/s of the batch in
             turns with the single-stream encoder looped over the same
             frames, the copies and the peak memory of one 7-frame
             sub-batch, stage 1 of a 7-frame sub-batch by pass, and each
             encode kernel's wrapper time at the 7-frame shape beside its
             bound, stage 1's kernels, the VLI order scan's and kernel
             11's also by torch.profiler; the device-to-host copies of
             one 7-frame ``emit_frames``, whose stream download must be
             one; its emit half gated and by pass, and its tokens half by
             pass, in turns with the parent's (also in the kernels' JSON:
             ``batch_launches``, ``batch_ms``, ``batch_bound_ms``,
             ``batch_device_ms``).

``python3 chip_smoke.py --two-ranks`` runs phases 1 and 2 and then only
the two-rank run of phase 7 (it needs two cards), and prints no result
lines.  ``python3 chip_smoke.py --parent DIR`` runs every phase and, in
phase 4, also times the 4K ``_vli_orders`` of the checkout unpacked at
DIR (its ``dwt_tpu_torch/`` is enough, built into DIR/build), in turns
with this one's, splits its stage 1, its emit half, its tokens half and
its decode tail by pass in turns with this one's (phases 5 and 9), times
its kernel 11
on the same calls in turns with this one's at 4K (phase 6) and at 7
frames (phase 9), with each build's registers and shared memory a
block, and its kernels 14 and 15 likewise, and times its ``encode_tiled`` of the small tiles (phase 3) and
of the benchmark's 15360x8640 frame in 512x512 tiles at a third of its
lossless container (last) in turns with this one's, each container held
equal to this tree's.

Any failure raises, so the exit code is not 0 and no result line is
printed.  On success the last three lines are the kernels' JSON, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile
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
# The JAX package's pixels for two lossy decodes of that stream, made on
# the CPU with (``stream`` as above)
#   JAX_PLATFORMS=cpu python3 -c '...; from dwt_tpu.codec.decoder import
#     decode; for s, px in ((stream[:1_000_000], 0), (stream, 518400)):
#       img, _ = decode(s, px); print(img.shape,
#       hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest())'
# pixels_max=518400 caps the levels at 960x540, but the stream's layer
# schedule reaches that cap before it starts the planes of the 960x540
# level, so the decode ends at 480x270 (decode.c:136-268 semantics).
PREFIX_BYTES = 1_000_000
PREFIX_SHAPE = (2160, 3840, 3)
PREFIX_SHA256 = "2d7970b03a0a4b858b9ce877c8fffbe7e7ca6377051dc7f8f5a9398daf5b179b"
REDUCED_PIXELS = 518_400
REDUCED_SHAPE = (270, 480, 3)
REDUCED_SHA256 = "a748f357bc36c3b22fc4a54c56091b889b8518ed85d9c359f289af0e3ff85bbe"

# The JAX package's tiled containers of the same frame, made on the CPU
# with (one tile a vmapped dispatch, which bounds the host's memory and
# leaves the bytes as they are)
#   JAX_PLATFORMS=cpu python3 -c 'import hashlib, numpy as np, sys;
#     sys.path[:0] = [".", "tests"]; from imagegen import random_image;
#     from dwt_tpu.codec import tiled;
#     tiled.BatchEncoder.MAX_PIXELS_PER_DISPATCH = 512 * 512;
#     img = random_image(np.random.default_rng(0), 3840, 2160, 3, "mixed");
#     full = tiled.encode_tiled(img, tile=(512, 512));
#     cut = tiled.encode_tiled(img, tile=(512, 512), budget=len(full) // 3);
#     out, _ = tiled.decode_tiled(cut);
#     print(len(full), hashlib.sha256(full).hexdigest(), len(cut),
#           hashlib.sha256(cut).hexdigest(),
#           hashlib.sha256(np.ascontiguousarray(out).tobytes()).hexdigest())'
TILE = (512, 512)
TILED_BYTES = 12_585_953
TILED_SHA256 = "bdd73e49dcd7d2bb1561a7f893c377eddbbef51dcc982c249182111c669b4da8"
TILED_CUT_BYTES = 4_195_313  # budget 4,195,317 (a third of the above)
TILED_CUT_SHA256 = "3f1a1ac4c16b8d7edfb2505796ba188a2eab36284129a699c8cc8146e170e068"
TILED_CUT_PIXELS_SHA256 = (
    "0374a98c578c277cd5ce9ef0d5c9a7b9853bfd9b6bb906b1bda61f1ecacd7c87")
CAPACITY = 1_000_000

# BASELINE config 4, "Batch-of-64 1080p frames throughput mode": 64 RGB
# 1920x1080 frames made from seeds 0-63, through BatchEncoder.encode_batch
# (sub-batches of 7 frames).  The JAX package's 64 streams, made on the CPU
# with (one frame a vmapped dispatch, which bounds the host's memory and
# leaves the bytes as they are)
#   JAX_PLATFORMS=cpu python3 -c 'import hashlib, numpy as np, sys;
#     sys.path[:0] = [".", "tests"]; from imagegen import random_image;
#     from dwt_tpu.codec import tiled;
#     tiled.BatchEncoder.MAX_PIXELS_PER_DISPATCH = 1920 * 1080;
#     imgs = np.stack([random_image(np.random.default_rng(s), 1920, 1080, 3,
#                                   "mixed") for s in range(64)]);
#     blob = b"".join(tiled.BatchEncoder(1920, 1080, 3).encode_batch(imgs));
#     print(len(blob), hashlib.sha256(blob).hexdigest())'
BATCH_W, BATCH_H, BATCH_N = 1920, 1080, 64
BATCH_BYTES = 204_176_443
BATCH_SHA256 = (
    "a66910a2f8e1b7a47883502e7b13607d6c0fe9d8dbf2d2997599a4b2128b5983")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# Integer instructions a second of one H100 SXM: 132 SMs of 64 INT32 lanes
# at 1.98 GHz, a quarter of the data sheet's 67 TFLOP/s float32 (an FMA
# counts two there, on 128 FP32 lanes an SM).
INT32_OPS_PER_S = 67e12 / 4
# Integer operations the VLI order scan is counted for on one active
# token (a scan that knows no entry order carries all 31): its
# block's map at the 31 entry states, 8 words of four states with 5
# operations each (compare, mask, add, max, saturating subtract), and the
# replay's one state, 5 more.
VLI_OPS_PER_TOKEN = 45
CODEWORD_CHUNK = 2048  # slots a chunk sum of kernel 11
CODEWORD_NAME = "codeword_kernel"
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


ENCODE_PATHS = ("encode", "capacity encode", "tiled encode",
                "budgeted tiled encode", "sharded encode",
                "sharded tiled encode", "budgeted sharded tiled encode",
                "batch encode")
# The kernels of the encode path and their launches a sub-batch of the
# batch mode: one each; the forward transform's launches are a closed form
# of the geometry's pyramid, a launch a large level and one for the tail
# (ops/lifting.py:launch_levels; 5 at 1920x1080): ``sub_batch_launches``
# gives them.
BATCH_KERNELS = {"forward_transform": None, "plane_stats": 1,
                 "hilbert_gather": 1, "compact_tokens": 1, "pack_words": 1,
                 "scatter_refbits": 1, "vli_orders": 1, "codeword_pieces": 1,
                 "finish_tokens": 1, "packed_elems": 1, "schedule": 1,
                 "unit_tables": 1, "emit_tables": 1}
# Kernel 6, on no path: seeded tensors of the shapes the VLI order scan
# gave it (the (nblk, 128) int32 parameters in, the int8 orders back) at
# the 4K frame's token bucket and a 7-frame 1080p sub-batch's.
TRANSPOSE_SHAPES = {"4K": ((245_760, 128), (128, 245_760)),
                    "batch": ((430_080, 128), (128, 430_080))}
DECODE_PATHS = ("decode", "tiled decode", "budgeted tiled decode",
                "sharded decode")
# Small tiles whose one geometry needs two sub-batches within stage 2's
# int32 indices: 171 x 171 = 29,241 tiles of 16x16 RGB, where the pixel
# bound alone made one sub-batch of them, which the int32 check refused.
SMALL_TILE = (16, 16)
SMALL_SIDE = 2736
SMALL_SUB = 4096  # tiles a sub-batch of the reference container


def sub_batch_launches(pyr) -> dict:
    """``BATCH_KERNELS`` at a geometry: each encode kernel's launches a
    sub-batch, the forward transform's from its pyramid."""
    from dwt_tpu_torch.ops import lifting

    return {**BATCH_KERNELS,
            "forward_transform": len(lifting.launch_levels(pyr))}


def fresh(a):
    """A copy of a kernel's argument: a tensor cloned, anything else as it
    is."""
    return a.clone() if hasattr(a, "clone") else a


def max_abs_err(name: str, kernel_out, plain_out) -> int:
    """Largest difference of two integer outputs (as uint32 bit patterns),
    or of two tuples of them, part by part (a part None in both, as the
    halo launches' edge rows without neighbours, differs by 0); raises if
    their shapes or dtypes differ."""
    if kernel_out is None or plain_out is None:
        if kernel_out is not plain_out:
            raise AssertionError(f"{name}: kernel gives {kernel_out!r}, "
                                 f"plain {plain_out!r}")
        return 0
    if isinstance(kernel_out, tuple):
        if len(kernel_out) != len(plain_out):
            raise AssertionError(f"{name}: kernel gives {len(kernel_out)} "
                                 f"outputs, plain {len(plain_out)}")
        return max(max_abs_err(name, k, p)
                   for k, p in zip(kernel_out, plain_out))
    if (kernel_out.shape, kernel_out.dtype) != (plain_out.shape,
                                                plain_out.dtype):
        raise AssertionError(
            f"{name}: kernel gives {tuple(kernel_out.shape)} "
            f"{kernel_out.dtype}, plain {tuple(plain_out.shape)} "
            f"{plain_out.dtype}")
    if not kernel_out.numel():
        return 0
    return int((u32(kernel_out) - u32(plain_out)).abs().max())


class Kernels:
    """The kernel wrappers of the paths (the six kernels, the VLI order
    scan, the forward transform, the plane statistics, the codeword
    pieces, the token finisher, the packed elements, the schedule, kernel
    A's unit tables, the inverse transform, the emit half's step tables,
    the tile engines' probe and the halo levels), their sources, the TPU
    kernels (or, for kernels 8-19, the JAX code)
    they replace and the paths (``ENCODE_PATHS``, ``DECODE_PATHS``) whose
    runs must launch them."""

    def __init__(self):
        from dwt_tpu_torch.codec import decoder, emit, stage1, tokens
        from dwt_tpu_torch.ops import (codeword, compact, emit_tables,
                                       finish, hilbert_gather,
                                       hilbert_scatter, lifting, pack,
                                       plane_stats, schedule, transpose,
                                       units, vli_scan)
        from dwt_tpu_torch.ops import halo as halo_ops
        from dwt_tpu_torch.parallel import encode as sharded
        from dwt_tpu_torch.parallel import tiled as halo

        # The codec modules call the kernel wrappers by these names (the
        # sharded encoder its gather through the composed halo index, and
        # the transform only as the halo DWT's coarse tail, ``dwt2d_fwd``,
        # whose launches count on ``forward_transform``; it reaches the
        # plane statistics and the schedule through stage 1's
        # ``_stats_from_lin``; the decoders call the inverse transform by
        # ``inverse_transform``, the sharded decoder its coarse tail by
        # ``dwt2d_inv``, whose launches count on ``inverse_transform``; the
        # halo DWT its levels by ``halo_forward`` and ``halo_inverse``).
        self.sites = [(stage1, "forward_transform"),
                      (stage1, "hilbert_gather"), (stage1, "plane_stats"),
                      (tokens, "compact_tokens"),
                      (emit, "pack_words"), (emit, "scatter_refbits"),
                      (decoder, "hilbert_scatter"),
                      (tokens, "vli_orders"), (emit, "codeword_pieces"),
                      (tokens, "finish_tokens"), (tokens, "packed_elems"),
                      (stage1, "schedule"), (tokens, "unit_tables"),
                      (sharded, "hilbert_gather"), (halo, "dwt2d_fwd"),
                      (decoder, "inverse_transform"), (sharded, "dwt2d_inv"),
                      (emit, "emit_tables"), (halo, "halo_forward"),
                      (halo, "halo_inverse")]
        # Each site's kernel wrapper and its plain version.
        self.pairs = {
            "forward_transform": (lifting.forward_transform,
                                  lifting.forward_transform_plain),
            "dwt2d_fwd": (lifting.dwt2d_fwd, lifting.dwt2d_fwd_plain),
            "plane_stats": (plane_stats.plane_stats,
                            plane_stats.plane_stats_plain),
            "hilbert_gather": (hilbert_gather.hilbert_gather,
                               hilbert_gather.hilbert_gather_plain),
            "compact_tokens": (compact.compact_tokens,
                               compact.compact_tokens_plain),
            "pack_words": (pack.pack_words, pack.pack_words_plain),
            "scatter_refbits": (compact.scatter_refbits,
                                compact.scatter_refbits_plain),
            "hilbert_scatter": (hilbert_scatter.hilbert_scatter,
                                hilbert_scatter.hilbert_scatter_plain),
            "vli_orders": (vli_scan.vli_orders, vli_scan.vli_orders_plain),
            "codeword_pieces": (codeword.codeword_pieces,
                                codeword.codeword_pieces_plain),
            "finish_tokens": (finish.finish_tokens,
                              finish.finish_tokens_plain),
            "packed_elems": (finish.packed_elems, finish.packed_elems_plain),
            "schedule": (schedule.schedule, schedule.schedule_plain),
            "unit_tables": (units.unit_tables, units.unit_tables_plain),
            "inverse_transform": (lifting.inverse_transform,
                                  lifting.inverse_transform_plain),
            "dwt2d_inv": (lifting.dwt2d_inv, lifting.dwt2d_inv_plain),
            "emit_tables": (emit_tables.emit_tables,
                            emit_tables.emit_tables_plain),
            "halo_forward": (halo_ops.halo_forward,
                             halo_ops.halo_forward_plain),
            "halo_inverse": (halo_ops.halo_inverse,
                             halo_ops.halo_inverse_plain),
        }
        self.rows = [
            # Stage 1's transform, a launch a level, and its plane
            # statistics, two kernels a call.  No TPU kernel: they replace
            # the JAX package's XLA (dwt2d_fwd with rgb_to_ycocg, and
            # _plane_stats).
            ("forward_transform", lifting.forward_transform,
             "dwt_tpu_torch/csrc/lifting.cu",
             "dwt_tpu/ops/lifting.py:95", ENCODE_PATHS),
            ("plane_stats", plane_stats.plane_stats,
             "dwt_tpu_torch/csrc/plane_stats.cu",
             "dwt_tpu/codec/encoder.py:219", ENCODE_PATHS),
            ("hilbert_gather", hilbert_gather.hilbert_gather,
             "dwt_tpu_torch/csrc/hilbert_gather.cu",
             "dwt_tpu/ops/pallas_hilbert.py:284", ENCODE_PATHS),
            # The probe's count lives on engine_supported, whose one host
            # call (engine_probe) launches the gather, the scatter and a
            # compare kernel once per device, when the first encoder or
            # decoder tail is built: in this script, the encoder.
            ("engine_supported", hilbert_gather.engine_supported,
             "dwt_tpu_torch/csrc/probe.cu",
             "dwt_tpu/ops/pallas_hilbert.py:107", ("encode",)),
            ("compact_tokens", compact.compact_tokens,
             "dwt_tpu_torch/csrc/compact.cu",
             "dwt_tpu/ops/pallas_compact.py:404", ENCODE_PATHS),
            ("pack_words", pack.pack_words,
             "dwt_tpu_torch/csrc/pack.cu",
             "dwt_tpu/ops/pallas_pack.py:235", ENCODE_PATHS),
            ("scatter_refbits", compact.scatter_refbits,
             "dwt_tpu_torch/csrc/compact.cu",
             "dwt_tpu/ops/pallas_compact.py:548", ENCODE_PATHS),
            ("hilbert_scatter", hilbert_scatter.hilbert_scatter,
             "dwt_tpu_torch/csrc/hilbert_scatter.cu",
             "dwt_tpu/ops/pallas_hilbert.py:538", DECODE_PATHS),
            # Kernel 6: no path runs it (nor the JAX package's), since
            # the VLI order scan reads the token arrays in place.
            ("transpose2d", transpose.transpose2d,
             "dwt_tpu_torch/csrc/transpose.cu",
             "dwt_tpu/ops/pallas_transpose.py:57", ()),
            # The VLI order scan: one kernel a call.  No
            # TPU kernel: it replaces the JAX package's XLA scan.
            ("vli_orders", vli_scan.vli_orders,
             "dwt_tpu_torch/csrc/vli_scan.cu",
             "dwt_tpu/codec/encoder.py:745", ENCODE_PATHS),
            # Kernel 11, the codeword pieces: one kernel a sub-batch.  No
            # TPU kernel: it replaces the JAX package's XLA
            # _codeword_contribs.
            ("codeword_pieces", codeword.codeword_pieces,
             "dwt_tpu_torch/csrc/codeword.cu",
             "dwt_tpu/codec/encoder.py:874", ENCODE_PATHS),
            # Kernels 12 and 13, the token finisher and the packed
            # elements: one call a sub-batch each.  No TPU kernel: they
            # replace the JAX package's XLA _finish_tokens and
            # _packed_elems.
            ("finish_tokens", finish.finish_tokens,
             "dwt_tpu_torch/csrc/finish.cu",
             "dwt_tpu/codec/encoder.py:654", ENCODE_PATHS),
            ("packed_elems", finish.packed_elems,
             "dwt_tpu_torch/csrc/finish.cu",
             "dwt_tpu/codec/encoder.py:505", ENCODE_PATHS),
            # Kernels 14 and 15, the schedule (level sums, step order,
            # carry chain and token bases; one cluster launch) and kernel
            # A's unit tables: one call a sub-batch each.  No TPU kernel:
            # they replace the JAX package's XLA in _stats_from_lin after
            # the plane statistics, and _unit_common with _kernel_a_meta.
            ("schedule", schedule.schedule,
             "dwt_tpu_torch/csrc/schedule.cu",
             "dwt_tpu/codec/encoder.py:355", ENCODE_PATHS),
            ("unit_tables", units.unit_tables,
             "dwt_tpu_torch/csrc/units.cu",
             "dwt_tpu/codec/encoder.py:521", ENCODE_PATHS),
            # Kernel 16, the inverse transform (a launch for the coarse
            # tail and one a larger level, the colour, clamps and cast as
            # the finest level stores).  No TPU kernel: it replaces the
            # JAX package's XLA dwt2d_inv with ycocg_to_rgb and the clip
            # and cast of _tail_fn (dwt_tpu/codec/decoder.py:109-112).
            ("inverse_transform", lifting.inverse_transform,
             "dwt_tpu_torch/csrc/lifting_inv.cu",
             "dwt_tpu/ops/lifting.py:112, dwt_tpu/ops/color.py:26",
             DECODE_PATHS),
            # Kernel 17, the emit half's step tables (one launch: a
            # group of threads a frame, several a block for small frames,
            # several blocks for large ones): one call a sub-batch.  No
            # TPU kernel: it replaces the JAX package's XLA tail of
            # _codeword_contribs, _bit_partials, _kernel_b_meta and
            # _layer_boundaries.
            ("emit_tables", emit_tables.emit_tables,
             "dwt_tpu_torch/csrc/emit_tables.cu",
             "dwt_tpu/codec/encoder.py:916, :1000, :1018, :844",
             ENCODE_PATHS),
            # Kernels 18 and 19, the halo levels of the row-sharded
            # transform (up to three launches a level; at world size 1 the
            # two finest levels in one launch, one a level after them).
            # No TPU kernel: they replace the JAX package's XLA
            # halo_dwt2d_fwd and halo_dwt2d_inv inside shard_map, with the
            # colour of sharded_lin and the ShardedDecoder's inverse.
            ("halo_forward", halo_ops.halo_forward,
             "dwt_tpu_torch/csrc/halo_lifting.cu",
             "dwt_tpu/parallel/tiled.py:168, :62, "
             "dwt_tpu/parallel/encode.py:60-76", ("sharded encode",)),
            ("halo_inverse", halo_ops.halo_inverse,
             "dwt_tpu_torch/csrc/halo_lifting.cu",
             "dwt_tpu/parallel/tiled.py:297, :86, "
             "dwt_tpu/parallel/encode.py:172-200", ("sharded decode",)),
        ]

    def reset(self) -> None:
        for _, fn, _, _, _ in self.rows:
            fn.launches = 0

    def counts(self) -> dict:
        return {name: fn.launches for name, fn, _, _, _ in self.rows}

    def check_launched(self, path: str, counts: dict,
                       exempt: tuple = ()) -> None:
        idle = [name for name, _, _, _, paths in self.rows
                if path in paths and counts[name] <= 0
                and name not in exempt]
        if idle:
            raise AssertionError(
                f"kernels never launched on the {path} path: {idle}")

    @contextlib.contextmanager
    def capture(self, store: dict):
        """Keep a copy of each kernel's inputs while a path runs: under the
        kernel's name, one tuple of arguments for each distinct set of
        tensor shapes and dtypes (and modes, for the halo levels) the path
        gives it, in call order (the first call of each)."""
        sites = self.sites
        saved = [getattr(mod, name) for mod, name in sites]
        seen = set()

        def keeper(name, fn):
            # Keeps the positional arguments only: the encoder passes the
            # pack kernel's order flag by keyword, and a held call checks
            # the order itself.
            def run(*args, **kwargs):
                key = (name,) + tuple(
                    (tuple(a.shape), a.dtype) if hasattr(a, "shape") else a
                    for a in args if hasattr(a, "shape")
                    or isinstance(a, str))
                if key not in seen:
                    seen.add(key)
                    store.setdefault(name, []).append(tuple(
                        fresh(a) for a in args))
                return fn(*args, **kwargs)
            return run

        for (mod, name), fn in zip(sites, saved):
            setattr(mod, name, keeper(name, fn))
        try:
            yield
        finally:
            for (mod, name), fn in zip(sites, saved):
                setattr(mod, name, fn)

    def hold(self, store: dict) -> dict:
        """Run each kept call of ``store`` again through its kernel and its
        plain version (fresh copies of the arguments: kernel B works in
        place) and raise unless they are equal.  Returns {kernel: calls
        held}."""
        import torch

        for name, calls in store.items():
            kernel, plain = self.pairs[name]
            if name == "emit_tables":
                emit_in_order(torch, calls)
            for args in calls:
                err = max_abs_err(name, kernel(*map(fresh, args)),
                                  plain(*map(fresh, args)))
                if err != 0:
                    shapes = [tuple(a.shape) for a in args
                              if hasattr(a, "shape")]
                    raise AssertionError(
                        f"{name} at {shapes}: kernel differs from its plain "
                        f"version (max abs err {err})")
        return {name: len(calls) for name, calls in store.items()}

    @contextlib.contextmanager
    def path(self, name: str, store: dict, counts: dict,
             exempt: tuple = ()):
        """Run a path with the launch counts set to 0 before it and read
        into ``counts`` after it, and its kernel inputs kept in ``store``;
        raise if a kernel of the path (but those in ``exempt``, which this
        run of it has no work for) was never launched."""
        import torch

        self.reset()
        with self.capture(store):
            yield
        torch.cuda.synchronize()
        counts.update(self.counts())
        self.check_launched(name, counts, exempt)


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


# The kernels that kernel_events found in a wrong count in all three of
# its sessions: {name matched: the count each session saw}.
PROFILER_MISSES: dict = {}


def kernel_events(torch, fn, match: str, n: int = 10,
                  per_call: int = 0) -> list:
    """[(name, device us)] of the kernels whose name holds ``match`` in
    ``n`` calls of ``fn()`` after a warm one, in launch order, from
    torch.profiler: the card's own time, without the host's launch time
    that ``time_ms`` includes.  None when the profiler records no such
    kernel, or a count of them other than ``per_call`` a call (where
    given) or one that ``n`` calls cannot make, in three sessions: it
    dropped some."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and match in e.name), key=lambda e: e.time_range.start)
        if ev and not len(ev) % n and (not per_call
                                       or len(ev) == per_call * n):
            return [(e.name, e.time_range.elapsed_us()) for e in ev]
        seen.append(len(ev))
    PROFILER_MISSES[match] = seen
    return None  # none, or some dropped by the profiler


def kernel_ms(torch, fn, match: str, n: int = 10, per_call: int = 0) -> float:
    """Device ms of the kernels whose name holds ``match`` in one
    ``fn()``, summed (``kernel_events`` over ``n`` calls); NaN (not
    measured) where the profiler dropped some."""
    ev = kernel_events(torch, fn, match, n, per_call)
    return float("nan") if ev is None else sum(t for _, t in ev) / 1e3 / n


def launch_ms(torch, fn, match: str, per_call: int, n: int = 20) -> list:
    """[(kernel, device ms)] of each of the ``per_call`` launches whose
    name holds ``match`` in one ``fn()``, in launch order, means of ``n``
    calls (``kernel_events``); None where the profiler dropped some."""
    ev = kernel_events(torch, fn, match, n, per_call)
    if ev is None:
        return None
    return [(ev[i][0].split("(")[0].split("<")[0].split()[-1],
             sum(ev[r * per_call + i][1] for r in range(n)) / n / 1e3)
            for i in range(per_call)]


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


def fmt_split(parts: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in parts.items())


def wrapper_split_a(torch, vmag, meta, npairs, table) -> str:
    """Kernel A's wrapper in its parts, by CUDA events: the zero fill of
    the pair buffer, the count launch and the place launch (on the kept
    buffers; the unit table is kernel 15's, timed in its own row)."""
    from dwt_tpu_torch.ops import compact

    out = torch.zeros(npairs, dtype=torch.int32, device=vmag.device)
    hist = compact.hist_for(table)
    return fmt_split(dict(
        fill=time_ms(torch, lambda: torch.zeros(npairs, dtype=torch.int32,
                                                device=vmag.device)),
        count=time_ms(torch, lambda: compact.count(vmag, meta, table, hist)),
        place=time_ms(torch, lambda: compact.place(vmag, meta, table, hist,
                                                   out))))


def wrapper_split_pack(torch, widx, c0, c1, c2, nwords) -> str:
    """The pack wrapper in its parts: the zero fill of the word buffer and
    the kernel launch by CUDA events, and the order check (a read of the
    kernel's flag, a host sync, which the encoder folds into its copy of
    the bit counts) by the host clock after a synchronise."""
    from dwt_tpu_torch.ops import pack

    words = torch.zeros(nwords, dtype=torch.int32, device=widx.device)
    flag = torch.zeros(1, dtype=torch.int32, device=widx.device)
    kernel = time_ms(torch, lambda: pack.launch(widx, c0, c1, c2, words,
                                                flag))
    reads = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pack.check_order(flag)
        reads.append(1e3 * (time.perf_counter() - t0))
    return fmt_split(dict(
        fill=time_ms(torch, lambda: torch.zeros(nwords, dtype=torch.int32,
                                                device=widx.device)),
        check=sum(reads) / len(reads), kernel=kernel))


def wrapper_split_b(torch, vmag, meta, words, table, hist) -> str:
    """Kernel B's wrapper in its parts, by CUDA events: the unit table it
    derives on the host when it is given none, the count launch it runs
    when it is given no histograms, and the scatter launch (on the kept
    buffers; the encoder passes kernel A's table and histograms)."""
    from dwt_tpu_torch.ops import compact

    own = compact.hist_for(table)
    return fmt_split(dict(
        table=time_ms(torch, lambda: compact.unit_table(meta)),
        count=time_ms(torch, lambda: compact.count(vmag, meta, table, own)),
        scatter=time_ms(torch, compact.scatter, setup=lambda: (
            vmag, meta, table, hist, words.clone()))))


def refbit_counts(torch, vmag, meta, words, table, hist) -> str:
    """Kernel B's refinement bits, how many of them are 1 (each was one
    global atomic of a kernel that adds bit by bit), and its block runs
    (a (chunk, sub-range, plane) with a bit to write: at most two global
    atomics each), from the same histograms as the kernel."""
    from dwt_tpu_torch.ops import compact

    live = meta[:, 6] > 0
    nref = int(meta[live, 6].long().sum())
    ones = compact.scatter_refbits(vmag, meta, torch.zeros_like(words),
                                   table, hist).long() & 0xFFFFFFFF
    nones = 0
    for i in range(32):
        nones += int(((ones >> i) & 1).sum())
    # Lane b of a group: the unit of table slot b - 1 (refined: key > b).
    G, P = table.shape
    rows = table.long()
    ok = (rows >= 0) & (rows < meta.shape[0])
    m = meta.long()[rows.clamp(0, meta.shape[0] - 1)]     # (G, P, 8)
    cnt = torch.where(ok, m[..., 6], 0)                     # (G, P)
    first = torch.argmax((cnt > 0).int(), dim=1)            # first live
    ln = m[torch.arange(G, device=m.device), first, 1].clamp(0, compact.E)
    ln = torch.where((cnt > 0).any(1), ln, 0)
    nsub = hist.shape[1]
    inside = (torch.arange(nsub, device=m.device)[None, :]
              * compact.SUBLEN) < ln[:, None]               # (G, nsub)
    h = torch.where(inside[..., None], hist[:, :, 0, :31].long(), 0)
    above = h.flip(-1).cumsum(-1).flip(-1)                   # keys >= j
    nrun = torch.cat([above[..., 1:], torch.zeros_like(above[..., :1])],
                     dim=-1)[..., 1:P + 1]                   # keys > b
    rank0 = torch.cumsum(nrun, dim=1) - nrun
    ncap = torch.minimum((cnt[:, None, :] - rank0).clamp(min=0), nrun)
    runs = int(((ncap > 0) & inside[..., None]).sum())
    return (f"{nref} refinement bits, {nones} of them 1; {runs} block runs "
            f"(at most {2 * runs} global atomics)")


def scatter_bytes(lin, src, sq_ptr, runs) -> int:
    """The bytes kernel 5 must move: its index, the run table and the
    coefficients of the valid pixels read once, the plane written once."""
    valid = int(((src >= 0) & (src < lin.shape[1])).sum())
    return 4 * (src.numel() + sq_ptr.numel() + runs.numel()
                + lin.shape[0] * (valid + src.numel()))


SCATTER_NAME = "hilbert_scatter_kernel"
SCATTER_GROUPS = (3, 6, 12, 24)  # channel groups timed on the tile shapes


def scatter_at_tiles(torch, calls: list) -> None:
    """Kernel 5 at the tiled decode's kept calls (one a tile geometry, N
    tiles as N*C channels), as the tail calls it, beside its bound; each
    call also held to the plain version at every channel group of
    ``SCATTER_GROUPS`` (``hilbert_scatter.GROUP`` is the wrapper's)."""
    from dwt_tpu_torch.ops import hilbert_scatter as hs

    for lin, src, sq_ptr, runs in calls:
        p = hs.hilbert_scatter_plain(lin, src)
        out = torch.empty_like(p)
        for g in SCATTER_GROUPS:
            out.fill_(-1)
            hs.launch(lin, src, sq_ptr, runs, out, g)
            if max_abs_err("hilbert_scatter", out, p):
                raise AssertionError(f"hilbert_scatter with channel group "
                                     f"{g} differs from its plain version")
        ms = time_ms(torch, lambda: hs.hilbert_scatter(lin, src, sq_ptr,
                                                       runs))
        bound = scatter_bytes(lin, src, sq_ptr, runs) / HBM_BYTES_PER_S * 1e3
        progress(f"kernels: hilbert_scatter tiled {tuple(lin.shape)} -> "
                 f"{tuple(p.shape)} equal to its plain version at channel "
                 f"groups {SCATTER_GROUPS}; {ms:.4f} ms (group {hs.GROUP}), "
                 f"bound {bound:.4f} ms, share {bound / ms:.2f}")


def transpose_routes(torch, x, want) -> None:
    """The int8 transpose of ``x`` by both kernels of ``csrc/transpose.cu``:
    the byte kernel (16 bytes a thread) and the element kernel (one byte a
    thread: the int8 kernel before the byte kernel), each held to
    ``want``."""
    from dwt_tpu_torch.ops import transpose

    for vec in sorted({transpose.vector_bytes(x), 1}, reverse=True):
        out = torch.zeros_like(want)
        transpose.launch(x, out, vec)
        if max_abs_err("transpose2d", out, want):
            raise AssertionError(f"transpose2d at {vec} bytes a thread "
                                 f"differs from its plain version")


VLI_NAME = "vli_orders_kernel"
# Stage 1's kernels by wrapper, as the profiler names them.
STAGE1_NAMES = {"forward_transform": ("lift_level_kernel",
                                      "lift_tail_kernel"),
                "plane_stats": ("plane_stats_kernel",)}


def stage1_device(torch, kept: dict, rows: list, key: str) -> str:
    """Each stage-1 kernel's device time (torch.profiler) on its kept
    call ``kept[wrapper]``, into ``rows[...][key]`` (the wrapper's kernels
    summed); returns a line of them beside their bounds."""
    from dwt_tpu_torch.ops import lifting, plane_stats

    fns = {"forward_transform": lifting.forward_transform,
           "plane_stats": plane_stats.plane_stats}
    pyr = kept["forward_transform"][1]
    tail = lifting.tail_level(pyr) > 0
    per_call = {"lift_level_kernel": len(lifting.launch_levels(pyr)) - tail,
                "lift_tail_kernel": int(tail), "plane_stats_kernel": 1}
    parts = []
    for name, kernels in STAGE1_NAMES.items():
        args = kept[name]
        ms = [kernel_ms(torch, lambda: fns[name](*args), k,
                        per_call=per_call[k]) for k in kernels]
        bound, by = bound_of(*kernel_work(torch, name, args))
        next(r for r in rows if r["name"] == name)[key] = sum(ms)
        parts.append(f"{name} {tuple(args[0].shape)}: " + ", ".join(
            f"{k} {m:.4f} ms" for k, m in zip(kernels, ms))
            + f"; bound {bound:.4f} ms by {by}, share {bound / sum(ms):.2f}")
    return "; ".join(parts)


# Kernel 17's kernel, as the profiler names it.
EMIT_NAMES = ("emit_tables_kernel",)
# Kernels 12-15 and 17 by wrapper, as the profiler names them.
TOKENS_NAMES = {"finish_tokens": ("finish_dense_kernel",
                                  "finish_special_kernel"),
                "packed_elems": ("packed_elems_kernel",),
                "schedule": ("schedule_kernel",),
                "unit_tables": ("units_kernel",),
                "emit_tables": EMIT_NAMES}


def tokens_kept(store: dict) -> dict:
    """The first kept call of each of kernels 12-15 and 17 (kernel 12's
    pairs laid out again in a pair buffer's rows)."""
    return {"finish_tokens": as_pair_buffer(store["finish_tokens"][0]),
            **{k: store[k][0] for k in ("packed_elems", "schedule",
                                        "unit_tables", "emit_tables")}}


def tokens_device(torch, kept: dict, rows: list, key: str) -> str:
    """Kernels 12-15 and 17's device time (torch.profiler) on their kept
    calls ``kept[wrapper]``, into ``rows[...][key]`` (the wrapper's
    kernels summed); returns a line of them beside their bounds."""
    from dwt_tpu_torch.ops import emit_tables, finish, schedule, units

    fns = {"finish_tokens": finish.finish_tokens,
           "packed_elems": finish.packed_elems,
           "schedule": schedule.schedule, "unit_tables": units.unit_tables,
           "emit_tables": emit_tables.emit_tables}
    parts = []
    for name, kernels in TOKENS_NAMES.items():
        args = kept[name]
        ms = [kernel_ms(torch, lambda: fns[name](*args), k, per_call=1)
              for k in kernels]
        bound, by = bound_of(*kernel_work(torch, name, args))
        next(r for r in rows if r["name"] == name)[key] = sum(ms)
        parts.append(f"{name} {tuple(args[0].shape)}: " + ", ".join(
            f"{k} {m:.4f} ms" for k, m in zip(kernels, ms))
            + f"; bound {bound:.4f} ms by {by}, share {bound / sum(ms):.2f}")
    return "; ".join(parts)


def device_times(torch, scatter_4k, tiled_scatter, transposes,
                 vli, stage1_kept, codeword_args, tokens_kept, rows,
                 parent: str | None) -> None:
    """Phase 6: the device time of kernels 5 and 6 by torch.profiler (the
    card's own time, without the host's launch time that the kernels
    phase's CUDA events include), beside their bounds: kernel 5 at 4K and
    at the tiled decode's calls, there also at each channel group of
    ``SCATTER_GROUPS``; kernel 6 on its seeded 4K tensors, the int8 one
    also by the element kernel; the VLI order scan's kernel, stage 1's
    kernels and kernels 12-15 and 17 at 4K (into ``rows``), kernel 11 in
    turns with the ``parent`` checkout's where one is given.  Run last, so that no
    profiler session comes before the timing phase that a parent's script
    would not run either."""
    from dwt_tpu_torch.ops import hilbert_scatter as hs
    from dwt_tpu_torch.ops import transpose

    for i, (lin, src, sq_ptr, runs) in enumerate([scatter_4k]
                                                 + tiled_scatter):
        out = torch.empty((*src.shape, lin.shape[0]), dtype=torch.int32,
                          device=lin.device)
        groups = ", ".join(
            f"{g}: " + format(kernel_ms(torch, lambda g=g: hs.launch(
                lin, src, sq_ptr, runs, out, g), SCATTER_NAME), ".4f")
            for g in (SCATTER_GROUPS if i else ()))
        dev = kernel_ms(torch, lambda: hs.hilbert_scatter(lin, src, sq_ptr,
                                                          runs), SCATTER_NAME)
        bound = scatter_bytes(lin, src, sq_ptr, runs) / HBM_BYTES_PER_S * 1e3
        progress(f"device: hilbert_scatter {'tiled ' if i else '4K '}"
                 f"{tuple(lin.shape)} -> {tuple(out.shape)}: {dev:.4f} ms "
                 f"(group {hs.GROUP}), bound {bound:.4f} ms, share "
                 f"{bound / dev:.2f}"
                 + (f"; by channel group, ms: {groups}" if groups else ""))
    # Kernel 5 at the shape of the 16K tiled decode's 480-tile group: the
    # 4K tiled decode's 512x512 call with its rows (tiles x channels)
    # scaled to 480 tiles (``scatter_bytes`` is linear in them).
    lin, src, sq_ptr, runs = next(c for c in tiled_scatter
                                  if tuple(c[1].shape) == (512, 512))
    valid = int(((src >= 0) & (src < lin.shape[1])).sum())
    group = 4 * (src.numel() + sq_ptr.numel() + runs.numel()
                 + 480 * 3 * (valid + src.numel()))
    progress(f"device: hilbert_scatter at the 16K decode's 480 512x512 tile "
             f"group ({480 * 3} rows, scaled from the 4K tiled decode's "
             f"{lin.shape[0]}): {group} bytes, bound "
             f"{bound_of(group)[0]:.4f} ms")
    wrapper_ms = 0.0
    for x in transposes:
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        routes = []
        for vec in sorted({transpose.vector_bytes(x), 1}, reverse=True):
            out = torch.empty(x.shape[::-1], dtype=x.dtype, device=x.device)
            ms = kernel_ms(torch, lambda: transpose.launch(x, out, vec),
                           "transpose")
            wrapper_ms += ms if vec == transpose.vector_bytes(x) else 0.0
            routes.append(f"{vec} bytes a thread {ms:.4f} ms, share "
                          f"{bound / ms:.2f}")
        progress(f"device: transpose2d {tuple(x.shape)} {x.dtype}, bound "
                 f"{bound:.4f} ms: {'; '.join(routes)} (1 byte a thread: "
                 f"the element kernel)")
    next(r for r in rows if r["name"] == "transpose2d")["device_ms"] = \
        wrapper_ms
    progress("device: " + vli_device(torch, *vli, rows, "device_ms"))
    progress("device: stage 1 at 4K: " + stage1_device(torch, stage1_kept,
                                                      rows, "device_ms"))
    progress("device: " + codeword_device(torch, codeword_args, rows,
                                          "device_ms", parent))
    progress("device: kernels 12-15 and 17 at 4K: " + tokens_device(
        torch, tokens_kept, rows, "device_ms"))
    progress("device: kernels 14 and 15 at 4K, in turns: "
             + schedule_turns(torch, tokens_kept, parent))


def vli_device(torch, val, vli, rows: list, key: str) -> str:
    """The VLI order scan kernel's device time (torch.profiler) on (N, T)
    tokens, into ``rows[...][key]``; returns a line of it beside its
    bound."""
    from dwt_tpu_torch.ops import vli_scan

    ms = kernel_ms(torch, lambda: vli_scan.vli_orders(val, vli), VLI_NAME,
                   per_call=1)
    bound, by = bound_of(*vli_work(torch, val, vli))
    next(r for r in rows if r["name"] == "vli_orders")[key] = ms
    return (f"vli_orders {tuple(val.shape)} (row stride {val.stride(0)}): "
            f"{ms:.4f} ms, bound {bound:.4f} ms by {by}, share "
            f"{bound / ms:.2f}")


def vli_collapse(torch, val, vli) -> str:
    """How the VLI order scan's rows (``SPAN`` tokens of a tile) and tiles
    (``TILE`` tokens of a frame) collapse on (N, T) tokens: the rows
    whose map at all 31 entry orders is a constant by their end, the
    median and largest token count after which it became one, and the
    tiles whose map, the rows' composed, is a constant (plain PyTorch on
    the card, from ``tokens._vli_ab``)."""
    from dwt_tpu_torch.codec import tokens
    from dwt_tpu_torch.ops import vli_scan as V

    N, T = val.shape
    per = -(-T // V.TILE)
    x = torch.zeros((N, per * V.TILE), dtype=torch.int32, device=val.device)
    x[:, :T] = tokens._vli_ab(val, vli)
    rows = x.reshape(-1, V.SPAN)
    a, b, act = (rows - 1) & 31, ((rows - 1) >> 5) & 31, rows > 0
    s = torch.arange(31, dtype=torch.int32,
                     device=val.device).expand(rows.shape[0], 31)
    at = torch.full((rows.shape[0],), V.SPAN + 1, dtype=torch.int32,
                    device=val.device)
    for i in range(V.SPAN):
        ns = torch.clamp(torch.maximum(s, a[:, i:i + 1] + (
            s >= b[:, i:i + 1]).to(torch.int32)) - 2, 0, 30)
        s = torch.where(act[:, i:i + 1], ns, s)
        at = torch.where((at > V.SPAN) & (s[:, 0] == s[:, 30]), i + 1, at)
    done = at <= V.SPAN
    maps = s.long().reshape(-1, V.THREADS, 31)
    F = torch.arange(31, device=val.device).expand(maps.shape[0], 31)
    for r in range(V.THREADS):
        F = torch.gather(maps[:, r], 1, F)
    tiles = int((F[:, 0] == F[:, 30]).sum())
    real = at[done].float()
    return (f"{int(done.sum())} of {rows.shape[0]} rows of {V.SPAN} tokens "
            f"collapsed ({float(done.float().mean()):.4f}), after a median "
            f"of {float(real.median()) if real.numel() else float('nan')} "
            f"tokens, at most {int(at[done].max()) if real.numel() else 0}; "
            f"{tiles} of {maps.shape[0]} tiles of {V.TILE} tokens with a "
            f"constant map")


def as_pair_buffer(args: tuple) -> tuple:
    """A kept call of kernel 12 with its (N, npair) pairs laid out again
    as kernel A leaves them, the rows of a pair buffer (row stride npair +
    ``compact.WTOK_BIG`` + 256): a kept call holds a contiguous copy."""
    from dwt_tpu_torch.ops import compact

    pairs = args[0]
    n, npair = pairs.shape
    buf = pairs.new_zeros((n, npair + compact.WTOK_BIG + 256))
    buf[:, :npair] = pairs
    return (buf[:, :npair],) + tuple(args[1:])


def parent_module(root: str, name: str):
    """Module ``name`` (as "codec.encoder") of the ``dwt_tpu_torch``
    package of the checkout at ``root``, loaded once by
    :func:`load_tree`."""
    import importlib

    if "parent_dwt_tpu_torch" not in sys.modules:
        load_tree(root)
    return importlib.import_module(f"parent_dwt_tpu_torch.{name}")


def load_tree(root: str):
    """``codec.tokens`` of the ``dwt_tpu_torch`` package of the checkout
    at ``root``, imported as ``parent_dwt_tpu_torch`` (its kernels built
    into ``root/build``)."""
    import importlib

    pkg = os.path.join(os.path.abspath(root), "dwt_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_dwt_tpu_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_dwt_tpu_torch.codec.tokens")


def bound_of(nbytes: int, ops: int = 0) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the integer operations over the INT32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes,
                                                             "bytes")


def vli_work(torch, val, vli) -> tuple:
    """(bytes, integer operations) the VLI order scan must spend on its
    (N, T) int32 values and bool flags: both read once and the int32
    orders written once (9 bytes a token), and ``VLI_OPS_PER_TOKEN`` a
    token that is a VLI value (the others are no-ops)."""
    return 9 * val.numel(), VLI_OPS_PER_TOKEN * int(vli.sum())


def transform_work(torch, args) -> tuple:
    """(bytes, integer operations) the forward transform must spend on its
    (N, H, W, C) frames: the frames read once and the int32 coefficients
    written once.  Its integer work, about 14 operations a sample over all
    levels, takes less time at the INT32 rate than those bytes, and is not
    counted."""
    x = args[0]
    return x.numel() * (x.element_size() + 4), 0


def inverse_work(torch, args) -> tuple:
    """(bytes, integer operations) kernel 16 must spend on its (N, H, W, C)
    int32 coefficients (the root band from its root view where one is
    given): read once, the bias table read once, and the image (uint8, or
    int32) written once.  Its integer work, about 14 operations a sample
    over all levels, takes less time at the INT32 rate than those bytes,
    and is not counted."""
    x, to_bytes = args[0], args[3]
    bias = args[4] if len(args) > 4 else None
    return (x.numel() * (4 + (1 if to_bytes else 4))
            + (0 if bias is None else 4 * bias.numel())), 0


def ll_bytes(args) -> int:
    """The bytes kernel 16's LL buffers move between its launches: each
    launch's output but the last, int32, written once and read once."""
    from dwt_tpu_torch.ops import lifting

    x, chain = args[0], args[1]
    n, c = x.shape[0], x.shape[3]
    return sum(8 * n * c * chain[p.levels[-1] - 1][0]
               * chain[p.levels[-1] - 1][1]
               for p in lifting.plan_of(*args[:4])[:-1])


def decoder_args(torch, gen, n: int, h: int, w: int, c: int) -> tuple:
    """Seeded arguments of kernel 16 as the decoder hands them over: the
    (N, H, W, C) view of an (H, W, N, C) tensor (the scatter's output, 0
    on the root band), the pyramid's chain, colour and cast, a bias table
    of planes missing on several levels, by frame and channel, and the
    root band as a view of an (N, C, total) buffer."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    pyr = compute_pyramid(w, h)
    h0, w0 = pyr.heights[0], pyr.widths[0]
    x = torch.randint(-700, 700, (h, w, n, c), dtype=torch.int32,
                      device="cuda", generator=gen)
    x[:h0, :w0] = 0
    lin = torch.randint(-700, 700, (n, c, h0 * w0 + 5), dtype=torch.int32,
                        device="cuda", generator=gen)
    missing = torch.randint(0, 7, (n, c, 16), device="cuda", generator=gen)
    bias = torch.where(missing >= 2, 1 << (missing - 2).clamp(min=0), 0).to(
        torch.int32)
    return (x.permute(2, 0, 1, 3), lifting.pyramid_chain(pyr), c == 3, True,
            bias, lin[..., :h0 * w0].unflatten(2, (h0, w0)).permute(
                0, 2, 3, 1))


def plane_stats_work(torch, args) -> tuple:
    """(bytes, integer operations) the plane statistics must spend on
    their arguments: each row's detail elements read once (4 bytes), the
    pad mask once, the tables written once (int32); and one compare for
    each element and each plane up to its 512-element block's top plane,
    the cumulative counts that the boundary-prefix count is summed from
    (on this data)."""
    from dwt_tpu_torch.ops import plane_stats as ps

    lin, valid, _, _, _, chunk_base = args
    R, n, nchunk = lin.shape[0], valid.numel(), chunk_base.numel()
    nbytes = 4 * R * n + n + 4 * (R * nchunk * (3 * ps.PMAX + 1) + R)
    q = ps.detail_q(lin[:, lin.shape[1] - n:], valid)
    top = q.reshape(R, -1, 512).amax(dim=2).clamp(max=ps.PMAX)
    ops = 512 * int((top.long() + 1).sum())
    return nbytes, ops


def codeword_work(torch, args) -> tuple:
    """(bytes, integer operations) kernel 11 must spend on its arguments:
    each slot's value, raw length, order (4 bytes each) and flag (1) read
    once, its offset, word index and three pieces (4 bytes each) written
    once, each 2048-slot chunk sum written once and the (N, S) step tables
    read once.  Its few integer operations a slot take less time at the
    INT32 rate than those bytes, and are not counted."""
    val, site = args[0], args[4]
    nchunk = val.shape[0] * -(-val.shape[1] // CODEWORD_CHUNK)
    return 33 * val.numel() + 4 * nchunk + 8 * site.numel(), 0


def cumsum_line(torch, args) -> str:
    """Kernel 11's yardstick for its scan alone: ``torch.cumsum`` of the
    call's (N, T) int32 codeword lengths along the rows, by CUDA events."""
    from dwt_tpu_torch.ops import codeword

    val, raw, vli, orders = args[:4]
    v, s = val.long(), orders.long()
    k = (codeword._ilog2(v + (torch.ones_like(s) << s)) - s).clamp(min=0)
    lengths = torch.where(vli, 2 * k + s + 1, raw.long()).to(torch.int32)
    ms = time_ms(torch, lambda: torch.cumsum(lengths, dim=1))
    return f"torch.cumsum of its int32 lengths alone {ms:.4f} ms"


def codeword_device(torch, args, rows: list, key: str,
                    parent: str | None) -> str:
    """Kernel 11's device time (torch.profiler) on its kept call ``args``,
    into ``rows[...][key]`` (the mean of this tree's readings); where
    ``parent`` names a checkout, its kernel on the same call in turns
    (this tree, the parent, the parent, this tree), each call held equal
    to this tree's.  Returns a line of the times beside the bound, with
    each tree's registers and shared memory a block from its build."""
    from dwt_tpu_torch.ops import codeword

    trees, order = {"this tree": codeword}, ["this tree"]
    if parent:
        trees["parent"] = parent_module(parent, "ops.codeword")
        order = ["this tree", "parent", "parent", "this tree"]
    want = codeword.codeword_pieces(*args)
    times: dict = {}
    for name in order:
        fn = trees[name].codeword_pieces
        if not all(torch.equal(g, w) for g, w in zip(fn(*args), want)):
            raise AssertionError(f"codeword_pieces of {name} differs")
        times.setdefault(name, []).append(kernel_ms(
            torch, lambda: fn(*args), CODEWORD_NAME, per_call=1))
    ms = sum(times["this tree"]) / len(times["this tree"])
    bound, by = bound_of(*codeword_work(torch, args))
    next(r for r in rows if r["name"] == "codeword_pieces")[key] = ms
    sms, per_sm, smem = codeword._plan_for(args[0], args[4].shape[1])
    return (f"codeword_pieces {tuple(args[0].shape)} (row stride "
            f"{args[0].stride(0)}), bound {bound:.4f} ms by {by}: "
            + "; ".join(f"{k} " + ", ".join(
                f"{m:.4f} ms (share {bound / m:.2f})" for m in v)
                for k, v in times.items())
            + f"; this tree {per_sm} blocks an SM x {sms} SMs, "
            f"{smem} B dynamic shared memory a block, "
            + codeword_resources(None)
            + (f"; parent {codeword_resources(parent)}" if parent
               else " (no --parent given)"))


def codeword_resources(root: str | None) -> str:
    """The registers a thread, stack and local bytes, and static shared
    memory a block of kernel 11 as built for the checkout at ``root``
    (this one when None), read from its library by ``cuobjdump
    -res-usage``; "not read" where that fails."""
    import re

    from dwt_tpu_torch.runtime import build

    mod = build if root is None else parent_module(root, "runtime.build")
    exe = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    try:
        out = subprocess.run([exe, "-res-usage", str(mod.library_path())],
                             capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"resources not read ({e})"
    m = re.search(r"Function \S*" + CODEWORD_NAME + r"\S*:\s*REG:(\d+) "
                  r"STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", out)
    if not m:
        return "resources not read (no such function in cuobjdump's output)"
    reg, stack, shared, local = m.groups()
    return (f"{reg} registers a thread, {shared} B static shared memory, "
            f"stack {stack} B, local {local} B")


def kernel_work(torch, name: str, args) -> tuple:
    """(bytes, integer operations) of one call of an encode kernel: the
    operations count only for the VLI order scan and the plane
    statistics, whose bound they may set; the others are bound by their
    bytes."""
    if name == "vli_orders":
        return vli_work(torch, *args)
    if name == "codeword_pieces":
        return codeword_work(torch, args)
    if name == "forward_transform":
        return transform_work(torch, args)
    if name == "plane_stats":
        return plane_stats_work(torch, args)
    if name == "finish_tokens":
        return finish_work(torch, args)
    if name == "packed_elems":
        return packed_work(torch, args)
    if name == "schedule":
        return schedule_work(torch, args)
    if name == "unit_tables":
        return units_work(torch, args)
    if name == "emit_tables":
        return emit_tables_work(torch, args)
    return encode_kernel_bytes(torch, name, args), 0


def schedule_work(torch, args) -> tuple:
    """(bytes, integer operations) kernel 14 must spend on its arguments:
    each input read once (the chunk tables, the planes, the root band, the
    level tables) and each leaf it writes written once (not ``planes`` and
    ``nS_ck``, which it passes through); and, as operations, the pair
    terms of its closed-form sort, C * L for each of a frame's V valid
    steps (on this data).  Its other operations, a few a step and a
    chunk, are fewer."""
    from dwt_tpu_torch.ops import schedule

    out = dict(zip(schedule.OUT_KEYS, schedule.schedule_plain(*args)))
    nin = sum(t.numel() * t.element_size() for t in args
              if hasattr(t, "numel"))
    nout = sum(t.numel() * t.element_size() for k, t in out.items()
               if k not in ("planes", "planes_max", "T", "nS_ck"))
    C, L = args[0].shape[1], args[6].numel()
    return nin + nout, int(out["valid_sched"].sum()) * C * L


def units_work(torch, args) -> tuple:
    """(bytes, integer operations) kernel 15 must spend: the (N, S) order,
    unit bases, validity and step bases read once, the chunk tables read
    once at each unit (nS_ck, scar_ck, zcar_ck: a unit each), the level and
    chunk tables once, and for each unit its five int32 columns, its flag,
    its 32-byte meta row and its table slot written once.  Its operations,
    a binary search of S bases and a few more a unit, take less time at
    the INT32 rate than those bytes, and are not counted."""
    order, nS_ck = args[0], args[4]
    N, S = order.shape
    U = nS_ck[0].numel()
    small = sum(t.numel() * 4 for t in args[7:10])
    return (N * S * 13 + 3 * 4 * N * U + small
            + N * U * (5 * 4 + 1 + 32 + 4)), 0


# Kernel 17's inputs that its function needs besides the (N, S) step
# tables: not kernel 14's schedule order and level scans, nor the
# pyramid's vcar, which stand in for a sort and a level scan.
EMIT_READS = ("planes", "planes_max", "nS_ck", "nZ_ck", "elem", "elen", "p",
              "flat_step", "flat_ck", "valid", "ch_valid",
              "level_chunk_base", "level_nchunk")


def emit_tables_work(torch, args) -> tuple:
    """(bytes, integer operations) the function of kernel 17 must spend:
    the two words of ``off`` a step reads (at its end and at its base),
    kernel 11's chunk sums, the five (N, S) step tables, the planes, the
    chunk tables, the six unit columns and the pyramid's chunk and level
    tables, each read once (``order``, ``scar_ck``, ``zcar_ck`` and
    ``vcar`` are the kernel's short cuts, which its plain version does
    without, and are not counted); refstart, the 32-byte meta rows and the
    head written once.  Its operations, a scan and a binary search a step
    and a few a unit, take less time at the INT32 rate than those bytes,
    and are not counted."""
    from dwt_tpu_torch.ops import emit_tables

    chunks, nref = args[1], args[2]
    N, S = nref.shape
    U = args[14].shape[1]
    K = emit_tables.parts_count(chunks.shape[1], S)
    named = dict(zip(emit_tables._IN_NAMES, args))
    nin = (7 * N * S + chunks.numel()) * 4 + sum(
        named[k].numel() * named[k].element_size() for k in EMIT_READS)
    nout = 4 * N * S + 32 * N * U + 4 * (1 + N * (K + emit_tables.LMAX))
    return nin + nout, 0


def finish_work(torch, args) -> tuple:
    """(bytes, integer operations) kernel 12 must spend on its arguments:
    each input read once (the frames' npair pairs, the root band, the step
    and frame tables) and each slot's value, raw count (4 bytes each) and
    flag (1) written once.  Its few integer operations a pair take less
    time at the INT32 rate than those bytes, and are not counted."""
    n, npair = args[0].shape
    return (sum(t.numel() * t.element_size() for t in args)
            + 9 * n * 2 * npair, 0)


def packed_work(torch, args) -> tuple:
    """(bytes, integer operations) kernel 13 must spend: each row's detail
    elements read once (4 bytes), the pad mask once (1 byte an element),
    and the packed elements and their E-element tail written once (4
    bytes); its operations are not counted, as kernel 12's."""
    from dwt_tpu_torch.ops.compact import E

    lin, valid = args
    rows, n = lin.shape[0] * lin.shape[1], valid.numel()
    return 4 * rows * n + n + 4 * (rows * n + E), 0


def encode_kernel_bytes(torch, name: str, args) -> int:
    """The bytes an encode kernel must move for one call on ``args`` (as
    the encoder passes them): each input read once, each output written
    once.  Gather: its index, the frames' coefficients and the (N, C, nlin)
    output; kernel A: the elements its live units cover, its meta and unit
    table, and its whole pair buffer; pack: 16 B a token and the whole word
    buffer; kernel B: the elements its live units cover, its meta, and each
    word that holds one of their refinement bits read and written;
    transpose: its tensor read and written.  The pack kernel: 16 B a token
    and each word that receives a nonzero piece (the wrapper's zero fill of
    the whole word buffer is no work of the kernel's: ``pack_fill_bytes``
    counts it), as ``bench_torch/kernels.py:pack_bytes`` does."""
    from dwt_tpu_torch.ops.compact import E

    if name == "hilbert_gather":
        co, src = args
        n_out = co.numel() // (co.shape[-3] * co.shape[-2]) * src.numel()
        return 4 * (src.numel() + co.numel() + n_out)
    if name == "compact_tokens":
        vmag, meta, npairs, table = args[:4]
        return 4 * (unit_elements(torch, vmag, meta, E) + meta.numel()
                    + table.numel() + npairs)
    if name == "pack_words":
        widx, nwords = args[0], int(args[4])
        hit = torch.zeros(nwords + 3, dtype=torch.bool, device=widx.device)
        w = widx.long()
        for k, c in enumerate(args[1:4]):
            hit[(w[(c != 0) & (w >= 0)] + k).clamp(max=nwords + 2)] = True
        return 16 * widx.numel() + 4 * int(hit[:nwords].sum())
    if name == "scatter_refbits":
        vmag, meta, words = args[:3]
        live = meta[meta[:, 6] > 0].long()
        bit0 = 32 * live[:, 3] + live[:, 4]
        ref_words = covered(torch, bit0 >> 5,
                            ((bit0 + live[:, 6] - 1) >> 5) + 1, words.numel())
        return 4 * (unit_elements(torch, vmag, meta, E) + meta.numel()
                    + 2 * ref_words)
    x, = args
    return 2 * x.numel() * x.element_size()


def check_kernels(torch, K: Kernels, got: dict, launches: dict,
                  tiled_scatter: list, transposes: dict,
                  parent: str | None) -> list:
    """Phase 4: each kernel against its plain version, and its times
    (kernel 5 also at the tiled decode's kept calls, kernel 6 on its
    seeded tensors ``transposes``, the VLI order scan's whole call also
    of the ``parent`` checkout, where given)."""
    from dwt_tpu_torch.codec.stage1 import ALIGN
    from dwt_tpu_torch.hilbert import padded_layout, reconstruction_perm
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import (codeword, compact, emit_tables, finish,
                                   hilbert_gather, hilbert_scatter, lifting,
                                   pack, plane_stats, schedule, transpose,
                                   units, vli_scan)

    out = []

    def row(name, kernel_out, plain_out, ms, plain_ms, nbytes, library_ms,
            ops=0):
        err = max_abs_err(name, kernel_out, plain_out)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        src, rep = next((s, r) for n, _, s, r, _ in K.rows if n == name)
        bound, by = bound_of(nbytes, ops)
        out.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=library_ms, device_ms=None, batch_launches=None,
            batch_ms=None, batch_bound_ms=None, batch_device_ms=None))
        progress(f"kernels: {name} equal to its plain version; "
                 f"{ms:.3f} ms (plain {plain_ms:.3f} ms, library "
                 f"{'n/a' if library_ms is None else f'{library_ms:.3f} ms'}, "
                 f"bound {bound:.4f} ms by {by})")

    # 0. stage 1's transform, uint8 (1, H, W, C) frames -> int32
    # coefficients, and its plane statistics of the linearized (C, nlin)
    # coefficients; no one PyTorch call computes either function
    args = got["forward_transform"][0]
    nbytes, ops = transform_work(torch, args)
    row("forward_transform", lifting.forward_transform(*args),
        lifting.forward_transform_plain(*args),
        time_ms(torch, lambda: lifting.forward_transform(*args)),
        time_ms(torch, lambda: lifting.forward_transform_plain(*args),
                reps=3), nbytes, None, ops)
    args = got["plane_stats"][0]
    nbytes, ops = plane_stats_work(torch, args)
    row("plane_stats", plane_stats.plane_stats(*args),
        plane_stats.plane_stats_plain(*args),
        time_ms(torch, lambda: plane_stats.plane_stats(*args)),
        time_ms(torch, lambda: plane_stats.plane_stats_plain(*args), reps=3),
        nbytes, None, ops)
    progress(f"kernels: plane_stats {tuple(args[0].shape)}: {nbytes} bytes, "
             f"{ops} element-plane compares of the block counts")

    # 1. gather: (1, H, W, C) coefficients -> (1, C, nlin)
    co, src = got["hilbert_gather"][0]
    k = hilbert_gather.hilbert_gather(co, src)
    p = hilbert_gather.hilbert_gather_plain(co, src)
    perm = torch.as_tensor(padded_layout(compute_pyramid(W, H), ALIGN)[0],
                           device=co.device).long()
    lib_ms = time_ms(torch, lambda: co.reshape(-1, C)[perm].T.contiguous())
    row("hilbert_gather", k, p,
        time_ms(torch, lambda: hilbert_gather.hilbert_gather(co, src)),
        time_ms(torch, lambda: hilbert_gather.hilbert_gather_plain(co, src),
                reps=3),
        encode_kernel_bytes(torch, "hilbert_gather", (co, src)), lib_ms)

    # 1b. the tile engines' probe: one host call sends one 32x32 tile
    # through the gather and the scatter kernel and counts the wrong
    # values on the card (as engine_supported runs it); timed without the
    # read of the counts, over 200 runs, as its yardstick: both are tens
    # of microseconds of host latency, whose spread 10 runs do not
    # average out.  It reads the tile and its index and writes both
    # results and the two counts.
    tile, idx, res, bad = hilbert_gather.probe_buffers(co.device)
    hilbert_gather.engine_probe(tile, idx, res, bad)
    k = torch.cat([res, bad])
    p_res, p_bad = torch.empty_like(res), torch.empty_like(bad)
    hilbert_gather.engine_probe_plain(tile, idx, p_res, p_bad)
    if bad.tolist() != [0, 0]:
        raise AssertionError(f"engine_supported: the probe counts {bad}")
    co1, src1, lin1 = tile.reshape(-1, 1), idx.long(), tile.reshape(1, -1)
    row("engine_supported", k, torch.cat([p_res, p_bad]),
        time_ms(torch, lambda: hilbert_gather.engine_probe(tile, idx, res,
                                                           bad), reps=200),
        time_ms(torch, lambda: hilbert_gather.engine_probe_plain(
            tile, idx, p_res, p_bad), reps=200),
        4 * (2 * idx.numel() + res.numel() + bad.numel()),
        time_ms(torch, lambda: (co1[src1].T.contiguous(),
                                lin1[:, src1].T.contiguous()), reps=200))
    hilbert_gather._PROBED.clear()
    hilbert_gather._BUFFERS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hilbert_gather.engine_supported(co.device)
    progress(f"kernels: one cold engine_supported (buffers made, one host "
             f"call, the counts read) {1e3 * (time.perf_counter() - t0):.3f}"
             f" ms wall")

    # 2. kernel A: reads the elements its live units cover, its meta and
    # unit table, and writes its whole pair buffer
    vmag, meta, npairs, table, _ = got["compact_tokens"][0]
    k = compact.compact_tokens(vmag, meta, npairs, table)
    p = compact.compact_tokens_plain(vmag, meta, npairs)
    row("compact_tokens", k, p,
        time_ms(torch, lambda: compact.compact_tokens(vmag, meta, npairs,
                                                      table)),
        time_ms(torch, lambda: compact.compact_tokens_plain(vmag, meta,
                                                            npairs), reps=2),
        encode_kernel_bytes(torch, "compact_tokens", got["compact_tokens"][0]),
        None)
    split_a = wrapper_split_a(torch, vmag, meta, npairs, table)

    # 3. pack: 16 B read a token, and each word that receives a piece
    # written (the wrapper's zero fill of the whole buffer apart); timed as
    # the encoder calls it (the order flag left to the caller); three
    # index_add_ on int64 words are the library yardstick
    widx, c0, c1, c2, nwords = got["pack_words"][0]
    k = pack.pack_words(widx, c0, c1, c2, nwords)
    p = pack.pack_words_plain(widx, c0, c1, c2, nwords)
    idx = [widx.long() + j for j in range(3)]
    cs = [u32(c) for c in (c0, c1, c2)]

    def library_pack(acc):
        for i, c in zip(idx, cs):
            acc.index_add_(0, i, c)

    lib_ms = time_ms(torch, library_pack, setup=lambda: (torch.zeros(
        nwords + 2, dtype=torch.int64, device=widx.device),))
    flag = torch.zeros(1, dtype=torch.int32, device=widx.device)
    row("pack_words", k, p,
        time_ms(torch, lambda: pack.pack_words(widx, c0, c1, c2, nwords,
                                               order_flag=flag)),
        time_ms(torch, lambda: pack.pack_words_plain(widx, c0, c1, c2,
                                                     nwords), reps=3),
        encode_kernel_bytes(torch, "pack_words", got["pack_words"][0]),
        lib_ms)
    split_pack = wrapper_split_pack(torch, widx, c0, c1, c2, nwords)
    need = encode_kernel_bytes(torch, "pack_words", got["pack_words"][0])
    fill = 4 * (4 * widx.numel() + nwords)
    progress(f"kernels: pack_words {need} B (16 B a token and the words "
             f"that receive a piece), bound {bound_of(need)[0]:.4f} ms; "
             f"with the wrapper's zero fill of all {nwords} words {fill} B, "
             f"{bound_of(fill)[0]:.4f} ms")

    # 4. kernel B (in place on the packed words: a fresh copy each run):
    # reads the elements its live units cover and reads and writes each
    # word that holds one of their refinement bits; timed as the encoder
    # calls it, over kernel A's unit table and histograms (one launch),
    # and held also with its own count launch and its own unit table
    vmag, meta, words, table, hist = got["scatter_refbits"][0]
    p = compact.scatter_refbits_plain(vmag, meta, words.clone())
    for extra in ((table,), ()):
        if max_abs_err("scatter_refbits", compact.scatter_refbits(
                vmag, meta, words.clone(), *extra), p):
            raise AssertionError("scatter_refbits with its own count launch "
                                 "differs from its plain version")
    k = compact.scatter_refbits(vmag, meta, words.clone(), table, hist)
    row("scatter_refbits", k, p,
        time_ms(torch, compact.scatter_refbits,
                setup=lambda: (vmag, meta, words.clone(), table, hist)),
        time_ms(torch, compact.scatter_refbits_plain,
                setup=lambda: (vmag, meta, words.clone()), reps=2),
        encode_kernel_bytes(torch, "scatter_refbits",
                            got["scatter_refbits"][0]), None)
    split_b = wrapper_split_b(torch, vmag, meta, words, table, hist)
    progress(f"kernels: wrapper splits, ms: compact_tokens {split_a}; "
             f"pack_words {split_pack}; scatter_refbits {split_b}")
    progress("kernels: scatter_refbits at 4K: "
             + refbit_counts(torch, vmag, meta, words, table, hist))

    # 5. inverse scatter (decode), as the decoder's tail calls it (with the
    # run table it keeps): reads its index, the run table and C
    # coefficients for each pixel off the root band, and writes the (H, W,
    # C) plane; held also with the table derived by the wrapper; one
    # gather through the full inverse permutation is the library yardstick
    lin, src, sq_ptr, runs = got["hilbert_scatter"][0]
    k = hilbert_scatter.hilbert_scatter(lin, src, sq_ptr, runs)
    p = hilbert_scatter.hilbert_scatter_plain(lin, src)
    if max_abs_err("hilbert_scatter", hilbert_scatter.hilbert_scatter(
            lin, src), p):
        raise AssertionError("hilbert_scatter with the table it derives "
                             "differs from its plain version")
    inv = torch.as_tensor(reconstruction_perm(compute_pyramid(W, H)),
                          device=lin.device).long()
    lib_ms = time_ms(torch, lambda: lin[:, inv].T.reshape(H, W, C)
                     .contiguous())
    table_bytes = 4 * (sq_ptr.numel() + runs.numel())
    row("hilbert_scatter", k, p,
        time_ms(torch, lambda: hilbert_scatter.hilbert_scatter(
            lin, src, sq_ptr, runs)),
        time_ms(torch, lambda: hilbert_scatter.hilbert_scatter_plain(lin,
                                                                     src),
                reps=3),
        scatter_bytes(lin, src, sq_ptr, runs), lib_ms)
    derive_ms = time_ms(torch, lambda: hilbert_scatter.hilbert_scatter(
        lin, src), reps=3)
    nruns = np.bincount(np.diff(sq_ptr.cpu().numpy()))
    progress(f"kernels: hilbert_scatter at 4K: run table of "
             f"{sq_ptr.numel() - 1} squares, {runs.shape[0]} runs, "
             f"{table_bytes} bytes (squares by runs: "
             f"{dict((i, int(n)) for i, n in enumerate(nruns) if n)}); "
             f"the wrapper deriving it on the host {derive_ms:.3f} ms")
    scatter_at_tiles(torch, tiled_scatter)

    # 5b. kernel 16, the inverse transform, as the decoder's tail calls it
    # on the 4K pyramid: a launch for the coarse tail and one a larger
    # level, the colour, clamps and cast as the finest level stores; no
    # PyTorch call computes this function
    args = got["inverse_transform"][0]
    nbytes, ops = inverse_work(torch, args)
    row("inverse_transform", lifting.inverse_transform(*args),
        lifting.inverse_transform_plain(*args),
        time_ms(torch, lambda: lifting.inverse_transform(*args)),
        time_ms(torch, lambda: lifting.inverse_transform_plain(*args),
                reps=3), nbytes, None, ops)
    progress(f"kernels: inverse_transform {tuple(args[0].shape)}, levels "
             f"by launch {[p.levels for p in lifting.plan_of(*args[:4])]}: "
             f"{nbytes} bytes "
             f"({nbytes + ll_bytes(args)} with the LL buffers: bound "
             f"{bound_of(nbytes + ll_bytes(args))[0]:.4f} ms)")

    # 6. kernel 6, which no path runs: seeded tensors of the shapes the
    # VLI order scan gave it (int32 (nblk, 128) in, int8 (128, nblk) out),
    # each held to its plain version and timed alone; the row gives the
    # 4K pair summed, its batch keys the 7-frame pair.  Each reads and
    # writes its tensor once; ``x.T.contiguous()`` is the library call.
    parts, ks, ps = {}, [], []
    for key, xs in transposes.items():
        for x in xs:
            k, p = transpose.transpose2d(x), transpose.transpose2d_plain(x)
            err = max_abs_err("transpose2d", k, p)
            if err:
                raise AssertionError(f"transpose2d {tuple(x.shape)}: kernel "
                                     f"differs from its plain version (max "
                                     f"abs err {err})")
            if key == "4K":
                ks.append(k.reshape(-1).to(torch.int32))
                ps.append(p.reshape(-1).to(torch.int32))
            parts.setdefault(key, []).append((
                time_ms(torch, lambda: transpose.transpose2d(x)),
                time_ms(torch, lambda: transpose.transpose2d_plain(x)),
                encode_kernel_bytes(torch, "transpose2d", (x,)),
                time_ms(torch, lambda: x.T.contiguous())))
            t = parts[key][-1]
            bound = t[2] / HBM_BYTES_PER_S * 1e3
            if x.dtype == torch.int8:
                transpose_routes(torch, x, p)
            progress(f"kernels: transpose2d {key} {tuple(x.shape)} "
                     f"{x.dtype} ({transpose.vector_bytes(x)} bytes a "
                     f"thread): {t[0]:.4f} ms (plain {t[1]:.3f} ms, library "
                     f"{t[3]:.3f} ms, bound {bound:.4f} ms, share "
                     f"{bound / t[0]:.2f})")
    row("transpose2d", torch.cat(ks), torch.cat(ps),
        *(sum(t[i] for t in parts["4K"]) for i in range(4)))
    out[-1].update(batch_ms=sum(t[0] for t in parts["batch"]),
                   batch_bound_ms=bound_of(sum(t[2]
                                               for t in parts["batch"]))[0])

    # 7. the VLI order scan: one kernel on the 4K encode's (1, padded_T)
    # token values and flags, held to its plain version (``_vli_ab`` and
    # the parent's eager passes); no PyTorch call computes this function.
    # How its rows and tiles collapse on these tokens; then one whole
    # ``_vli_orders`` call, in turns with the parent's where one is given.
    val, vli = got["vli_orders"][0]
    nbytes, ops = vli_work(torch, val, vli)
    row("vli_orders", vli_scan.vli_orders(val, vli),
        vli_scan.vli_orders_plain(val, vli),
        time_ms(torch, lambda: vli_scan.vli_orders(val, vli)),
        time_ms(torch, lambda: vli_scan.vli_orders_plain(val, vli), reps=3),
        nbytes, None, ops)
    progress(f"kernels: vli_orders {tuple(val.shape)}: {nbytes} bytes, "
             f"{ops} integer operations ({int(vli.sum())} VLI tokens of "
             f"{val.numel()})")
    progress("kernels: vli_orders on the 4K tokens: "
             + vli_collapse(torch, val, vli))
    vli_whole(torch, val, vli, parent)

    # 8. kernel 11, the codeword pieces: one kernel on the 4K encode's
    # (1, padded_T) token arrays and (1, S) step tables, held to its plain
    # version (the eager int64 passes the encoder ran before).  No PyTorch
    # call computes this function; torch.cumsum of the same int32 lengths
    # times the scan alone, as a yardstick.
    args = got["codeword_pieces"][0]
    nbytes, ops = codeword_work(torch, args)
    row("codeword_pieces", codeword.codeword_pieces(*args),
        codeword.codeword_pieces_plain(*args),
        time_ms(torch, lambda: codeword.codeword_pieces(*args)),
        time_ms(torch, lambda: codeword.codeword_pieces_plain(*args), reps=3),
        nbytes, None, ops)
    progress(f"kernels: codeword_pieces {tuple(args[0].shape)}, "
             f"{args[4].shape[1]} steps: {nbytes} bytes; "
             + cumsum_line(torch, args))

    # 9. kernels 12 and 13, the token finisher (on the 4K encode's pairs
    # laid out again in a pair buffer's rows, as kernel A leaves them) and
    # the packed elements, each held to its plain version (the eager passes
    # the encoder ran before); no PyTorch call computes either function
    for name, fn, plain in (
            ("finish_tokens", finish.finish_tokens,
             finish.finish_tokens_plain),
            ("packed_elems", finish.packed_elems,
             finish.packed_elems_plain)):
        args = got[name][0]
        if name == "finish_tokens":
            args = as_pair_buffer(args)
        nbytes, ops = kernel_work(torch, name, args)
        row(name, fn(*args), plain(*args),
            time_ms(torch, lambda: fn(*args)),
            time_ms(torch, lambda: plain(*args), reps=3), nbytes, None, ops)
        progress(f"kernels: {name} {tuple(args[0].shape)} (row stride "
                 f"{args[0].stride(0)}): {nbytes} bytes")

    # 10. kernels 14 and 15, the schedule (on the plane statistics' 4K
    # chunk tables) and kernel A's unit tables (on kernel 14's leaves),
    # each held to its plain version (the eager passes the encoder ran
    # before, with a vectorised chain for the host walk).  No PyTorch call
    # computes either function; torch.argsort of the S schedule keys is
    # the sort's yardstick.
    for name, fn, plain in (
            ("schedule", schedule.schedule, schedule.schedule_plain),
            ("unit_tables", units.unit_tables, units.unit_tables_plain)):
        args = got[name][0]
        nbytes, ops = kernel_work(torch, name, args)
        lib_ms = None
        if name == "schedule":
            keys = schedule_keys(torch, args[0], args[6].numel())
            lib_ms = time_ms(torch, lambda: torch.argsort(keys, dim=1,
                                                          stable=True))
        row(name, fn(*args), plain(*args), time_ms(torch, lambda: fn(*args)),
            time_ms(torch, lambda: plain(*args), reps=3), nbytes, lib_ms,
            ops)
        progress(f"kernels: {name} {tuple(args[0].shape)}: {nbytes} bytes, "
                 f"{ops} pair terms of the sort")
    progress("kernels: " + schedule_sweep(torch))
    progress("kernels: " + inverse_sweep(torch))

    # 11. kernel 17, the emit half's step tables: on the 4K encode's kernel
    # 11 outputs, stats and unit columns, held to its plain version (the
    # eager passes the encoder ran before).  No PyTorch call computes this
    # function.
    args = got["emit_tables"][0]
    nbytes, ops = kernel_work(torch, "emit_tables", args)
    row("emit_tables", emit_tables.emit_tables(*args),
        emit_tables.emit_tables_plain(*args),
        time_ms(torch, lambda: emit_tables.emit_tables(*args)),
        time_ms(torch, lambda: emit_tables.emit_tables_plain(*args), reps=3),
        nbytes, None, ops)
    progress(f"kernels: emit_tables {tuple(args[2].shape)} steps, "
             f"{args[14].shape[1]} units: {nbytes} bytes; "
             + emit_in_order(torch, [args]))
    progress("kernels: kernel 17 at 4K, in turns: "
             + emit_turns(torch, args, parent))
    progress("kernels: " + emit_sweep(torch))
    return out


# The sweep of kernels 14 and 15: channels a frame, and frames a call.
SWEEP_CHANNELS = (1, 2, 3, 32)
SWEEP_FRAMES = 3


def schedule_sweep(torch) -> str:
    """Kernels 14 and 15 against their plain versions (max abs err 0) on
    seeded tables at every level count L from 1 up to the kernel's limit
    (S = C * L * 29 <= 2,048 steps, L <= 64) for each C of
    ``SWEEP_CHANNELS``: cluster sizes min(8, C * L) from 1 to 8 and blocks
    of 1 to 9 rows.  Each call's frame 0 has no planes (planes_max 0),
    frame 2's channel 0 every plane, the others random planes; chunk
    counts 1-6 a level, small counts with many zeros, ties among the
    chunks' last positions.  Returns a line of what ran; raises on a
    difference."""
    from dwt_tpu_torch.ops import schedule, units
    from dwt_tpu_torch.ops.plane_stats import PMAX

    def i32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                               device="cuda")

    rng = np.random.default_rng(14)
    N = SWEEP_FRAMES
    calls, steps, clusters, err = 0, 0, set(), 0
    t0 = time.perf_counter()
    for C in SWEEP_CHANNELS:
        for L in range(1, min(schedule.MAX_LEVELS,
                              schedule.MAX_STEPS // (C * PMAX)) + 1):
            lnc = rng.integers(1, 7, L)
            nchunk = int(lnc.sum())
            ck = (N, C, nchunk, PMAX)
            nS_ck = np.where(rng.random(ck) < 0.5, 0,
                             rng.integers(0, 40, ck))
            planes = rng.integers(0, PMAX + 1, (N, C))
            planes[0] = 0
            planes[2, 0] = PMAX
            ch_len = rng.integers(1, 65537, nchunk)
            host = (planes, nS_ck, rng.integers(-1, 6, ck),
                    rng.integers(0, 300, (N, C, nchunk)),
                    rng.integers(0, 50, ck), rng.integers(-70, 70, (N, C, 7)),
                    rng.integers(100, 900, L),
                    np.concatenate([[0], np.cumsum(lnc)[:-1]]), lnc)
            args = tuple(map(i32, host))
            got = schedule.schedule(*args)
            err = max(err, max_abs_err("schedule", got,
                                       schedule.schedule_plain(*args)))
            st = dict(zip(schedule.OUT_KEYS, got))
            uargs = (st["order"], st["ubase_sched"], st["valid_sched"],
                     st["step_base"], st["nS_ck"], st["scar_ck"],
                     st["zcar_ck"], args[7], i32(np.cumsum(ch_len) - ch_len),
                     i32(ch_len), int(ch_len.sum()),
                     1 << max(13, int(st["T"].max()).bit_length()))
            err = max(err, max_abs_err("unit_tables", units.unit_tables(*uargs),
                                       units.unit_tables_plain(*uargs)))
            calls += 1
            steps = max(steps, C * L * PMAX)
            clusters.add(min(8, C * L))
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"the sweep of kernels 14 and 15 differs from "
                             f"their plain versions (max abs err {err})")
    return (f"kernels 14 and 15 equal to their plain versions (max abs err "
            f"0) on a seeded sweep of {calls} calls of {N} frames: C in "
            f"{SWEEP_CHANNELS}, L from 1 to the limit, up to {steps} steps a "
            f"frame, cluster sizes {sorted(clusters)}; "
            f"{time.perf_counter() - t0:.1f} s")


# The sweep of kernel 16: (w, h) of pyramid chains, and root-only chain
# sizes (the decoder's root pass, from 2x2 up); frames a call.
INVERSE_SWEEP_SIZES = ((8, 8), (9, 8), (17, 9), (33, 31), (64, 48),
                       (70, 50), (129, 65), (240, 135), (321, 239),
                       (480, 270), (513, 129), (1000, 37))
INVERSE_SWEEP_ROOTS = ((2, 2), (2, 3), (3, 2), (5, 7), (9, 15), (31, 4))
INVERSE_SWEEP_FRAMES = (1, 2, 3, 5, 17, 40)


def inverse_sweep(torch) -> str:
    """Kernel 16 against its plain version (max abs err 0) on seeded
    coefficients: each chain of ``INVERSE_SWEEP_SIZES`` (whole pyramids)
    and ``INVERSE_SWEEP_ROOTS`` (one level, the root-only pass) with 1 and
    3 channels and frames of ``INVERSE_SWEEP_FRAMES`` (one count a size,
    in turn), given contiguous, as the decoder hands it over (the (H, W,
    N, C) view, a random bias table, the root band as a view of an (N, C,
    total) buffer) and with its channels apart (a channel stride other
    than 1), uint8 with the colour and int32 without.  Returns a line of
    what ran; raises on a difference."""
    from dwt_tpu_torch.ops import lifting

    gen = torch.Generator(device="cuda").manual_seed(25)
    calls, err, plans = 0, 0, set()
    t0 = time.perf_counter()
    sizes = [(w, h, False) for w, h in INVERSE_SWEEP_SIZES] + [
        (w, h, True) for h, w in INVERSE_SWEEP_ROOTS]
    for i, (w, h, root_only) in enumerate(sizes):
        n = INVERSE_SWEEP_FRAMES[i % len(INVERSE_SWEEP_FRAMES)]
        for c in (1, 3):
            if root_only:
                lin = torch.randint(-700, 700, (n, c, h * w + 3),
                                    dtype=torch.int32, device="cuda",
                                    generator=gen)
                view = lin[..., :h * w].unflatten(2, (h, w)).permute(
                    0, 2, 3, 1)
                variants = [(view, ((h, w),), c == 3, True),
                            (view.contiguous(), ((h, w),), False, False)]
            else:
                args = decoder_args(torch, gen, n, h, w, c)
                x = args[0].contiguous()
                x[:, :args[5].shape[1], :args[5].shape[2]] = args[5]
                planar = x.permute(3, 0, 1, 2).contiguous().permute(
                    1, 2, 3, 0)  # channels apart
                variants = [args, args[:2] + (False, False) + args[4:],
                            (x, args[1], c == 3, True),
                            (x, args[1], False, False),
                            (planar, args[1], c == 3, True, args[4])]
            for a in variants:
                err = max(err, max_abs_err(
                    "inverse_transform", lifting.inverse_transform(*a),
                    lifting.inverse_transform_plain(*a)))
                plans.add(tuple((len(p.levels), p.cb, p.K, p.F)
                                for p in lifting.plan_of(*a[:4])))
                calls += 1
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"the sweep of kernel 16 differs from its plain "
                             f"version (max abs err {err})")
    return (f"kernel 16 equal to its plain version (max abs err 0) on a "
            f"seeded sweep of {calls} calls: {len(INVERSE_SWEEP_SIZES)} "
            f"pyramids and {len(INVERSE_SWEEP_ROOTS)} root-only sizes, 1 "
            f"and 3 channels, {INVERSE_SWEEP_FRAMES} frames, contiguous, "
            f"as the decoder hands it over (bias, root view) and with "
            f"channels apart; "
            f"{len(plans)} distinct plans, clusters of "
            f"{sorted({p[2] for q in plans for p in q if p[1]})} blocks, "
            f"{sorted({p[3] for q in plans for p in q if not p[1]})} frames "
            f"a warp; {time.perf_counter() - t0:.1f} s")


# The arguments of this tree's kernel 17 that a tree from before its
# schedule order and level scans does not take: order, scar_ck, zcar_ck
# and vcar.
EMIT_NEW_ARGS = (4, 12, 13, 21)


def emit_turns(torch, args, parent: str | None) -> str:
    """Kernel 17 on the kept call ``args`` by CUDA events around the
    wrapper, this tree's and, where ``parent`` names a checkout, the
    parent's in turns (this tree, the parent, the parent, this tree),
    every call's outputs held equal to this tree's; beside the bound of
    this tree's call.  (No profiler session here, before the timing
    phase; ``tools/wrapper_split.py`` gives both trees' device times.)"""
    from dwt_tpu_torch.ops import emit_tables

    trees = {"this tree": (emit_tables.emit_tables, args)}
    order = ["this tree", "this tree"]
    if parent:
        fn = parent_module(parent, "ops.emit_tables").emit_tables
        old = "order" not in inspect.signature(fn).parameters
        trees["parent"] = (fn, tuple(a for i, a in enumerate(args)
                                     if not (old and i in EMIT_NEW_ARGS)))
        order = ["this tree", "parent", "parent", "this tree"]
    want = emit_tables.emit_tables(*args)
    out = []
    for name in order:
        fn, a = trees[name]
        err = max_abs_err("emit_tables", fn(*a), want)
        if err:
            raise AssertionError(f"kernel 17 of {name} differs from this "
                                 f"tree's (max abs err {err})")
        out.append(f"{name} {time_ms(torch, lambda: fn(*a), reps=20):.4f} "
                   f"ms")
    bound, by = bound_of(*emit_tables_work(torch, args))
    return (f"{args[0].shape[0]} frames of {args[2].shape[1]} steps, CUDA "
            f"events: " + "; ".join(out) + f"; bound {bound:.4f} ms by {by}"
            + ("" if parent else " (no --parent given)"))


def emit_in_order(torch, calls) -> str:
    """Raise unless every kept kernel-17 call of ``calls`` has an ``order``
    that is a permutation of each frame's steps whose injection sites never
    decrease (so the kernel took no sort: the encode paths make no other
    tables); returns a line saying so."""
    frames = 0
    for args in calls:
        site, order = args[3], args[4].long()
        N, S = order.shape
        perm = torch.equal(order.sort(dim=1).values, torch.arange(
            S, device=order.device).expand(N, S))
        if not perm or not bool((torch.diff(site.gather(1, order), dim=1)
                                 >= 0).all()):
            raise AssertionError(f"kernel 17's tables of {N} frames are not "
                                 f"in schedule order")
        frames += N
    return (f"{len(calls)} calls of kernel 17, {frames} frames, every "
            f"frame's sites in schedule order (no sort)")


# The sweep of kernel 17: channels a frame, each at every level count up to
# the kernel's 2,048 steps a frame, 3 frames a call; then frames a call at
# the 16x16 tiles' shape (3 channels, 2 levels of a chunk), up to the
# larger sub-batch of them that small_tiles encodes; each on random tables
# (its sort) and on tables in schedule order (no sort).
EMIT_SWEEP_CHANNELS = (1, 2, 3, 32)
EMIT_SWEEP_FRAMES = (1, 2, 3, 4, 5, 7, 8, 9, 64, 1024, 29_126)


def level_scans(x: np.ndarray, lcb, lnc) -> np.ndarray:
    """(..., nchunk, PMAX) chunk table -> its level-exclusive scan over the
    chunks in wrapping int32, as kernel 14 writes ``scar_ck`` and
    ``zcar_ck``."""
    x = np.asarray(x, np.int64)
    out = np.zeros_like(x)
    for b, c in zip(lcb, lnc):
        seg = x[..., b:b + c, :]
        out[..., b:b + c, :] = np.cumsum(seg, axis=-2) - seg
    return ((out + 2**31) % 2**32 - 2**31).astype(np.int32)


def emit_seeded(torch, rng, N: int, C: int, L: int, T: int,
                nwords: int, lnc=None) -> tuple:
    """Seeded kernel-17 arguments on the card: N frames of C channels and
    L levels of 1-4 chunks (or ``lnc``), T token slots; tied sites, sites
    at 0 and T, step ends past both edges, refinement counts whose sums
    wrap int32, any in-range unit columns, word windows clamped; a random
    permutation for the schedule order (the kernel's sort), the chunk
    tables' level scans as kernel 14 makes them; a channel's elements and
    a frame's words cut to what N frames hold in int32 indices."""
    from dwt_tpu_torch.ops.plane_stats import PMAX

    S = C * L * PMAX
    lnc = rng.integers(1, 5, L) if lnc is None else np.asarray(lnc)
    nchunk = int(lnc.sum())
    lcb = np.concatenate([[0], np.cumsum(lnc)[:-1]])
    # a channel's elements and a frame's words within the int32 indices
    U, n = C * nchunk * PMAX, min(1 << 16, (2**31 - 1) // (N * C))
    nwords = min(nwords, (2**31 - 1) // N)
    site = np.where(rng.random((N, S)) < 0.5, rng.integers(0, T + 1, (N, S)),
                    rng.choice([0, 1, T // 2, T - 1, T], size=(N, S)))
    nS = rng.integers(0, 5000, (N, C, nchunk, PMAX))
    nZ = rng.integers(0, 70000, (N, C, nchunk, PMAX))
    ch_valid = rng.integers(0, 65537, nchunk)
    host = [rng.integers(-2**31, 2**31, (N, T)),
            rng.integers(0, 2**17, (N, -(-T // 2048))),
            np.where(rng.random((N, S)) < 0.3, 0,
                     rng.integers(0, 2**30, (N, S))), site,
            np.argsort(rng.random((N, S)), axis=1),
            rng.integers(-3, T + 3, (N, C, L, PMAX)),
            rng.integers(-2**31, 2**31, (N, C, L, PMAX)),
            rng.integers(-3, T + 3, (N, C, L, PMAX)),
            rng.integers(0, PMAX + 1, (N, C)), rng.integers(0, PMAX + 1, N),
            nS, nZ, level_scans(nS, lcb, lnc), level_scans(nZ, lcb, lnc),
            rng.integers(0, C * n, (N, U)), rng.integers(1, 65537, (N, U)),
            rng.integers(0, PMAX, (N, U)), rng.integers(0, S, (N, U)),
            rng.integers(0, U, (N, U))]
    args = [torch.as_tensor(h, dtype=torch.int32, device="cuda")
            for h in host]
    args.append(torch.as_tensor(rng.random((N, U)) < 0.7, device="cuda"))
    args += [torch.as_tensor(h, dtype=torch.int32, device="cuda") for h in (
        ch_valid, level_scans(ch_valid[:, None], lcb, lnc)[:, 0], lcb, lnc)]
    return tuple(args) + (n, nwords)


def emit_scheduled(torch, rng, N: int, C: int, L: int, lnc) -> tuple:
    """Kernel-17 arguments in schedule order on the card: kernel 14's and
    15's plain versions on seeded planes and chunk tables (frame 0 without
    planes, frame 2's channel 0 with every plane), the injection sites and
    refinement counts as ``emit._codeword_contribs`` makes them, seeded
    token offsets and chunk sums at a bucket above every T."""
    from dwt_tpu_torch.ops import schedule, units
    from dwt_tpu_torch.ops.plane_stats import PMAX

    def i32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                               device="cuda")

    lnc = np.asarray(lnc)
    nchunk, S = int(lnc.sum()), C * L * PMAX
    ck = (N, C, nchunk, PMAX)
    lcb = np.concatenate([[0], np.cumsum(lnc)[:-1]])
    planes = rng.integers(0, PMAX + 1, (N, C))
    planes[0] = 0
    if N > 2:
        planes[2, 0] = PMAX
    args = tuple(map(i32, (
        planes, np.where(rng.random(ck) < 0.5, 0, rng.integers(0, 40, ck)),
        rng.integers(-1, 6, ck), rng.integers(0, 300, (N, C, nchunk)),
        rng.integers(0, 50, ck), rng.integers(-70, 70, (N, C, 7)),
        rng.integers(100, 900, L), lcb, lnc)))
    st = dict(zip(schedule.OUT_KEYS, schedule.schedule_plain(*args)))
    T = 1 << max(11, int(st["T"].max()).bit_length())
    ch_len = rng.integers(1, 65537, nchunk)
    n = min(1 << 16, (2**31 - 1) // (N * C))
    com = units.unit_tables_plain(
        st["order"], st["ubase_sched"], st["valid_sched"], st["step_base"],
        st["nS_ck"], st["scar_ck"], st["zcar_ck"], args[7],
        i32(np.cumsum(ch_len) - ch_len), i32(ch_len), n, T)[:6]
    ch_valid = rng.integers(0, 65537, nchunk)
    return (i32(rng.integers(-2**31, 2**31, (N, T))),
            i32(rng.integers(0, 2**17, (N, -(-T // 2048)))),
            torch.where(st["valid"], st["nRef"], 0).reshape(N, S),
            st["inj_pos"].reshape(N, S).clamp(0, T), st["order"],
            st["step_end"], st["refpfx"], st["step_base"], st["planes"],
            st["planes_max"], st["nS_ck"], st["nZ_ck"], st["scar_ck"],
            st["zcar_ck"], *com, i32(ch_valid),
            i32(level_scans(ch_valid[:, None], lcb, lnc)[:, 0]), args[7],
            args[8], n, min(40_000, (2**31 - 1) // N))


def emit_sweep(torch) -> str:
    """Kernel 17 against its plain version (max abs err 0) on seeded tables
    (``emit_seeded``: random orders, the kernel's sort) and on tables in
    schedule order (``emit_scheduled``: no sort): each C of
    ``EMIT_SWEEP_CHANNELS`` at every level count L from 1 to the kernel's
    limit (S = C * L * 29 <= 2,048; kernel 14's 64 levels in schedule
    order), 3 frames a call, then the 16x16
    tiles' shape at each frame count of ``EMIT_SWEEP_FRAMES`` (29,126: the
    larger sub-batch of ``small_tiles``); and its time on 3 frames of
    2,030 steps and on 29,126 16x16 frames, both orders, by CUDA events
    around the wrapper and by device time (torch.profiler).  Returns a
    line of what ran; raises on a difference."""
    from dwt_tpu_torch.ops import emit_tables, schedule
    from dwt_tpu_torch.ops.plane_stats import PMAX

    rng = np.random.default_rng(17)
    t0 = time.perf_counter()
    calls, steps, err = 0, 0, 0
    shapes = [(3, C, L) for C in EMIT_SWEEP_CHANNELS
              for L in range(1, emit_tables.MAX_STEPS // (C * PMAX) + 1)]
    shapes += [(N, 3, 2) for N in EMIT_SWEEP_FRAMES]
    timed = {}
    for N, C, L in shapes:
        lnc = np.ones(L, int) if (C, L) == (3, 2) else rng.integers(1, 5, L)
        # kernel 14 takes at most 64 levels
        for kind in ("random", "scheduled")[:1 + (L <= schedule.MAX_LEVELS)]:
            if kind == "random":
                T = int(rng.integers(2048, 20000)) if N < 1024 else 8192
                args = emit_seeded(torch, rng, N, C, L, T,
                                   int(rng.integers(1000, 60000)), lnc)
            else:
                args = emit_scheduled(torch, rng, N, C, L, lnc)
                emit_in_order(torch, [args])
            err = max(err, max_abs_err(
                "emit_tables", emit_tables.emit_tables(*args),
                emit_tables.emit_tables_plain(*args)))
            calls += 1
            steps = max(steps, C * L * PMAX)
            if (N, C * L * PMAX) in ((3, 2030), (29_126, 174)):
                timed[(N, C * L * PMAX, kind)] = (
                    time_ms(torch, lambda: emit_tables.emit_tables(*args)),
                    kernel_ms(torch, lambda: emit_tables.emit_tables(*args),
                              EMIT_NAMES[0], per_call=1))
            del args
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"the sweep of kernel 17 differs from its plain "
                             f"version (max abs err {err})")
    return (f"kernel 17 equal to its plain version (max abs err 0) on a "
            f"seeded sweep of {calls} calls, random orders and schedule "
            f"orders: C in {EMIT_SWEEP_CHANNELS} at every L up to {steps} "
            f"steps a frame (3 frames), and 16x16 tiles' tables at "
            f"{EMIT_SWEEP_FRAMES} frames; " + "; ".join(
                f"{n} frames of {s} steps, {k} order: {e:.4f} ms events, "
                f"device {d:.4f} ms" for (n, s, k), (e, d) in timed.items())
            + f"; {time.perf_counter() - t0:.1f} s")


# Kernels 14 and 15 by tree, as the profiler names them (the parent's
# kernel 14 was two kernels).
# Kernels 14 and 15 by wrapper, as the profiler names them; a tree whose
# kernel 14 ran its level sums as a kernel of their own also ran
# level_sums_kernel.
SCHED_KERNELS = {"schedule": ("schedule_kernel",),
                 "unit_tables": ("units_kernel",)}


def schedule_turns(torch, kept: dict, parent: str | None) -> str:
    """Kernels 14 and 15 on their kept calls ``kept[wrapper]``: each by
    CUDA events around the wrapper (``time_ms``) and by device time
    (torch.profiler), this tree's and, where ``parent`` names a checkout,
    the parent's in turns (this tree, the parent, the parent, this tree),
    each call's leaves held equal to this tree's.  A parent from before
    kernel 14's cluster launch takes the level sums' warps from the
    caller, and its unit tables the levels' chunk counts where this tree
    takes ``ubase_sched``."""
    import inspect

    from dwt_tpu_torch.ops import schedule, units

    trees = {"this tree": (schedule, units)}
    order = ["this tree"]
    if parent:
        trees["parent"] = (parent_module(parent, "ops.schedule"),
                           parent_module(parent, "ops.units"))
        order = ["this tree", "parent", "parent", "this tree"]
    parts = []
    for name in ("schedule", "unit_tables"):
        args = kept[name]
        want = (dict(zip(schedule.OUT_KEYS, schedule.schedule(*args)))
                if name == "schedule" else units.unit_tables(*args))
        times: dict = {}
        for tree in order:
            sched, unit = trees[tree]
            old = hasattr(sched, "level_warps")  # level sums of their own
            kernels = SCHED_KERNELS[name]
            if name == "schedule":
                # the old level sums took their warps from the caller
                fargs = args + ((sched.level_warps(args[8].tolist()),)
                                if old else ())
                kernels = ("level_sums_kernel",) * old + kernels
                fn = lambda a=fargs, m=sched: m.schedule(*a)  # noqa
            else:
                fargs = args
                if "ubase_sched" not in inspect.signature(
                        unit.unit_tables).parameters:  # the chunk counts
                    lcb, nchunk = args[7], args[4].shape[2]
                    lnc = torch.diff(lcb, append=lcb.new_tensor([nchunk]))
                    fargs = (args[0], *args[2:7], lnc, *args[7:])
                fn = lambda a=fargs, m=unit: m.unit_tables(*a)  # noqa
            got = fn()
            if name == "schedule":
                same = all(torch.equal(v, want[k]) for k, v in
                           zip(sched.OUT_KEYS, got))
            else:
                same = all(torch.equal(g, w) for g, w in zip(got, want))
            if not same:
                raise AssertionError(f"{name} of {tree} differs")
            ev = time_ms(torch, fn, reps=50)
            dev = sum(kernel_ms(torch, fn, k, per_call=1) for k in kernels)
            times.setdefault(tree, []).append((ev, dev))
        parts.append(f"{name} {tuple(args[0].shape)}: " + "; ".join(
            f"{tree} " + ", ".join(f"{e:.4f} ms ({d:.4f} device)"
                                  for e, d in v)
            for tree, v in times.items()))
    misses = {k: PROFILER_MISSES.pop(k) for k in ("schedule_kernel",
                                                  "level_sums_kernel",
                                                  "units_kernel")
              if k in PROFILER_MISSES}
    return ("; ".join(parts) + " (events around the wrapper, device by "
            "torch.profiler)" + ("" if parent else " (no --parent given)")
            + (f"; not measured where the profiler saw a wrong count of "
               f"kernels in 10 calls, three sessions: {misses}" if misses
               else ""))


def schedule_keys(torch, planes, L: int):
    """The (N, S) schedule keys of kernel 14's frames (the plain version's
    formula), invalid steps at 2^30: the input of the sort's yardstick."""
    from dwt_tpu_torch.ops.plane_stats import PMAX

    N, C = planes.shape
    dev = planes.device
    pm = planes.amax(dim=1)[:, None, None, None]
    c = torch.arange(C, dtype=torch.int32, device=dev)[None, :, None, None]
    l_ = torch.arange(L, dtype=torch.int32, device=dev)[None, None, :, None]
    p = torch.arange(PMAX, dtype=torch.int32, device=dev)[None, None, None]
    sec = (c > 0).to(torch.int32)
    layers = torch.where(sec == 0, pm - 2 - p + l_, pm - 1 - p + l_)
    key = ((layers + 1) << 16) | (sec << 12) | (l_ << 6) | c
    return torch.where(p < planes[:, :, None, None], key, 2**30).reshape(
        N, -1)


def seeded_transposes(torch) -> dict:
    """Kernel 6's inputs: ``TRANSPOSE_SHAPES``, int32 then int8, seeded."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    return {key: [torch.randint(-2**31, 2**31, i32, generator=gen,
                                dtype=torch.int32, device="cuda"),
                  torch.randint(-128, 128, i8, generator=gen,
                                dtype=torch.int8, device="cuda")]
            for key, (i32, i8) in TRANSPOSE_SHAPES.items()}


def vli_whole(torch, val, vli, parent: str | None) -> None:
    """One 4K ``tokens._vli_orders`` on the 4K encode's tokens, by CUDA
    events around the call and by the host clock around a call that ends
    synchronised; where ``parent`` names a checkout, the same call of its
    ``dwt_tpu_torch`` in turns (this tree, the parent, the parent, this
    tree), each held to this tree's orders."""
    from dwt_tpu_torch.codec import tokens

    trees = {"this tree": tokens}
    order = ["this tree", "this tree"]
    if parent:
        trees["parent"] = load_tree(parent)
        _, secs = sys.modules["parent_dwt_tpu_torch.runtime.build"].build()
        progress(f"kernels: the parent's kernels ({parent}) built in "
                 f"{secs:.1f} s")
        order = ["this tree", "parent", "parent", "this tree"]
    padded_T = val.shape[1]
    want = tokens._vli_orders(val, vli, padded_T)
    times = {}
    for name in order:
        mod = trees[name]
        got = mod._vli_orders(val, vli, padded_T)
        if not torch.equal(got, want):
            raise AssertionError(f"_vli_orders of {name} differs")
        ev = time_ms(torch, lambda: mod._vli_orders(val, vli, padded_T),
                     reps=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod._vli_orders(val, vli, padded_T)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        times.setdefault(name, []).append(f"{ev:.4f} ms events, "
                                          f"{wall:.3f} ms host")
    progress(f"kernels: one _vli_orders at 4K ({padded_T} tokens): "
             + "; ".join(f"{k} {', '.join(v)}" for k, v in times.items())
             + ("" if parent else " (no --parent given)"))


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


def device_names(torch, fn) -> list:
    """The names of the device events (kernels, copies, sets) of one
    ``fn()``, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def copies(torch, fn) -> dict:
    """The device-to-host ("DtoH") and host-to-device ("HtoD") copies of
    one ``fn()``, counted from torch.profiler's device events."""
    names = device_names(torch, fn)
    return {d: sum(n.startswith(f"Memcpy {d}") for n in names)
            for d in ("DtoH", "HtoD")}


def encode_copies(torch, enc, img) -> dict:
    """The copies of one warm encode (:func:`copies`).  Uses only the
    encoder's public API, so it can count another tree's."""
    return copies(torch, lambda: enc.encode(img))


def profile(torch, enc, img, parent: str | None) -> None:
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
    x = torch.as_tensor(img, device=enc.device)[None]
    marks = [time.perf_counter()]
    lin, stats = stage1._transform_and_stats(x, pyr, C, enc.gray, enc._src)
    T = int(stats["T"][0])
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
    nwords = emit._stream_words(pyr, C, padded_T)
    progress("profile: one _codeword_contribs at 4K: " + contribs_kernels(
        torch, lambda: emit._codeword_contribs(stats, tv, tr, tf, orders,
                                               padded_T, nwords)))
    del lin, stats, tv, tr, tf, orders, vmag, com
    progress("profile: stage 1 at 4K by pass (tools/stage1_split.py): "
             + stage1_split(torch, enc, img[None], parent))
    progress("profile: emit half at 4K by pass (tools/emit_split.py): "
             + emit_splits(torch, enc, img[None], parent))
    emit_gate(torch, enc, img[None], "4K")
    progress("profile: tokens half at 4K by pass (tools/tokens_split.py): "
             + emit_splits(torch, enc, img[None], parent, "tokens_split"))

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
    copies = encode_copies(torch, enc, img)
    progress(f"profile: copies in one warm encode: {copies['DtoH']} "
             f"device-to-host, {copies['HtoD']} host-to-device (the frame's "
             f"upload alone: stage 1 makes none)")
    if copies["HtoD"] > 1:
        raise AssertionError(f"one warm encode made {copies['HtoD']} "
                             f"host-to-device copies; the upload is the one")
    progress("profile: top device time (last one): " + "; ".join(
        f"{name[:60]} {t / 1e3:.2f} ms x{n}" for name, (t, n) in top))


def tool(name: str):
    """The module ``tools/<name>.py`` of this checkout."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def contribs_kernels(torch, fn) -> str:
    """The CUDA kernels of one warm ``fn()``, an ``emit._codeword_contribs``
    call, by torch.profiler: kernel 11 once, and the small kernels of its
    (N, S) inputs (the refinement counts and injection sites), by name and
    count, their device time beside kernel 11's; "not measured" where the
    profiler recorded no kernel 11 or more than one (it drops events in
    some sessions)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine = [e for e in ev if CODEWORD_NAME in e.name]
    if len(mine) != 1:
        return (f"not measured ({len(mine)} {CODEWORD_NAME} events of "
                f"{len(ev)})")
    others: dict = {}
    for e in ev:
        if e is not mine[0]:
            name = e.name.split("(")[0].split("<")[0].split()[-1][:40]
            others[name] = others.get(name, 0) + 1
    rest = sum(e.time_range.elapsed_us() for e in ev if e is not mine[0])
    return (f"{len(ev)} CUDA kernels: {CODEWORD_NAME} x1 "
            f"{mine[0].time_range.elapsed_us() / 1e3:.4f} ms; its (N, S) "
            f"inputs' {len(ev) - 1} {rest / 1e3:.4f} ms ("
            + ", ".join(f"{k} x{n}" for k, n in others.items()) + ")")


# The kernels the emit half may launch after kernel 11, by the names the
# profiler gives them: the pack wrapper's zero fill and kernel, kernel 17's
# and kernel B's; each of the three named kernels once.
EMIT_GATE = ("pack_words_kernel", "FillFunctor", "emit_tables_kernel",
             "refbits_scatter_kernel")


def emit_gate(torch, enc, imgs: np.ndarray, label: str) -> None:
    """The emit half after kernel 11 is the pack, kernel 17 and kernel B:
    one ``enc.emit_frames`` of ``imgs`` with the plain versions of the
    step tables made to raise (``emit``'s parts and ``ops/emit_tables.py``'s
    functions), under torch.profiler.  From kernel 11's end to the
    download (its gather of the frames' words where it has more than one
    frame, and its copy: the last events) only the kernels of
    ``EMIT_GATE``, the three named ones once each, and one device-to-host
    copy, ``_host_totals``'; its payloads equal the unrefused call's.  A
    session in which the profiler recorded no kernel 11 is tried again,
    twice, and then reads "not recorded".  Raises otherwise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dwt_tpu_torch.codec import emit, encoder
    from dwt_tpu_torch.ops import emit_tables

    lin, stats = enc.stage1_frames(imgs)
    padded_T = encoder._bucket(int(stats["T"].max()))
    want = enc.emit_frames(lin, stats, padded_T)[0]

    def refuse(fn):
        def run(*args, **kwargs):
            raise AssertionError(f"emit gate {label}: an eager pass ran")
        return run

    eager = [(emit, n) for n in ("_bit_partials", "_kernel_b_meta",
                                 "_layer_boundaries")] + [
        (emit_tables, n) for n in ("emit_tables_plain", "refstart_plain",
                                   "bit_partials_plain",
                                   "kernel_b_meta_plain",
                                   "layer_ends_plain")]
    after = None
    with contextlib.ExitStack() as stack:
        for obj, name in eager:
            stack.enter_context(wrapped(obj, name, refuse))
        for _ in range(3):
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                got = enc.emit_frames(lin, stats, padded_T)[0]
                torch.cuda.synchronize()
            if got != want:
                raise AssertionError(f"emit gate {label}: the payloads "
                                     f"differ from the unrefused call's")
            ev = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
            k11 = [i for i, e in enumerate(ev) if CODEWORD_NAME in e.name]
            if k11:
                after = [e.name for e in ev[k11[-1] + 1:]]
                break
    if after is None:
        progress(f"timing: emit gate {label}: not recorded (no "
                 f"{CODEWORD_NAME} event in three profiler sessions); eager "
                 f"passes refused: {[n for _, n in eager]}")
        return
    tail = 2 if len(imgs) > 1 else 1
    gated, download = after[:-tail], after[-tail:]
    kernels = [n for n in gated if "emcpy" not in n and "emset" not in n]
    copies = [n for n in gated if n not in kernels]
    names = {}
    for n in kernels:
        key = next((k for k in EMIT_GATE if k in n), n)
        names[key] = names.get(key, 0) + 1
    ok = (sum("DtoH" in n for n in download) == 1
          and len(copies) == 1 and "DtoH" in copies[0]
          and set(names) <= set(EMIT_GATE)
          and all(names.get(k) == 1 for k in EMIT_GATE if k != "FillFunctor"))
    progress(f"timing: emit gate {label} ({len(imgs)} frames): after kernel "
             f"11, CUDA kernels {names}; copies {copies}; then the download "
             f"{[n[:40] for n in download]}; eager passes refused: "
             f"{[n for _, n in eager]}")
    if not ok:
        raise AssertionError(f"emit gate {label}: the emit half after kernel "
                             f"11 is not the pack, kernel 17 and kernel B "
                             f"alone: {after}")


def emit_splits(torch, enc, imgs: np.ndarray, parent: str | None,
                name: str = "emit_split") -> str:
    """``tools/emit_split.py``'s split of one warm emit half of ``imgs``
    (or, with ``name`` "tokens_split", ``tools/tokens_split.py``'s of the
    tokens half): the means of three runs, each pass by the host clock
    between synchronised marks and by CUDA events, and the unmarked half,
    on this tree's encoder ``enc`` and, where ``parent`` names a checkout,
    on its encoder of the same geometry, in turns (this tree, the parent,
    the parent, this tree)."""
    mod, stage1 = tool(name), tool("emit_split").stage1
    encs = {"this tree": enc}
    order = ["this tree"]
    if parent:
        encs["parent"] = parent_module(parent, "codec.encoder").get_encoder(
            enc.pyr.width, enc.pyr.height, enc.channels)
        order = ["this tree", "parent", "parent", "this tree"]
    out = []
    for name in order:
        res = mod.split(torch, encs[name],
                        *stage1(torch, encs[name], imgs), 3)
        out.append(f"{name}: {mod.line(res)}")
    return " | ".join(out)


def stage1_split(torch, enc, imgs: np.ndarray,
                 parent: str | None = None) -> str:
    """``tools/stage1_split.py``'s split of one stage 1 of ``imgs``: the
    means of three runs, each pass by the host clock between synchronised
    marks and by CUDA events, beside the unmarked ``stage1_frames``; on
    this tree's encoder ``enc`` and, where ``parent`` names a checkout, on
    its encoder of the same geometry, in turns (this tree, the parent, the
    parent, this tree)."""
    mod = tool("stage1_split")
    encs, order = {"this tree": enc}, ["this tree"]
    if parent:
        encs["parent"] = parent_module(parent, "codec.encoder").get_encoder(
            enc.pyr.width, enc.pyr.height, enc.channels)
        order = ["this tree", "parent", "parent", "this tree"]
    out = []
    for name in order:
        res = mod.split(torch, encs[name], imgs, 3)
        out.append(f"{name}: " + "; ".join(
            f"{k} {h:.2f} ms" + ("" if d is None else f" ({d:.2f} events)")
            for k, (h, d) in res.items()))
    return " | ".join(out)


def tail_gate(torch, decoder, label: str, geom: tuple, coeffs,
              missing) -> None:
    """The decode tail is the scatter and kernel 16: one ``_Tail.batch``
    of parsed inputs with the eager passes refused (``bias_plain``, the
    pyramid route, and ``_Tail._bias`` where a tree has it), its launch
    counts read (the scatter once, kernel 16 ``len(plan_of(...))`` times)
    and, under torch.profiler, its CUDA kernels by name: those two and no
    other, beside at most one host-to-device copy (the bias table) and no
    device-to-device copy.  Its image must equal the unrefused tail's; the
    bias table must go to kernel 16 where a decoded level has two planes
    missing.  Raises otherwise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dwt_tpu_torch.ops import hilbert_scatter, lifting

    w, h, levels, c, gray = geom
    tail = decoder._tail(w, h, levels, c, gray, coeffs.device)
    want = tail.batch(coeffs, missing)
    torch.cuda.synchronize()

    def refuse(fn):
        def run(*args, **kwargs):
            raise AssertionError(f"tail gate {label}: an eager pass ran")
        return run

    calls = []
    eager = [(decoder, "bias_plain"), (lifting, "bias_plain")] + [
        (decoder._Tail, n) for n in ("_bias", "pyramid")
        if hasattr(decoder._Tail, n)]
    with contextlib.ExitStack() as stack:
        for obj, name in eager:
            stack.enter_context(wrapped(obj, name, refuse))
        stack.enter_context(wrapped(
            decoder, "inverse_transform",
            lambda fn: lambda *a: (calls.append(a), fn(*a))[1]))
        sc, inv = (hilbert_scatter.hilbert_scatter.launches,
                   lifting.inverse_transform.launches)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            got = tail.batch(coeffs, missing)
            torch.cuda.synchronize()
        sc = hilbert_scatter.hilbert_scatter.launches - sc
        inv = lifting.inverse_transform.launches - inv
    plan = lifting.plan_of(*calls[0][:4])
    ev = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [n for n in ev if "emcpy" in n or "emset" in n]
    kernels = [n for n in ev if n not in copies]
    names = {}
    for n in kernels:
        key = next((k for k in (SCATTER_NAME, "inverse_tail_kernel",
                                "inverse_level_kernel") if k in n), n)
        names[key] = names.get(key, 0) + 1
    biased = (missing[..., :levels] >= 2).any()
    seen = bool(kernels)
    ok = (len(calls) == 1 and sc == 1 and inv == len(plan)
          and torch.equal(got, want)
          and (calls[0][4] is not None) == bool(biased)
          and (not seen or (sum(names.values()) == 1 + len(plan)
                            and names.get(SCATTER_NAME) == 1))
          and sum("HtoD" in n for n in copies) <= 1
          and not any("DtoD" in n for n in copies))
    progress(f"timing: tail gate {label} {tuple(coeffs.shape)}: launches "
             f"scatter {sc}, kernel 16 {inv} (plan {len(plan)}); CUDA "
             f"kernels {names if seen else 'not recorded by the profiler'}; "
             f"copies {copies}; bias table to kernel 16: "
             f"{calls[0][4] is not None} (planes missing: {bool(biased)}); "
             f"eager passes refused: {[n for _, n in eager]}")
    if not ok:
        raise AssertionError(f"tail gate {label}: the decode tail is not the "
                             f"scatter and kernel 16 alone")


def tail_turns(torch, img: np.ndarray, parent: str | None,
               card: str) -> None:
    """``tools/tail_split.py``'s split of the decode tail of the 4K frame,
    the preview and a 16K tile group: the means of three runs, each pass
    by the host clock between synchronised marks and by CUDA events, and
    the unmarked tail, on inputs parsed by this tree, for this tree's
    decoder and, where ``parent`` names a checkout, its decoder in turns
    (this tree, the parent, the parent, this tree)."""
    from dwt_tpu_torch.codec import decoder, encoder, tiled

    mod = tool("tail_split")
    decs, order = {"this tree": decoder}, ["this tree"]
    if parent:
        decs["parent"] = parent_module(parent, "codec.decoder")
        order = ["this tree", "parent", "parent", "this tree"]
    prefix = encoder.get_encoder(W, H, C).encode(img)[:PREFIX_BYTES]
    _, _, gray, coeffs, missing, levels = decoder._parse(
        prefix, 0, torch.device("cuda"))
    tail_gate(torch, decoder, "lossy 4K prefix", (W, H, levels, C, gray),
              coeffs.cuda()[None], missing[None])
    del coeffs
    for inp in mod.inputs(torch, decoder, encoder, tiled, img):
        tail_gate(torch, decoder, inp[0], *inp[1:])
        runs = [f"{name}: {mod.line(mod.split(torch, decs[name], inp, 3))}"
                for name in order]
        progress(f"timing: the decode tail by pass, {inp[0]} "
                 f"{tuple(inp[2].shape)}: " + " | ".join(runs) + f" on {card}")
    torch.cuda.empty_cache()


def lift_split(torch, imgs: np.ndarray) -> str:
    """One forward transform of ``imgs`` launch by launch: each launch's
    device time (``launch_ms``) with the levels it lifts, their sum, and
    the call's CUDA-event time, or "not measured" where the profiler
    dropped kernel events."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import lifting

    x = torch.as_tensor(imgs, device="cuda")
    pyr = compute_pyramid(imgs.shape[2], imgs.shape[1])
    groups = lifting.launch_levels(pyr)

    def fn():
        return lifting.forward_transform(x, pyr, True)

    ms = launch_ms(torch, fn, "lift_", len(groups))
    events = f"events {time_ms(torch, fn, reps=20):.4f} ms"
    if ms is None:
        return f"not measured (the profiler dropped kernel events); {events}"
    return "; ".join(f"levels {list(g)} from {pyr.widths[g[0]]}x"
                     f"{pyr.heights[g[0]]} {m:.4f} ms"
                     for g, (_, m) in zip(groups, ms)) \
        + f"; device {sum(m for _, m in ms):.4f} ms, {events}"


# Kernel 16 in phase 6: (label, (N, H, W, C) seeded coefficients as the
# decoder hands them over, ``decoder_args``): the preview's 480x270 and
# the 16K tiled decode's two tile groups (480 of 512x512, 30 of 448x512),
# beside the 4K decode's kept call.
UNLIFT_SHAPES = (("preview", (1, 270, 480, 3)),
                 ("16K tile group", (480, 512, 512, 3)),
                 ("16K edge tile group", (30, 448, 512, 3)))


def unlift_device(torch, kept: tuple, rows: list) -> None:
    """Phase 6, kernel 16 launch by launch: each launch's device time
    (torch.profiler, means of 20 calls) with the levels it lifts, their
    sum and the call's CUDA-event time, beside the bound by bytes without
    and with the LL buffers: the 4K decode's kept call and seeded
    coefficients of ``UNLIFT_SHAPES`` (the work does not depend on the
    values), each also held against its plain version.  The 4K sum goes
    into kernel 16's row as ``device_ms``, the 480-tile group as its batch
    column."""
    from dwt_tpu_torch.ops import lifting

    gen = torch.Generator(device="cuda").manual_seed(16)
    calls = [("4K", kept)]
    for label, (n, h, w, c) in UNLIFT_SHAPES:
        calls.append((label, decoder_args(torch, gen, n, h, w, c)))
    r = next(r for r in rows if r["name"] == "inverse_transform")
    for label, args in calls:
        chain = args[1]
        groups = [p.levels for p in lifting.plan_of(*args[:4])]
        err = max_abs_err("inverse_transform",
                          lifting.inverse_transform(*args),
                          lifting.inverse_transform_plain(*args))
        if err:
            raise AssertionError(f"inverse_transform {label}: kernel differs "
                                 f"from its plain version (max abs err "
                                 f"{err})")
        torch.cuda.empty_cache()

        def fn():
            return lifting.inverse_transform(*args)

        ev = kernel_events(torch, fn, "inverse_", 20, len(groups))
        events = time_ms(torch, fn, reps=20)
        nbytes = inverse_work(torch, args)[0]
        bound, with_ll = (bound_of(nbytes)[0],
                          bound_of(nbytes + ll_bytes(args))[0])
        if ev is None:
            ms, parts = float("nan"), "not measured (the profiler dropped " \
                "kernel events)"
        else:
            per = [sum(ev[k * len(groups) + i][1] for k in range(20)) / 20e3
                   for i in range(len(groups))]
            ms = sum(per)
            parts = "; ".join(
                f"levels {list(g)} to {chain[g[-1] - 1][1]}x"
                f"{chain[g[-1] - 1][0]} ("
                + ("tail" if "inverse_tail" in ev[i][0] else "level")
                + f") {m:.4f} ms" for i, (g, m) in enumerate(zip(groups,
                                                                per)))
        progress(f"device: inverse_transform {label} "
                 f"{tuple(args[0].shape)}, equal to its plain version: "
                 f"{parts}; device {ms:.4f} ms, events {events:.4f} ms; "
                 f"bound {bound:.4f} ms by bytes ({nbytes} B; share "
                 f"{bound / ms:.2f}), {with_ll:.4f} ms with the LL buffers")
        if label == "4K":
            r["device_ms"] = ms
        elif label == "16K tile group":
            r.update(batch_launches=len(groups), batch_ms=events,
                     batch_bound_ms=bound, batch_device_ms=ms)
        del args, fn
        torch.cuda.empty_cache()


def unlift_stamps(parent: str | None, card: str) -> None:
    """Phase 6, kernel 16 inside its launches: ``tools/inverse_stamps.py``
    (the kernel built alone with ``-DDWT_STAMPS``) on this tree and, where
    ``parent`` names a checkout, on the parent's kernel, in processes of
    their own: each launch's device time, the tail's phases (table set-up,
    loads, each level, store) and the finest level's warps' phases
    (prologue, load issue, column walk, row shuffles, store) at 4K, the
    preview's 480x270 and a 16K tile group of 480 512x512 tiles."""
    for name, root in (("this tree", ROOT), ("parent", parent)):
        if root is None:
            progress("device: kernel 16's stamps of a parent not measured (no "
                     "--parent given)")
            continue
        r = subprocess.run([sys.executable, os.path.join(
            ROOT, "tools", "inverse_stamps.py"), "--root", root, "--reps",
            "10"], capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"inverse_stamps on {name} exited "
                                 f"{r.returncode}:\n{r.stderr[-3000:]}")
        for line in r.stdout.splitlines():
            progress(f"device: kernel 16's stamps, {name}: {line} on {card}")


def small_tiles(torch, K: Kernels, tiled, parent: str | None) -> None:
    """Phase 3b, sub-batches within stage 2's int32 indices: a
    ``SMALL_SIDE`` square RGB frame in ``SMALL_TILE`` tiles, one geometry
    of more tiles than one sub-batch holds.  The pixel bound alone made
    them one sub-batch, which ``_check_batch`` refuses (shown on the
    host); ``encode_tiled`` now makes two (``BatchEncoder.max_frames``),
    each launching every encode kernel (counts reset and read).  Gates:
    the container equals the same frame's encoded ``SMALL_SUB`` tiles a
    sub-batch, ``decode_tiled`` of it gives the frame back, and stage 1's
    kernels and kernel 15 equal their plain versions on the first 256
    tiles.  Where ``parent`` names a checkout, its ``encode_tiled`` of the
    frame must give the same container, and both are timed in turns."""
    from dwt_tpu_torch.codec import emit, encoder, stage1
    from dwt_tpu_torch.ops import lifting, plane_stats, schedule, units

    t0 = time.perf_counter()
    img = random_image(SMALL_SIDE, SMALL_SIDE, C, seed=1)
    th, tw = SMALL_TILE
    groups, n_tiles = tiled.group_tiles(img, SMALL_TILE)
    enc = tiled.get_batch_encoder(tw, th, C, None)  # encode_tiled's
    pyr, nlin = enc.pyr, enc.enc._src.numel()
    old = enc.MAX_PIXELS_PER_DISPATCH // pyr.total
    bucket = encoder._bucket(encoder.max_tokens(pyr, C))
    try:
        encoder._check_batch(min(old, n_tiles), nlin, pyr, C, bucket)
        raise AssertionError(f"{n_tiles} {tw}x{th} tiles fit one sub-batch")
    except ValueError as e:
        refused = str(e)
    sub = min(old, enc.max_frames)
    nsub = -(-n_tiles // sub)
    K.reset()
    kept = []  # kernel 17's calls, one a sub-batch
    t1 = time.perf_counter()
    with wrapped(emit, "emit_tables", lambda fn: lambda *a: (kept.append(
            tuple(x.clone() if hasattr(x, "clone") else x for x in a)),
            fn(*a))[1]):
        full = tiled.encode_tiled(img, tile=SMALL_TILE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = K.counts()
    K.check_launched("tiled encode", counts)
    want = {k: n * nsub for k, n in sub_batch_launches(pyr).items()}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"small tiles: launches {counts}, want {want}")
    enc.MAX_PIXELS_PER_DISPATCH = SMALL_SUB * pyr.total
    try:
        ref = tiled.encode_tiled(img, tile=SMALL_TILE)
    finally:
        del enc.MAX_PIXELS_PER_DISPATCH
    if ref != full:
        raise AssertionError(f"small tiles: the container differs from the "
                             f"one of {SMALL_SUB} tiles a sub-batch")
    out, gray = tiled.decode_tiled(full)
    if gray or not np.array_equal(out, img):
        raise AssertionError("small tiles: the decode differs from the frame")
    x = torch.as_tensor(np.stack([t for _, t in groups[SMALL_TILE][:256]]),
                        device="cuda")
    coeff = lifting.forward_transform(x, pyr, True)
    err = max_abs_err("forward_transform", coeff,
                      lifting.forward_transform_plain(x, pyr, True))
    lin = stage1._linearize(coeff, enc.enc._src, pyr, C)
    segs = stage1.segs_for(pyr, lin.device)
    args = (lin.reshape(-1, nlin), segs.valid_t, segs.idx_local,
            segs.block_chunk, segs.unit_chunk_t, segs.chunk_base_t)
    err = max(err, max_abs_err("plane_stats", plane_stats.plane_stats(*args),
                               plane_stats.plane_stats_plain(*args)))
    n = x.shape[0]
    planes, *tabs = plane_stats.plane_stats(*args)
    args = (planes.reshape(n, C),
            *(t.reshape(n, C, *t.shape[1:]) for t in tabs),
            lin[:, :, :pyr.pixels[0]], segs.real_t, segs.level_chunk_base_t,
            segs.level_nchunk_t)
    got = schedule.schedule(*args)
    err = max(err, max_abs_err("schedule", got,
                               schedule.schedule_plain(*args)))
    st = dict(zip(schedule.OUT_KEYS, got))
    args = (st["order"], st["ubase_sched"], st["valid_sched"],
            st["step_base"], st["nS_ck"], st["scar_ck"], st["zcar_ck"],
            segs.level_chunk_base_t, segs.ch_start_t, segs.ch_len_t, segs.n,
            encoder._bucket(int(st["T"].max())))
    err = max(err, max_abs_err("unit_tables", units.unit_tables(*args),
                               units.unit_tables_plain(*args)))
    if err:
        raise AssertionError(f"small tiles: a stage-1 kernel differs from "
                             f"its plain version (max abs err {err})")
    held = K.hold({"emit_tables": kept})
    frames17 = [a[0].shape[0] for a in kept]
    big = max(kept, key=lambda a: a[0].shape[0])
    progress("timing: small tiles, kernel 17 on the larger sub-batch, in "
             "turns: " + emit_turns(torch, big, parent))
    del kept, big
    progress(f"e2e: small tiles: {SMALL_SIDE}x{SMALL_SIDE}x{C} in {tw}x{th} "
             f"tiles, {n_tiles} of one geometry; one sub-batch of them is "
             f"refused ({refused}); encode_tiled in {nsub} sub-batches of "
             f"{sub} at most -> {len(full)} bytes in {secs:.2f} s, launches "
             f"{counts}; equal to the container of {SMALL_SUB} tiles a "
             f"sub-batch; decode_tiled gives the frame back; the transform, "
             f"the plane statistics, the schedule and the unit tables equal "
             f"their plain versions on 256 tiles, kernel 17 on its "
             f"{held['emit_tables']} calls of {frames17} frames; "
             f"{time.perf_counter() - t0:.1f} s")
    if parent:
        progress("timing: small tiles, encode_tiled in turns with the "
                 "parent: " + tiled_turns(torch, tiled, parent, img,
                                          SMALL_TILE, 0, full))


def tiled_turns(torch, tiled, parent: str, img: np.ndarray, tile: tuple,
                budget: int, want: bytes) -> str:
    """``encode_tiled`` of ``img`` by this tree and by the checkout at
    ``parent`` in turns (this tree, the parent, the parent, this tree),
    after one warm call each, by the host clock, synchronised; each
    container must equal ``want``."""
    fns = {"this tree": tiled.encode_tiled,
           "parent": parent_module(parent, "codec.tiled").encode_tiled}
    mp = img.shape[0] * img.shape[1] / 1e6
    times = []
    for name in ("this tree", "parent", "parent", "this tree"):
        if name not in [n for n, _ in times]:
            fns[name](img, tile=tile, budget=budget)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fns[name](img, tile=tile, budget=budget)
        torch.cuda.synchronize()
        times.append((name, time.perf_counter() - t0))
        if out != want:
            raise AssertionError(f"{name}'s encode_tiled differs from this "
                                 f"tree's first")
    return "; ".join(f"{n} {1e3 * t:.1f} ms ({mp / t:.2f} MP/s)"
                     for n, t in times)


def uhd16k_turns(torch, tiled, parent: str, card: str) -> None:
    """The benchmark's ``uhd16k-tiled`` encode (a 15360x8640 RGB frame,
    "mixed", seed 0, in 512x512 tiles at a third of its lossless
    container) by this tree and by the checkout at ``parent`` in turns;
    both must give the same container."""
    t0 = time.perf_counter()
    img = random_image(15360, 8640, C, seed=0)
    full = tiled.encode_tiled(img, tile=TILE)
    budget = len(full) // 3
    cut = tiled.encode_tiled(img, tile=TILE, budget=budget)
    progress(f"timing: 16K frame made and encoded lossless ({len(full)} "
             f"bytes), {time.perf_counter() - t0:.1f} s")
    progress(f"timing: 15360x8640 encode_tiled in {TILE} tiles at budget "
             f"{budget}, in turns with the parent: "
             + tiled_turns(torch, tiled, parent, img, TILE, budget, cut)
             + f" on {card}")


def sha256_pixels(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def lossy_decodes(torch, K: Kernels, decoder, stream: bytes) -> None:
    """Phase 3's two lossy decodes, held to the JAX package's pixels; each
    runs with the launch counts reset before and read after, and its
    scatter call is held against the plain version."""
    prefix = stream[:PREFIX_BYTES]
    for name, s, px, shape, want in (
            ("prefix", prefix, 0, PREFIX_SHAPE, PREFIX_SHA256),
            ("reduced", stream, REDUCED_PIXELS, REDUCED_SHAPE,
             REDUCED_SHA256)):
        missing = decoder._parse(s, px, torch.device("cuda"))[4]
        store, counts = {}, {}
        with K.path("decode", store, counts):
            out, _ = decoder.decode(s, px)
        digest = sha256_pixels(out)
        progress(f"e2e: {name} decode kernels equal to their plain "
                 f"versions: {held_line(K.hold(store))}")
        progress(f"e2e: {name} decode ({len(s)} bytes, pixels_max={px}) "
                 f"-> {out.shape}, sha256 {digest[:16]}; most planes "
                 f"missing at a level {int(missing.max())}")
        if name == "prefix" and not (missing >= 2).any():
            raise AssertionError("the prefix leaves no level two or more "
                                 "planes short: the midpoint bias would "
                                 "not run")
        if out.shape != shape or digest != want:
            raise AssertionError(
                f"{name} decode differs from the JAX package's: {out.shape} "
                f"sha256 {digest} (want {shape} {want})")


def root_only_decode(torch, K: Kernels, decoder, stream: bytes) -> None:
    """Phase 3's root-only decode: ``pixels_max`` at the root band's pixel
    count, so that the decoder lifts the root band alone (decode.c:258
    quirk): kernel 16 once, on the chain of the root size, held against
    its plain version, and the image against the same stream decoded with
    ``device="cpu"``.  The scatter has no work on this route."""
    from dwt_tpu_torch.geometry import compute_pyramid

    px = compute_pyramid(W, H).pixels[0]
    store, counts = {}, {}
    with K.path("decode", store, counts, exempt=("hilbert_scatter",)):
        out, _ = decoder.decode(stream, px)
    want, _ = decoder.decode(stream, px, device="cpu")
    progress(f"e2e: root-only decode (pixels_max={px}) -> {out.shape}; "
             f"launches {counts}; kernels equal to their plain versions: "
             f"{held_line(K.hold(store))}; equal to the CPU decode: "
             f"{bool(np.array_equal(out, want))}")
    if counts["inverse_transform"] != 1 or out.shape != want.shape \
            or not np.array_equal(out, want):
        raise AssertionError("the root-only decode on the card differs from "
                             "the CPU decode or is not one launch of kernel "
                             "16")


def decode_profile(torch, decoder, stream: bytes, img: np.ndarray) -> None:
    """Where one warm 4K decode spends its time, host clock with a
    synchronise after each step: host parse (into a zeroed pinned buffer,
    whose allocation and zeroing are also timed alone), upload, device
    tail, download.  Then the tail once under torch.profiler: its device
    busy time and the scatter kernel's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    torch.zeros((C, W * H), dtype=torch.int32, pin_memory=True)
    zero_ms = 1e3 * (time.perf_counter() - t0)
    marks = [time.perf_counter()]
    w, h, gray, coeffs, missing, levels = decoder._parse(stream, 0, dev)
    marks.append(time.perf_counter())
    x = coeffs.to(dev, non_blocking=True)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    tail = decoder._tail(w, h, levels, C, gray, dev)
    y = tail(x, missing)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    out = y.cpu().numpy()
    marks.append(time.perf_counter())
    if not np.array_equal(out, img):
        raise AssertionError("the profiled decode differs from the frame")
    ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    progress(f"profile: one warm 4K decode: host parse {ms[0]:.1f} ms "
             f"(pinned zeroed buffer alone {zero_ms:.1f} ms), upload "
             f"{ms[1]:.1f} ms ({x.numel() * 4 / ms[1] / 1e6:.1f} GB/s), "
             f"device tail {ms[2]:.1f} ms, download {ms[3]:.1f} ms "
             f"(host clock, synchronised)")
    for i in range(2):  # the first pays the profiler's start-up
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tail(x, missing)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    busy = busy_ms(events, DeviceType)
    sc = sum(e.time_range.elapsed_us() for e in events
             if e.device_type == DeviceType.CUDA
             and SCATTER_NAME in e.name) / 1e3
    if 0 < busy <= wall and sc > 0:
        progress(f"profile: decode tail under torch.profiler: device busy "
                 f"{busy:.2f} ms of {wall:.2f} ms wall; scatter kernel "
                 f"{sc:.3f} ms, {sc / busy:.3f} of the busy time")
    else:
        progress(f"profile: decode tail device time not measured (busy "
                 f"{busy:.2f} ms, scatter {sc:.3f} ms, wall {wall:.2f} ms)")


def held_line(held: dict) -> str:
    return ", ".join(f"{name} x{n}" for name, n in held.items())


def capacity_encode(K: Kernels, enc, img, stream: bytes,
                    tokens: int) -> None:
    """Phase 3's capacity encode: the 1,000,000-byte budget must give the
    lossless stream's prefix while coding fewer tokens; its kernels are
    held against their plain versions on its own inputs."""
    store, counts = {}, {}
    t0 = time.perf_counter()
    with K.path("capacity encode", store, counts):
        s, info = enc.encode_with_stats(img, CAPACITY)
    secs = time.perf_counter() - t0
    progress(f"e2e: capacity encode ({CAPACITY} bytes) -> {len(s)} bytes, "
             f"T={info['tokens']} (lossless {tokens}), {secs:.3f} s "
             f"(kernel inputs kept); launches {counts}")
    if s != stream[:CAPACITY] or not info["tokens"] < tokens:
        raise AssertionError("the capacity encode is not the lossless "
                             "stream's prefix with fewer tokens")
    progress(f"e2e: capacity encode kernels equal to their plain versions: "
             f"{held_line(K.hold(store))}")


def tiled_paths(torch, K: Kernels, tiled, img: np.ndarray) -> tuple:
    """Phase 3's tiled paths: the lossless and the budgeted container held
    to the JAX package's digests, then the lossless container decoded back
    to the frame and the budgeted one to the JAX package's pixels.  Each
    path runs with the launch counts reset before and read after, and
    each kernel call it kept (one for each set of input shapes) is held
    against its plain version.  Returns the lossless container and the
    scatter calls its decode kept."""
    from dwt_tpu_torch.geometry import compute_pyramid

    def run(name, fn):
        store, counts = {}, {}
        t0 = time.perf_counter()
        with K.path(name, store, counts):
            result = fn()
        secs = time.perf_counter() - t0
        return result, secs, counts, store

    def held(name, store):
        progress(f"e2e: {name} kernels equal to their plain versions: "
                 f"{held_line(K.hold(store))}")

    full, secs, counts, store = run(
        "tiled encode", lambda: tiled.encode_tiled(img, tile=TILE))
    digest = hashlib.sha256(full).hexdigest()
    shapes = tiled.group_tiles(img, TILE)[0]
    groups = len(shapes)
    progress(f"e2e: tiled encode {TILE} -> {len(full)} bytes, sha256 "
             f"{digest[:16]}, {secs:.2f} s cold; launches {counts} (one "
             f"sub-batch for each of the {groups} tile geometries)")
    if (len(full), digest) != (TILED_BYTES, TILED_SHA256):
        raise AssertionError(f"tiled container differs from the JAX "
                             f"package's: {len(full)} bytes, sha256 {digest}")
    # Each tile geometry one sub-batch, its transform's launches from its
    # pyramid.
    want = {k: sum(sub_batch_launches(compute_pyramid(ww, hh))[k]
                   for hh, ww in shapes) for k in BATCH_KERNELS}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"the tiled encode's launches {counts} are not "
                             f"one a tile geometry: want {want}")
    held("tiled encode", store)

    budget = len(full) // 3
    reemitted = []
    with wrapped(tiled, "_reemit", counted(reemitted)):
        cut, secs, counts, store = run(
            "budgeted tiled encode",
            lambda: tiled.encode_tiled(img, tile=TILE, budget=budget))
    digest = hashlib.sha256(cut).hexdigest()
    progress(f"e2e: tiled encode, budget {budget} -> {len(cut)} bytes, "
             f"sha256 {digest[:16]}, {secs:.2f} s; {len(reemitted)} of "
             f"{tiled.group_tiles(img, TILE)[1]} tiles emitted again "
             f"unmasked; launches {counts}")
    if (len(cut), digest) != (TILED_CUT_BYTES, TILED_CUT_SHA256):
        raise AssertionError(f"budgeted tiled container differs from the "
                             f"JAX package's: {len(cut)} bytes, sha256 "
                             f"{digest}")
    held("budgeted tiled encode", store)

    (out, gray), secs, counts, store = run(
        "tiled decode", lambda: tiled.decode_tiled(full))
    tiled_scatter = store["hilbert_scatter"]
    progress(f"e2e: tiled decode -> {out.shape} gray={gray}, {secs:.2f} s; "
             f"launches {counts}")
    if gray or not np.array_equal(out, img):
        raise AssertionError("the tiled decode differs from the frame")
    held("tiled decode", store)

    (out, _), secs, counts, store = run(
        "budgeted tiled decode", lambda: tiled.decode_tiled(cut))
    digest = sha256_pixels(out)
    progress(f"e2e: budgeted tiled decode -> {out.shape}, sha256 "
             f"{digest[:16]}, {secs:.2f} s; launches {counts}")
    if out.shape != img.shape or digest != TILED_CUT_PIXELS_SHA256:
        raise AssertionError(f"budgeted tiled decode differs from the JAX "
                             f"package's: {out.shape} sha256 {digest}")
    held("budgeted tiled decode", store)
    return full, tiled_scatter


@contextlib.contextmanager
def wrapped(obj, name: str, wrap):
    """Replace ``obj.name`` by ``wrap(obj.name)`` for the block."""
    fn = getattr(obj, name)
    setattr(obj, name, wrap(fn))
    try:
        yield
    finally:
        setattr(obj, name, fn)


def counted(calls: list):
    """A wrap for :func:`wrapped` that notes each call in ``calls``."""
    return lambda fn: lambda *a: (calls.append(1), fn(*a))[1]


def tiled_timing(torch, tiled, img: np.ndarray, full: bytes,
                 card: str) -> None:
    """Phase 5's tiled rates: three warm tiled encodes, lossless and cut to
    a third, and decodes of the frame, then one ``decode_tiled`` split by timers wrapped around its own
    calls (host clock): the thread-pooled host parse
    (``native.entropy_decode_batch``), the upload (from the parse's return
    to the synchronised start of the batched tail that follows it), the
    batched tails (``_Tail.batch``, synchronised) and the rest (download
    and mosaic)."""
    from dwt_tpu_torch.codec import decoder
    from dwt_tpu_torch.runtime import native

    enc_mps, cut_mps, dec_mps = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        s = tiled.encode_tiled(img, tile=TILE)
        enc_mps.append(W * H / 1e6 / (time.perf_counter() - t0))
        if s != full:
            raise AssertionError("a warm tiled encode differs from the first")
    for _ in range(3):
        t0 = time.perf_counter()
        s = tiled.encode_tiled(img, tile=TILE, budget=len(full) // 3)
        cut_mps.append(W * H / 1e6 / (time.perf_counter() - t0))
        if hashlib.sha256(s).hexdigest() != TILED_CUT_SHA256:
            raise AssertionError("a warm budgeted tiled encode differs from "
                                 "the JAX package's container")
    for _ in range(3):
        t0 = time.perf_counter()
        out, _ = tiled.decode_tiled(full)
        dec_mps.append(W * H / 1e6 / (time.perf_counter() - t0))
        if not np.array_equal(out, img):
            raise AssertionError("a warm tiled decode differs from the frame")
    progress(f"timing: warm 4K tiled encode "
             f"{', '.join(f'{m:.2f}' for m in enc_mps)} MP/s, budgeted "
             f"tiled encode (a third) "
             f"{', '.join(f'{m:.2f}' for m in cut_mps)} MP/s, decode "
             f"{', '.join(f'{m:.2f}' for m in dec_mps)} MP/s on {card}")

    split = dict(parse=0.0, upload=0.0, tails=0.0)
    parsed = []  # the parse's return time, until a tail starts

    def parse(fn):
        def run(*args):
            t0 = time.perf_counter()
            result = fn(*args)
            parsed.append(time.perf_counter())
            split["parse"] += parsed[-1] - t0
            return result
        return run

    def tail(fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if parsed:
                split["upload"] += t0 - parsed.pop()
            result = fn(*args)
            torch.cuda.synchronize()
            split["tails"] += time.perf_counter() - t0
            return result
        return run

    with wrapped(native, "entropy_decode_batch", parse), \
            wrapped(decoder._Tail, "batch", tail):
        t0 = time.perf_counter()
        out, _ = tiled.decode_tiled(full)
        total = time.perf_counter() - t0
    if not np.array_equal(out, img):
        raise AssertionError("the split tiled decode differs from the frame")
    ms = {k: 1e3 * v for k, v in split.items()}
    progress(f"profile: one warm 4K tiled decode, {1e3 * total:.1f} ms "
             f"(parser threads = {os.cpu_count()} cores): host parse "
             f"{ms['parse']:.1f} ms, upload {ms['upload']:.1f} ms, batched "
             f"tails {ms['tails']:.1f} ms, rest (download, mosaic) "
             f"{1e3 * total - sum(ms.values()):.1f} ms (host clock, "
             f"synchronised)")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def traffic() -> str:
    """The collectives logged by ``hosts`` since it was last cleared, by
    kind: count and bytes."""
    from dwt_tpu_torch.parallel import hosts

    kinds: dict = {}
    for op, nbytes in hosts.comm_log:
        n, b = kinds.get(op, (0, 0))
        kinds[op] = (n + 1, b + nbytes)
    hosts.comm_log.clear()
    return ", ".join(f"{op} x{n} {b} B" for op, (n, b) in kinds.items()) \
        or "none"


def sharded_routes(torch, K: Kernels, mesh, img: np.ndarray,
                   stream: bytes) -> tuple:
    """Phase 7's routes on ``mesh``, each in ``Kernels.path`` (its kernels
    held against their plain versions) and held to the gates of its
    single-device twin; raises on any difference.  Returns the sharded
    encoder and decoder, the halo levels' kept calls of the first encode
    and decode ({kernel: [args, ...]}) and their launches there."""
    from dwt_tpu_torch.parallel import encode as sharded

    tag = f"rank {mesh.rank}/{mesh.size} on {mesh.device}"
    halo_kept, halo_launches = {}, {}

    def run(name, fn, exempt=()):
        store, counts = {}, {}
        t0 = time.perf_counter()
        with K.path(name, store, counts, exempt):
            result = fn()
        secs = time.perf_counter() - t0
        for k in ("halo_forward", "halo_inverse"):
            if k in store and k not in halo_kept:
                halo_kept[k], halo_launches[k] = store[k], counts[k]
        progress(f"sharded: {tag}: {name} {secs:.2f} s; launches {counts}; "
                 f"collectives {traffic()}; kernels equal to their plain "
                 f"versions: {held_line(K.hold(store))}")
        return result

    enc = sharded.ShardedEncoder(W, H, C, mesh)
    s = run("sharded encode", lambda: enc.encode(img))
    digest = hashlib.sha256(s).hexdigest()
    if (len(s), digest) != (REF_BYTES, REF_SHA256):
        raise AssertionError(f"{tag}: the sharded stream differs from the "
                             f"JAX package's: {len(s)} bytes, sha256 {digest}")
    dec = sharded.ShardedDecoder(W, H, C, mesh)
    # Where the coarse region is the root band alone, the sharded decode
    # has no coarse tail to lift: kernel 16 has no work on it.
    exempt = () if dec._sub_pyr is not None else ("inverse_transform",)
    progress(f"sharded: {tag}: the coarse tail is "
             + (f"{dec._sub_pyr.levels} level(s) of kernel 16 from "
                f"{dec._sub_pyr.width}x{dec._sub_pyr.height}"
                if dec._sub_pyr is not None else
                "the root band alone: kernel 16 has no launch to make there"))
    out = run("sharded decode", lambda: dec.decode(stream), exempt)
    if not np.array_equal(out, img):
        raise AssertionError(f"{tag}: the sharded decode differs from the "
                             f"frame")
    out = run("sharded decode", lambda: dec.decode(stream[:PREFIX_BYTES]))
    if out.shape != PREFIX_SHAPE or sha256_pixels(out) != PREFIX_SHA256:
        raise AssertionError(f"{tag}: the sharded prefix decode differs from "
                             f"the JAX package's: {out.shape} sha256 "
                             f"{sha256_pixels(out)}")
    for name, budget, want in (
            ("sharded tiled encode", 0, (TILED_BYTES, TILED_SHA256)),
            ("budgeted sharded tiled encode", TILED_BYTES // 3,
             (TILED_CUT_BYTES, TILED_CUT_SHA256))):
        s = run(name, lambda: sharded.encode_tiled_sharded(
            img, mesh, tile=TILE, budget=budget))
        got = (len(s), hashlib.sha256(s).hexdigest())
        if got != want:
            raise AssertionError(f"{tag}: {name} differs from the JAX "
                                 f"package's container: {got}")
    progress(f"sharded: {tag}: every route equal to its gate (stream, frame, "
             f"prefix pixels, both containers)")
    return enc, dec, halo_kept, halo_launches


def sharded_timing(torch, mesh, enc, dec, img: np.ndarray, stream: bytes,
                   card: str) -> None:
    """Warm rates of the sharded routes at world size 1, each in turns
    with its single-device twin (MP/s of 3840x2160 pixels by the host
    clock, three of each)."""
    from dwt_tpu_torch.codec import decoder, tiled
    from dwt_tpu_torch.codec.encoder import get_encoder
    from dwt_tpu_torch.parallel import encode as sharded

    single = get_encoder(W, H, C)
    pairs = (
        ("encode", lambda: single.encode(img), lambda: enc.encode(img)),
        ("decode", lambda: decoder.decode(stream)[0],
         lambda: dec.decode(stream)),
        ("tiled encode", lambda: tiled.encode_tiled(img, tile=TILE),
         lambda: sharded.encode_tiled_sharded(img, mesh, tile=TILE)))
    parts = []
    for name, one, shard in pairs:
        rates = {"single": [], "sharded": []}
        for _ in range(3):
            for kind, fn in (("single", one), ("sharded", shard)):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                rates[kind].append(W * H / 1e6 / (time.perf_counter() - t0))
        sharded_mps, single_mps = (", ".join(f"{m:.2f}" for m in rates[k])
                                   for k in ("sharded", "single"))
        parts.append(f"{name} sharded {sharded_mps} (single {single_mps})")
    progress(f"timing: warm 4K sharded routes at world size {mesh.size} on "
             f"NCCL, MP/s: {'; '.join(parts)} on {card}")


@contextlib.contextmanager
def timed_calls(torch, targets, spent: dict):
    """Within the block, time each ``getattr(obj, name)`` call of
    ``targets`` (a list of (obj, name)) by the host clock with a
    synchronise on each side, summed into ``spent[name]`` (ms)."""
    def timer(name):
        def wrap(fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = fn(*args, **kwargs)
                torch.cuda.synchronize()
                spent[name] = spent.get(name, 0.0) + 1e3 * (
                    time.perf_counter() - t0)
                return result
            return run
        return wrap

    with contextlib.ExitStack() as stack:
        for obj, name in targets:
            stack.enter_context(wrapped(obj, name, timer(name)))
        yield


def sharded_profile(torch, enc, dec, img: np.ndarray, stream: bytes,
                    tree: str = "this tree") -> None:
    """Where one warm sharded encode and one warm sharded decode spend
    their time, by timers around their own calls (host clock,
    synchronised); the rest is what the timers do not cover.  ``enc`` and
    ``dec`` may be a parent tree's (``tree`` names it): the calls timed are
    those its modules have (before kernels 18 and 19 the encode's
    ``rgb_to_ycocg`` ran apart, and the decode's colour and clamps in the
    rest)."""
    import importlib

    sharded = sys.modules[type(enc).__module__]
    decoder = importlib.import_module(
        sharded.__name__.rsplit(".parallel", 1)[0] + ".codec.decoder")
    for what, fn, targets, rest in (
            ("encode", lambda: enc.encode(img),
             [(sharded, "rank_rows"), (sharded, "rgb_to_ycocg"),
              (sharded, "halo_dwt2d_fwd"), (sharded, "hilbert_gather"),
              (sharded, "_stats_from_lin"), (enc._enc, "emit_frames")],
             "the fine buffer's all-gather, the coarse placement"),
            ("decode", lambda: dec.decode(stream),
             [(decoder, "_parse"), (decoder._Tail, "pyramid"),
              (sharded, "dwt2d_inv"), (sharded, "halo_dwt2d_inv")],
             "upload, scatter into the halo layout, all-gather, download"
             + ("" if "ycocg_to_rgb" not in vars(sharded) else
                ", colour and clamps"))):
        targets = [(o, n) for o, n in targets if hasattr(o, n)]
        spent: dict = {}
        with timed_calls(torch, targets, spent):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total = 1e3 * (time.perf_counter() - t0)
        progress(f"profile: {tree}: one warm 4K sharded {what}, "
                 f"{total:.1f} ms: "
                 + ", ".join(f"{k} {v:.1f}" for k, v in spent.items())
                 + f", rest ({rest}) {total - sum(spent.values()):.1f} ms "
                 f"(host clock, synchronised)")


def two_rank_worker(rank: int, port: int) -> None:
    """One of two ranks on NCCL (``cuda:0``, ``cuda:1``): the sharded routes
    and their gates on this rank's card (the frame and stream made here)."""
    import torch
    import torch.distributed as dist

    from dwt_tpu_torch.codec.encoder import get_encoder
    from dwt_tpu_torch.parallel import hosts

    hosts.initialize(f"127.0.0.1:{port}", 2, rank)
    try:
        mesh = hosts.global_mesh()
        img = random_image(W, H, C, seed=0)
        stream = get_encoder(W, H, C, mesh.device).encode(img)
        sharded_routes(torch, Kernels(), mesh, img, stream)
        progress(f"sharded: rank {rank}/2: " + halo_exchanges(torch, mesh,
                                                              img))
    finally:
        dist.destroy_process_group()


def two_ranks(torch) -> None:
    """Two ranks on NCCL in spawned processes (``cuda:0``, ``cuda:1``), each
    running the sharded routes and their gates (``two_rank_worker``)."""
    import torch.multiprocessing as mp

    mp.spawn(two_rank_worker, args=(free_port(),), nprocs=2, join=True)
    progress("sharded: two ranks on NCCL (cuda:0, cuda:1): every route "
             "equal to its gate on both, the halo kernels' exchanges equal "
             "to the plain route's")


# Kernels 18 and 19 on seeded images (w, h, C): odd and even sides, strips
# of 28 columns and the pair's tiles of 504 cut anywhere, widths below a
# tile, pad rows, plans of one level and of the deepest, the pair with
# the fewest rows it takes (513x16), the 4K frame; each at 1-3 ranks
# played on the card
# (``tiled.play_ranks``), as uint8 RGB (or gray) rows with the colour and
# uint8 pixels out, as uint8 rows with int32 out, and as signed int32 rows.
HALO_SWEEP = ((64, 64, 3), (63, 64, 1), (64, 63, 3), (17, 1024, 1),
              (200, 37, 3), (31, 270, 3), (8, 8, 1), (513, 8, 3),
              (1001, 777, 3), (1001, 77, 3), (100, 600, 1), (513, 16, 3),
              (3840, 2160, 3))
HALO_FWD_NAME, HALO_INV_NAME = "halo_fwd_kernel", "halo_inv_kernel"


def halo_sweep(torch) -> str:
    """Kernels 18 and 19 against their plain versions on ``HALO_SWEEP``
    (exact), every mode of both, every rank of 1-3 played on the card
    (``tiled.play_forward``, ``play_inverse``; both inverses of the
    kernels' fine buffer); each inverse gives the image back."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import halo
    from dwt_tpu_torch.parallel import tiled

    gen = torch.Generator(device="cuda").manual_seed(29)
    cases = 0
    for w, h, c in HALO_SWEEP:
        u8 = torch.randint(0, 256, (h, w, c), dtype=torch.uint8,
                           device="cuda", generator=gen)
        i32 = torch.randint(-255, 256, (h, w, c), dtype=torch.int32,
                            device="cuda", generator=gen)
        for n in (1, 2, 3):
            for img, colour, to_bytes in ((u8, c == 3, True),
                                          (u8, False, False),
                                          (i32, False, False)):
                pyr = compute_pyramid(w, h)
                got, want = ((*tiled.play_forward(img, pyr, n, colour, fwd),)
                             for fwd in (halo.halo_forward,
                                         halo.halo_forward_plain))
                got += (tiled.play_inverse(got[0], pyr, n, to_bytes,
                                           halo.halo_inverse),)
                want += (tiled.play_inverse(got[0], pyr, n, to_bytes,
                                            halo.halo_inverse_plain),)
                torch.cuda.synchronize()
                for what, a, b in zip(("fine buffer", "coarse grid",
                                       "inverse"), got, want):
                    err = max_abs_err("halo", a, b)
                    if err:
                        raise AssertionError(
                            f"halo {w}x{h}x{c} at {n} ranks ({img.dtype}, "
                            f"colour {colour}, bytes {to_bytes}): the "
                            f"kernels' {what} differs from the plain "
                            f"version's (max abs err {err})")
                back = got[2][:h]
                if not torch.equal(back, img.to(back.dtype)):
                    raise AssertionError(f"halo {w}x{h}x{c} at {n} ranks: "
                                         f"the inverse differs from the "
                                         f"image")
                cases += 1
    return (f"kernels 18 and 19 equal to their plain versions (exact) and "
            f"the image back on {cases} cases: {len(HALO_SWEEP)} geometries "
            f"(up to 3840x2160), 1-3 ranks played on the card, uint8 RGB "
            f"with the colour to uint8 pixels, uint8 and int32 to int32")


def halo_fwd_work(calls: list) -> int:
    """The bytes one 4K sharded encode's forward halo launches (their kept
    calls, finest first) must move: the image's rows read once, the fine
    block written once and the coarse grid (the last launch's compact LL)
    written once."""
    src, fine, ll = calls[0][2], calls[0][4], calls[-1][5]
    return (src.numel() * src.element_size() + 4 * fine.numel()
            + 4 * ll.numel())


def halo_inv_work(calls: list) -> int:
    """The bytes one sharded decode's inverse halo launches (coarsest
    first) must move: the fine block read once, the finest level's pixels
    written once."""
    fine, out = calls[0][2], calls[-1][5]
    return 4 * fine.numel() + out.numel() * out.element_size()


def halo_device(card: str) -> dict:
    """``tools/halo_kernels.py`` in a process of its own (a long process's
    profiler sessions lose some of their device records): each launch of
    kernels 18 and 19 in one warm 4K ``halo_dwt2d_fwd`` and
    ``halo_dwt2d_inv`` by torch.profiler, the call's device launches and
    its host time; {wrapper: its JSON line}.  Raises unless each call
    launches its kernel as ``tiled.launch_plan`` plans (seven launches at
    4K) and makes at most three device launches a kernel launch in all."""
    r = subprocess.run([sys.executable, os.path.join(
        ROOT, "tools", "halo_kernels.py")], capture_output=True, text=True,
        timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"halo_kernels exited {r.returncode}:\n"
                             f"{r.stderr[-3000:]}")
    out = {}
    for line in r.stdout.splitlines():
        got = json.loads(line)
        out[got["wrapper"]] = got
        n, k = sum(got["device_launches"].values()), got["kernel_launches"]
        if k != got["planned_launches"] or n > 3 * k:
            raise AssertionError(f"{got['call']}: {k} launches of "
                                 f"{got['kernel']} ({got['planned_launches']}"
                                 f" planned) and {n} device launches")
        progress(f"device: one warm 4K {got['call']} at world size 1 on "
                 f"NCCL: kernel {got['kernel']} by launch (the levels' "
                 f"stride, columns, rows: device ms) "
                 + ", ".join(f"{[tuple(lv) for lv in p['levels']]}: "
                             f"{p['device_ms']:.4f}"
                             for p in got["launches"] or [])
                 + f"; sum {got['device_ms']} ms by torch.profiler (None: "
                 f"records lost); {k} launches of the kernel for "
                 f"{got['halo_levels']} halo levels, {n} device launches in "
                 f"all ({got['device_launches']}, profiler session "
                 f"{got['profiler_session']}); CUDA events "
                 f"{got['event_ms']:.4f} ms; host "
                 + ", ".join(f"{t:.3f}" for t in got["host_ms"])
                 + f" ms (synchronised) on {card}")
    return out


def halo_rows(torch, kept: dict, launches: dict, rows: list,
              device: dict) -> None:
    """Kernels 18 and 19 on the 4K sharded encode's and decode's kept calls
    (world size 1: the pair of the two finest levels, then one "bulk"
    launch a level), replayed in order: held to
    their plain versions, timed by CUDA events beside the plain versions,
    and their bounds, with the device time of ``device``
    (:func:`halo_device`); a row each into ``rows``."""
    from dwt_tpu_torch.ops import halo

    for name, fn, plain, work in (
            ("halo_forward", halo.halo_forward, halo.halo_forward_plain,
             halo_fwd_work),
            ("halo_inverse", halo.halo_inverse, halo.halo_inverse_plain,
             halo_inv_work)):
        calls = kept[name]
        err = max(max_abs_err(name, fn(*map(fresh, args)),
                              plain(*map(fresh, args)))
                  for args in calls)
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version at 4K (max abs err {err})")
        ms = time_ms(torch, lambda: [fn(*a) for a in calls])
        plain_ms = time_ms(torch, lambda: [plain(*a) for a in calls], reps=3)
        dev = device[name]["device_ms"]
        dev = float("nan") if dev is None else dev
        nbytes = work(calls)
        # The compact grids between the launches (the forward's LL
        # quadrants but the last, the inverse's outputs but the finest):
        # each written once, read once.
        ll = sum(8 * a[5].numel() for a in calls[:-1])
        bound, by = bound_of(nbytes)
        row = dict(name=name, route="cuda",
                   source="dwt_tpu_torch/csrc/halo_lifting.cu",
                   replaces=next(r for n, _, _, r, _ in Kernels().rows
                                 if n == name),
                   batch_launches=None, batch_ms=None, batch_bound_ms=None,
                   batch_device_ms=None)
        rows.append(row)
        row.update(launches=launches[name], max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=None, device_ms=dev)
        progress(f"kernels: {name} at 4K, world size 1, {len(calls)} "
                 f"launches ({[[tuple(lv[:3]) for lv in a[1]] for a in calls]}"
                 f" as (stride, columns, rows) of each launch's levels), "
                 f"equal to its plain version; {ms:.3f} ms "
                 f"(plain {plain_ms:.3f} ms, device {dev:.4f} ms by "
                 f"torch.profiler in tools/halo_kernels.py, share "
                 f"{bound / dev:.2f}, bound {bound:.4f} ms by {by}, "
                 f"{nbytes} bytes; with the compact LL buffers "
                 f"{nbytes + ll} bytes: {bound_of(nbytes + ll)[0]:.4f} ms), "
                 f"library n/a")


def halo_gate(torch, enc, dec, img: np.ndarray, stream: bytes) -> str:
    """One sharded encode and one sharded decode with the halo levels'
    plain versions, the eager colour transforms and the eager row pad made
    to raise: on the card neither runs inside ``halo_dwt2d_fwd``,
    ``halo_dwt2d_inv``, ``sharded_lin`` or the decoder's inverse.  Raises
    unless both still give the stream and the frame."""
    from dwt_tpu_torch.ops import color, halo
    from dwt_tpu_torch.parallel import tiled

    def refuse(name):
        def run(*args, **kwargs):
            raise AssertionError(f"{name} ran on the card's sharded path")
        return run

    targets = [(halo, "halo_forward_plain"), (halo, "halo_inverse_plain"),
               (halo, "rgb_to_ycocg"), (halo, "ycocg_to_rgb"),
               (color, "rgb_to_ycocg"), (color, "ycocg_to_rgb"),
               (tiled, "pad_rows")]
    with contextlib.ExitStack() as stack:
        for obj, name in targets:
            stack.enter_context(wrapped(obj, name, lambda _, n=name:
                                        refuse(n)))
        if enc.encode(img) != stream:
            raise AssertionError("the gated sharded encode differs from the "
                                 "stream")
        if not np.array_equal(dec.decode(stream), img):
            raise AssertionError("the gated sharded decode differs from the "
                                 "frame")
    return ("the sharded encode and decode give the stream and the frame "
            "with " + ", ".join(f"{getattr(o, '__name__', o)}.{n}"
                                for o, n in targets) + " made to raise")


def halo_exchanges(torch, mesh, img: np.ndarray) -> str:
    """On this rank of several: the 4K forward (uint8 RGB rows, colour)
    and inverse (to uint8 pixels) halo levels through the kernels and
    through their plain versions, with the same exchanges by
    ``hosts.shift`` and the coarse grid's all-gather; raises unless each
    rank's ``hosts.comm_log`` and results are the same on both routes."""
    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.ops import halo
    from dwt_tpu_torch.parallel import hosts, tiled

    pyr = compute_pyramid(W, H)
    rows = tiled.rank_rows(img, mesh, pyr)
    rb = tiled._halo_plan(pyr, mesh.size)[1] // mesh.size
    logs, results = [], []
    for fwd, inv in ((None, None), (halo.halo_forward_plain,
                                    halo.halo_inverse_plain)):
        hosts.comm_log.clear()
        fine = torch.empty((rb, W, C), dtype=torch.int32, device=mesh.device)
        ll = tiled.run_levels(tiled.forward_levels(
            rows, pyr, mesh.size, mesh.rank, True, fine, fwd), mesh)
        grid = hosts.all_gather(mesh, ll)
        px = tiled.run_levels(tiled.inverse_levels(
            fine, pyr, mesh.size, mesh.rank, True, inv), mesh)
        logs.append(list(hosts.comm_log))
        results.append((fine, grid, px))
    if logs[0] != logs[1]:
        raise AssertionError(f"rank {mesh.rank}: the kernels' exchanges "
                             f"{logs[0]} differ from the plain route's "
                             f"{logs[1]}")
    err = max_abs_err("halo", results[0], results[1])
    if err:
        raise AssertionError(f"rank {mesh.rank}: the kernels' halo levels "
                             f"differ from the plain route's (max abs err "
                             f"{err})")
    sends = [b for op, b in logs[0] if op == "send"]
    return (f"kernels 18 and 19 equal to the plain route, and so are the "
            f"exchanges: {len(sends)} sends of {sorted(set(sends))} bytes "
            f"and {len(logs[0]) - len(sends)} all-gathers")


def sharded_phase(torch, K: Kernels, img: np.ndarray, stream: bytes,
                  card: str, rows: list, parent: str | None) -> None:
    """Phase 7: the sharded routes at world size 1 on NCCL, their gates,
    kernels 18 and 19 (into ``rows``: their 4K calls timed, the sweep,
    the launches of one halo_dwt2d_fwd and halo_dwt2d_inv), rates and
    split, the ``parent`` checkout's split in turns where one is given;
    then two ranks where there are two cards."""
    import torch.distributed as dist

    from dwt_tpu_torch.parallel import hosts

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = hosts.global_mesh()
        progress(f"sharded: NCCL process group of {mesh.size} rank, rank "
                 f"{mesh.rank} on {mesh.device}")
        enc, dec, kept, launches = sharded_routes(torch, K, mesh, img,
                                                  stream)
        halo_rows(torch, kept, launches, rows, halo_device(card))
        del kept
        progress("sharded: " + halo_gate(torch, enc, dec, img, stream))
        progress("sharded: " + halo_sweep(torch))
        sharded_timing(torch, mesh, enc, dec, img, stream, card)
        trees = [("this tree", enc, dec)]
        if parent:
            psharded = parent_module(parent, "parallel.encode")
            pmesh = parent_module(parent, "parallel.hosts").global_mesh()
            trees.append((f"parent {parent}",
                          psharded.ShardedEncoder(W, H, C, pmesh),
                          psharded.ShardedDecoder(W, H, C, pmesh)))
        for tree, e, d in trees * 2:  # in turns
            sharded_profile(torch, e, d, img, stream, tree)
    finally:
        dist.destroy_process_group()
    if torch.cuda.device_count() < 2:
        progress("sharded: the two-rank phase needs two cards; this machine "
                 f"has {torch.cuda.device_count()}, so it did not run")
        return
    two_ranks(torch)


def run_module(module: str, args: list, env: dict | None = None,
               timeout: int = 600) -> tuple:
    """``python -m module *args`` from the checkout's root, in a process of
    its own; raises unless it exits 0.  Returns (stdout bytes, stderr
    text, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                       env={**os.environ, **(env or {})},
                       capture_output=True, timeout=timeout)
    secs = time.perf_counter() - t0
    err = r.stderr.decode(errors="replace")
    if r.returncode != 0:
        raise AssertionError(f"{module} {args} exited {r.returncode}:\n"
                             f"{err[-3000:]}")
    return r.stdout, err, secs


def sha256_file(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def entry_points(img: np.ndarray) -> None:
    """Phase 8, the command line: ``python -m dwt_tpu_torch.cli`` on the
    card, each command a cold process (kernel library loaded from the
    build), held to the JAX package's stream and container digests and to
    the frame; one encode under ``DWT_SELFCHECK=1``; one encode of a
    512x512 crop under ``DWT_TRACE``, whose trace must name the gather and
    pack kernels; then ``python -m dwt_tpu_torch.selftest``, every
    configuration of which must be ok."""
    from dwt_tpu_torch.io import pnm

    cli = "dwt_tpu_torch.cli"
    with tempfile.TemporaryDirectory() as tmp:
        frame, dwt, back, dwtt = (os.path.join(tmp, n) for n in (
            "frame.pnm", "frame.dwt", "back.pnm", "frame.dwtt"))
        pnm.write_pnm(frame, img)
        _, err, secs = run_module(cli, ["encode", frame, dwt])
        digest = sha256_file(dwt)
        progress(f"cli: encode {W}x{H} -> {os.path.getsize(dwt)} bytes, "
                 f"sha256 {digest[:16]}, {secs:.2f} s (one process); "
                 f"{err.strip().splitlines()[-1]}")
        if digest != REF_SHA256:
            raise AssertionError(f"the CLI's stream differs from the JAX "
                                 f"package's: sha256 {digest}")
        _, _, secs = run_module(cli, ["decode", dwt, back])
        out, gray = pnm.read_pnm(back)
        progress(f"cli: decode -> {out.shape} gray={gray}, {secs:.2f} s")
        if gray or not np.array_equal(out, img):
            raise AssertionError("the CLI's decode differs from the frame")
        budget = TILED_BYTES // 3
        _, err, secs = run_module(cli, ["tiled-encode", frame, dwtt,
                                        str(TILE[0]), str(budget)])
        digest = sha256_file(dwtt)
        progress(f"cli: tiled-encode {TILE[0]} {budget} -> {err.strip()}, "
                 f"sha256 {digest[:16]}, {secs:.2f} s")
        if digest != TILED_CUT_SHA256:
            raise AssertionError(f"the CLI's budgeted container differs "
                                 f"from the JAX package's: sha256 {digest}")
        stream, _, secs = run_module(cli, ["encode", frame, "-"],
                                     env={"DWT_SELFCHECK": "1"})
        progress(f"cli: DWT_SELFCHECK=1 encode {W}x{H} to stdout: the "
                 f"stream decodes to the frame, {secs:.2f} s")
        if hashlib.sha256(stream).hexdigest() != REF_SHA256:
            raise AssertionError("the self-checked stream differs")
        crop, traces = (os.path.join(tmp, n) for n in ("crop.pnm", "trace"))
        pnm.write_pnm(crop, img[:512, :512])
        _, _, secs = run_module(cli, ["encode", crop, dwt],
                                env={"DWT_TRACE": traces})
        files = sorted(os.listdir(traces))
        text = "".join(open(os.path.join(traces, f)).read() for f in files)
        names = ("hilbert_gather_kernel", "pack_words_kernel")
        progress(f"cli: DWT_TRACE encode 512x512 -> {files}, "
                 f"{len(text)} characters, kernel "
                 f"events {[text.count(n) for n in names]} for {names}, "
                 f"{secs:.2f} s")
        if not files or not all(n in text for n in names):
            raise AssertionError(f"the trace in {files} does not name the "
                                 f"kernels {names}")
    stdout, err, secs = run_module("dwt_tpu_torch.selftest", [])
    results = json.loads(stdout.decode().strip().splitlines()[-1])
    progress(f"selftest: {results}, {secs:.1f} s (one process a "
             f"configuration)")
    if not results or any(v != "ok" for v in results.values()):
        raise AssertionError(f"selftest: {results}\n{err[-3000:]}")


# The budgeted tiled cases of tests/test_torch_tiled_budget.py: (w, h, c,
# seed, tile side), at budgets of a half, a third, a fifth and a ninth of
# the lossless container, and the 17x31 RGB image of seed 5 in 9x9 tiles
# at 453 bytes.
BUDGET_CASES = ((17, 31, 3, 5, 9), (35, 22, 3, 6, 9), (26, 40, 3, 7, 9),
                (117, 109, 1, 8, 10), (40, 36, 1, 9, 12))


def budget_cases(torch) -> None:
    """Phase 8, the budgeted tiled encode: ``encode_tiled`` on the card
    equals ``encode_tiled_sharded`` at world size 1 on NCCL (lossless, then
    cut) on small cases like the tests'."""
    import torch.distributed as dist

    from dwt_tpu_torch.codec import tiled
    from dwt_tpu_torch.parallel import encode as sharded
    from dwt_tpu_torch.parallel import hosts

    t0 = time.perf_counter()
    reemitted, n = [], 0
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = hosts.global_mesh()
        with wrapped(tiled, "_reemit", counted(reemitted)):
            for w, h, c, seed, t in BUDGET_CASES:
                im = random_image(w, h, c, seed)
                full = len(tiled.encode_tiled(im, (t, t)))
                budgets = [full // d for d in (2, 3, 5, 9)]
                if (w, h, seed) == (17, 31, 5):
                    budgets.append(453)
                for b in budgets:
                    got = tiled.encode_tiled(im, (t, t), b)
                    want = sharded.encode_tiled_sharded(im, mesh, (t, t), b)
                    n += 1
                    if got != want:
                        raise AssertionError(
                            f"budgeted tiled encode {w}x{h}x{c} in {t}x{t} "
                            f"tiles at {b} bytes: {len(got)} bytes, not the "
                            f"sharded route's {len(want)} bytes")
    finally:
        dist.destroy_process_group()
    progress(f"budget: {n} budgeted containers on the card equal to the "
             f"lossless-then-cut containers of encode_tiled_sharded at world "
             f"size 1 on NCCL ({len(reemitted)} tiles emitted again "
             f"unmasked), {time.perf_counter() - t0:.1f} s")


def batch_frames() -> np.ndarray:
    """BASELINE config 4's 64 frames, made on the host's cores (numpy
    lets go of the interpreter lock in the image arithmetic)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return np.stack(list(pool.map(
            lambda s: random_image(BATCH_W, BATCH_H, C, s), range(BATCH_N))))


def download_copies(torch, enc, imgs: np.ndarray, card: str) -> None:
    """The device-to-host copies of one ``enc.emit_frames`` of ``imgs`` and
    of its stream download (``Encoder._download`` on the words and totals
    that call gave it, which must give the same payloads): the download
    must be one copy, beside its gather on the card.  The profiler drops
    every event of a session now and then (PERF.md §7): a session with no
    device event is tried again, twice, and then reads "not measured"."""
    from dwt_tpu_torch.codec import encoder

    kept = {}
    real = enc._download

    def keep(words, totals):
        kept.update(words=words, totals=totals)
        return real(words, totals)

    lin, stats = enc.stage1_frames(imgs)
    padded_T = encoder._bucket(int(stats["T"].max()))
    enc._download = keep
    try:
        payloads = enc.emit_frames(lin, stats, padded_T)[0]
    finally:
        del enc._download
    if enc._download(kept["words"], kept["totals"]) != payloads:
        raise AssertionError("the download differs from emit_frames' "
                             "payloads")

    def d2h(fn):
        for _ in range(3):
            names = device_names(torch, fn)
            if names:
                return sum(n.startswith("Memcpy DtoH") for n in names), \
                    len(names)
        return None, 0

    whole, _ = d2h(lambda: enc.emit_frames(lin, stats, padded_T))
    down, events = d2h(lambda: enc._download(kept["words"], kept["totals"]))
    if down is not None and down != 1:
        raise AssertionError(f"the stream download of {len(imgs)} frames "
                             f"made {down} device-to-host copies")
    progress(f"profile: one emit_frames of {len(imgs)} frames: "
             + ("not measured" if whole is None else str(whole))
             + " device-to-host copies; its stream download alone "
             + ("not measured (no device event in three profiler sessions)"
                if down is None else f"1 copy of {events} device events")
             + f" ({sum(len(p) for p in payloads)} bytes into the encoder's "
             f"pinned buffer of {enc._landing.numel() * 4} bytes) on {card}")


def batch_phase(torch, K: Kernels, rows: list, card: str,
                parent: str | None) -> None:
    """Phase 9, the batch throughput mode (BASELINE config 4): 64 RGB
    1080p frames through ``BatchEncoder.encode_batch`` in sub-batches of
    ``MAX_PIXELS_PER_DISPATCH`` pixels (9 of 7 frames and 1 of 1), in
    ``Kernels.path`` (kernel inputs kept and held against the plain
    versions).  Gates: the 64 streams' total bytes and SHA-256 equal the
    JAX package's, each stream equals the single-stream encoder's on the
    card, and each encode kernel launched once a sub-batch.  Then warm MP/s
    of the batch in turns with a loop of the single-stream encoder over
    the same frames, the copies and the peak memory of one 7-frame
    sub-batch, and each kernel's wrapper time at the 7-frame shape beside
    its bound (into ``rows``)."""
    from dwt_tpu_torch.codec import encoder, tiled

    t_phase = time.perf_counter()
    frames = batch_frames()
    progress(f"batch: {BATCH_N} frames {BATCH_W}x{BATCH_H}x{C} made, "
             f"{time.perf_counter() - t_phase:.1f} s")
    enc = tiled.get_batch_encoder(BATCH_W, BATCH_H, C)
    sub = enc.MAX_PIXELS_PER_DISPATCH // enc.pyr.total
    nsub = -(-BATCH_N // sub)
    store, counts = {}, {}
    t0 = time.perf_counter()
    with K.path("batch encode", store, counts):
        streams = enc.encode_batch(frames)
    secs = time.perf_counter() - t0
    blob = b"".join(streams)
    digest = hashlib.sha256(blob).hexdigest()
    progress(f"batch: encode_batch of {BATCH_N} frames in {nsub} "
             f"sub-batches ({sub} frames a sub-batch at most) -> {len(blob)} "
             f"bytes, sha256 {digest[:16]}, {secs:.2f} s cold (kernel inputs "
             f"kept); launches {counts}")
    if (len(blob), digest) != (BATCH_BYTES, BATCH_SHA256):
        raise AssertionError(f"the batch's streams differ from the JAX "
                             f"package's: {len(blob)} bytes, sha256 {digest}")
    want = {k: n * nsub for k, n in sub_batch_launches(enc.pyr).items()}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"batch launches {counts}: want {want}, one a "
                             f"sub-batch")
    progress(f"batch: launches one a sub-batch: {want} (compact_tokens: a "
             f"count and a place launch each); a loop over the frames would "
             f"make {BATCH_N} and {2 * BATCH_N}")
    progress(f"batch: kernels equal to their plain versions: "
             f"{held_line(K.hold(store))}")
    progress(f"timing: batch, kernel 17 on a {sub}-frame sub-batch, in "
             f"turns: " + emit_turns(torch, store["emit_tables"][0], parent))

    single = encoder.get_encoder(BATCH_W, BATCH_H, C)
    mp = BATCH_N * BATCH_W * BATCH_H / 1e6
    rates = {"batch": [], "single": []}
    for r in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = enc.encode_batch(frames)
        rates["batch"].append(mp / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        ones = [single.encode(f) for f in frames]
        rates["single"].append(mp / (time.perf_counter() - t0))
        if again != streams:
            raise AssertionError("a warm batch encode differs from the first")
        bad = [i for i, (a, b) in enumerate(zip(ones, streams)) if a != b]
        if bad:
            raise AssertionError(f"batch streams {bad} differ from the "
                                 f"single-stream encoder's")
    progress(f"batch: each of the {BATCH_N} streams equal to the "
             f"single-stream encoder's on the card (three passes)")
    progress(f"profile: stage 1 of a {sub}-frame sub-batch by pass: "
             + stage1_split(torch, enc.enc, frames[:sub], parent))
    progress(f"timing: warm batch encode of {mp:.1f} MP, MP/s: batch "
             + ", ".join(f"{m:.2f}" for m in rates["batch"])
             + "; single-stream encoder looped over the frames "
             + ", ".join(f"{m:.2f}" for m in rates["single"])
             + f" (in turns) on {card}")

    seven = frames[:sub]
    moved = copies(torch, lambda: enc.encode_raw(seven))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    enc.encode_raw(seven)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    progress(f"profile: one {sub}-frame sub-batch ({sub * BATCH_W * BATCH_H} "
             f"pixels): {moved['DtoH']} device-to-host and {moved['HtoD']} "
             f"host-to-device copies; peak memory "
             f"{peak / 2**30:.2f} GiB allocated ({(peak - base) / 2**30:.2f} "
             f"GiB above the {base / 2**30:.2f} GiB held before it), "
             f"max_memory_allocated, on {card}")

    # Each kernel's wrapper at the 7-frame shape (the first sub-batch's
    # kept call; kernel 12's pairs laid out again in a pair buffer's rows,
    # as kernel A leaves them: a kept call is a contiguous copy), beside
    # its bound.
    from dwt_tpu_torch.ops import (codeword, compact, emit_tables, finish,
                                   hilbert_gather, lifting, pack, plane_stats,
                                   schedule, units, vli_scan)

    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    calls = {
        "codeword_pieces": lambda a: codeword.codeword_pieces(*a),
        "forward_transform": lambda a: lifting.forward_transform(*a),
        "plane_stats": lambda a: plane_stats.plane_stats(*a),
        "hilbert_gather": lambda a: hilbert_gather.hilbert_gather(*a),
        "compact_tokens": lambda a: compact.compact_tokens(*a[:4]),
        "pack_words": lambda a: pack.pack_words(*a, order_flag=flag),
        "vli_orders": lambda a: vli_scan.vli_orders(*a),
        "finish_tokens": lambda a: finish.finish_tokens(*a),
        "packed_elems": lambda a: finish.packed_elems(*a),
        "schedule": lambda a: schedule.schedule(*a),
        "unit_tables": lambda a: units.unit_tables(*a),
        "emit_tables": lambda a: emit_tables.emit_tables(*a),
    }
    parts = []
    for row in rows:
        name = row["name"]
        if name not in BATCH_KERNELS:
            continue
        kept = store[name][:1]
        if name == "finish_tokens":
            kept = [as_pair_buffer(kept[0])]
        if name == "scatter_refbits":
            ms = sum(time_ms(torch, compact.scatter_refbits, setup=lambda a=a: (
                a[0], a[1], a[2].clone(), a[3], a[4])) for a in kept)
        else:
            ms = sum(time_ms(torch, lambda a=a: calls[name](a)) for a in kept)
        work = [kernel_work(torch, name, a) for a in kept]
        bound, by = bound_of(sum(w[0] for w in work), sum(w[1] for w in work))
        row.update(batch_launches=counts[name], batch_ms=ms,
                   batch_bound_ms=bound)
        shapes = [tuple(a[0].shape) for a in kept]
        plain = ""
        plains = {"vli_orders": vli_scan.vli_orders_plain,
                  "forward_transform": lifting.forward_transform_plain,
                  "plane_stats": plane_stats.plane_stats_plain,
                  "codeword_pieces": codeword.codeword_pieces_plain,
                  "finish_tokens": finish.finish_tokens_plain,
                  "packed_elems": finish.packed_elems_plain,
                  "schedule": schedule.schedule_plain,
                  "unit_tables": units.unit_tables_plain,
                  "emit_tables": emit_tables.emit_tables_plain}
        if name in plains:
            plain = ", plain " + format(time_ms(torch, lambda: (
                plains[name](*kept[0])), reps=3), ".3f") + " ms"
        parts.append(f"{name} {shapes} {ms:.3f} ms{plain}, bound "
                     f"{bound:.3f} ms by {by}, share {bound / ms:.2f}")
    progress(f"kernels: batch of {sub} frames, each wrapper at its kept "
             f"call: " + "; ".join(parts))
    progress(f"device: stage 1 at the batch of {sub} frames: "
             + stage1_device(torch, {k: store[k][0] for k in STAGE1_NAMES},
                             rows, "batch_device_ms"))
    progress(f"device: kernels 12-15 and 17 at the batch of {sub} frames: "
             + tokens_device(torch, tokens_kept(store), rows,
                             "batch_device_ms"))
    progress(f"device: kernels 14 and 15 at the batch of {sub} frames, in "
             f"turns: " + schedule_turns(torch, tokens_kept(store), parent))
    val, vli = store["vli_orders"][0]
    progress(f"device: at the batch of {sub} frames, "
             + vli_device(torch, val, vli, rows, "batch_device_ms"))
    progress(f"batch: vli_orders on a {sub}-frame sub-batch's tokens: "
             + vli_collapse(torch, val, vli))
    cw = store["codeword_pieces"][0]
    progress(f"device: at the batch of {sub} frames, "
             + codeword_device(torch, cw, rows, "batch_device_ms", parent)
             + "; " + cumsum_line(torch, cw))
    download_copies(torch, enc.enc, seven, card)
    progress(f"profile: emit half of a {sub}-frame sub-batch by pass "
             f"(tools/emit_split.py): "
             + emit_splits(torch, enc.enc, seven, parent))
    emit_gate(torch, enc.enc, seven, f"{sub} frames")
    progress(f"profile: tokens half of a {sub}-frame sub-batch by pass "
             f"(tools/tokens_split.py): "
             + emit_splits(torch, enc.enc, seven, parent, "tokens_split"))
    progress(f"device: the forward transform by launch at the batch of {sub} "
             f"frames: " + lift_split(torch, frames[:sub]))
    del store
    torch.cuda.empty_cache()
    progress(f"batch: phase 9 {time.perf_counter() - t_phase:.1f} s")


def main(argv: list) -> int:
    import torch

    parent = argv[1] if len(argv) == 2 and argv[0] == "--parent" else None
    if argv not in ([], ["--two-ranks"]) and not parent:
        print("usage: python3 chip_smoke.py [--two-ranks | --parent DIR]",
              file=sys.stderr)
        return 2
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
    progress(f"build: {len(build.sources())} sources, one nvcc process "
             f"each, in parallel, and a link, "
             f"{secs:.1f} s -> {os.path.relpath(path, ROOT)}")
    if argv == ["--two-ranks"]:
        if torch.cuda.device_count() < 2:
            raise RuntimeError("--two-ranks needs two cards")
        two_ranks(torch)
        return 0

    # 3. e2e: the main paths, with the kernels' launch counts
    from dwt_tpu_torch.codec import decoder, tiled
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
    K.check_launched("encode", launches)

    K.reset()
    with K.capture(got):
        out, gray = decoder.decode(stream)
    torch.cuda.synchronize()
    dec_launches = K.counts()
    progress(f"e2e: decoded to {out.shape} gray={gray}; launches "
             f"{dec_launches}")
    if gray or out.shape != img.shape or not np.array_equal(out, img):
        raise AssertionError("the lossless decode differs from the frame")
    K.check_launched("decode", dec_launches)
    launches["hilbert_scatter"] = dec_launches["hilbert_scatter"]
    launches["inverse_transform"] = dec_launches["inverse_transform"]
    lossy_decodes(torch, K, decoder, stream)
    root_only_decode(torch, K, decoder, stream)
    capacity_encode(K, enc, img, stream, info["tokens"])
    full, tiled_scatter = tiled_paths(torch, K, tiled, img)
    small_tiles(torch, K, tiled, parent)

    # 4. kernels against their plain versions, on the main path's inputs
    transposes = seeded_transposes(torch)
    rows = check_kernels(torch, K, got, launches, tiled_scatter, transposes,
                         parent)
    device_inputs = (got["hilbert_scatter"][0], tiled_scatter,
                     transposes["4K"], got["vli_orders"][0],
                     {k: got[k][0] for k in STAGE1_NAMES},
                     got["codeword_pieces"][0], tokens_kept(got), rows)
    inverse_4k = got["inverse_transform"][0]
    del got, tiled_scatter, transposes
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
    profile(torch, enc, img, parent)
    mps = []
    for _ in range(3):
        t0 = time.perf_counter()
        out, _ = decoder.decode(stream)
        mps.append(W * H / 1e6 / (time.perf_counter() - t0))
        if not np.array_equal(out, img):
            raise AssertionError("a warm decode differs from the frame")
    progress(f"timing: warm 4K decode {', '.join(f'{m:.2f}' for m in mps)} "
             f"MP/s on {card}")
    decode_profile(torch, decoder, stream, img)
    tail_turns(torch, img, parent, card)
    tiled_timing(torch, tiled, img, full, card)

    # 6. device times of kernels 5 and 6 (torch.profiler)
    device_times(torch, *device_inputs, parent)
    del device_inputs
    progress("device: the forward transform by launch at 4K: "
             + lift_split(torch, img[None]))
    unlift_device(torch, inverse_4k, rows)
    del inverse_4k
    torch.cuda.empty_cache()
    unlift_stamps(parent, card)

    # 7. the sharded routes at world size 1 on NCCL, kernels 18 and 19
    # (two ranks: two cards)
    sharded_phase(torch, K, img, stream, card, rows, parent)

    # 8. the command line, DWT_SELFCHECK, DWT_TRACE, the self-test, and the
    # budgeted tiled encode against the lossless-then-cut route
    t0 = time.perf_counter()
    entry_points(img)
    budget_cases(torch)
    progress(f"entry points: phase 8 {time.perf_counter() - t0:.1f} s")

    # 9. the batch throughput mode: BASELINE config 4
    batch_phase(torch, K, rows, card, parent)
    if parent:
        uhd16k_turns(torch, tiled, parent, card)

    # A time not measured (NaN: the profiler dropped the kernel's events)
    # prints as null.
    print(json.dumps({"kernels": [
        {k: None if isinstance(v, float) and v != v else v
         for k, v in row.items()} for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
