"""On-card self-test: every CUDA kernel at the edges that small encodes
miss, then encodes and decodes on the card, each configuration in its own
process.

Port of ``dwt_tpu/selftest.py``.  The tier-1 tests run the kernels' plain
PyTorch versions on the CPU; what the CUDA kernels do is seen only on a
card.  Each configuration holds a kernel's wrapper, on CUDA tensors, to
its plain version on the same tensors and to an independent numpy oracle,
at constructions that the 4K frame does not reach: valid lengths at the
edges of kernel A's 4,096-element sub-ranges, units of many planes
sharing a chunk, pack tiles of one token more or less than 2,048, jumps
past the pack kernel's 4,096-word window, scatter squares of more runs
than one 32-run round, transposes whose sides are not multiples of 16.
Then ``encode`` and ``decode`` hold the card's streams and pixels to the
port's CPU path (which tier-1 holds to the JAX package and the spec
model).  Configurations run narrow to broad, so the first failure names
the kernel.  Each runs in a subprocess: a CUDA fault such as an illegal
address poisons its process's context, and must not take later
configurations with it.

CLI:  python -m dwt_tpu_torch.selftest [--configs a,b] [--size WxH]
                                       [--device cuda|cpu]

Prints ``{config: "ok"|"fail"|"timeout"|"n/a"}`` as JSON on stdout and a
``selftest <name>: <result>`` line a configuration on stderr, and exits 0
only when every configuration it ran is ``ok``.  ``--device cpu`` runs
each kernel configuration's plain version against the numpy oracle (no
kernel is launched); ``encode`` and ``decode`` are then ``n/a``, because
their oracle is the CPU path itself.  Without a card, and without
``--device cpu``, it prints an error and exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

CONFIGS = ("gather", "compact", "refbits", "pack", "scatter", "transpose",
           "probe", "encode", "decode")
CARD_ONLY = ("encode", "decode")  # their oracle is the CPU path itself
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_image(rng, w: int, h: int, channels: int, kind: str) -> np.ndarray:
    """Test images: "noise", or "mixed" (a gradient, a texture and noise
    patches: compressible but busy)."""
    if kind == "noise":
        return rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 255 // max(w - 1, 1) + yy * 127 // max(h - 1, 1)) % 256
    tex = (32 * np.sin(xx / 3.0) * np.cos(yy / 5.0)).astype(np.int32)
    img = np.stack([(base + tex + 31 * c) % 256 for c in range(channels)],
                   axis=-1)
    noise = rng.integers(-8, 9, img.shape)
    mask = (xx // 16 + yy // 16) % 3 == 0
    return np.clip(img + noise * mask[..., None], 0, 255).astype(np.uint8)


class _Held:
    """Collects the comparisons of one configuration; a mismatch is
    printed to stderr with its first differing index."""

    def __init__(self, dev):
        self.dev = dev
        self.ok = True

    def fail(self, msg: str) -> None:
        print(f"  {msg}", file=sys.stderr, flush=True)
        self.ok = False

    def same(self, label: str, got, want) -> None:
        g, w = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                for x in (got, want))
        if g.shape != w.shape or g.dtype != w.dtype:
            self.fail(f"{label}: {g.shape} {g.dtype} against {w.shape} "
                      f"{w.dtype}")
        elif not np.array_equal(g, w):
            i = int(np.flatnonzero(g.reshape(-1) != w.reshape(-1))[0])
            self.fail(f"{label}: first difference at flat index {i}")

    def kernel(self, label: str, fn, plain, oracle, *args) -> None:
        """``fn(*args)`` (one launch on the card, the plain version on the
        CPU) against ``plain(*args)`` and the numpy ``oracle``; tensors
        among ``args`` are cloned for each call (kernel B writes in
        place)."""
        import torch

        def fresh():
            return [a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args]

        before = fn.launches
        got = fn(*fresh())
        want = plain(*fresh())
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        launched = fn.launches - before
        if launched != (self.dev.type == "cuda"):
            self.fail(f"{label}: {launched} launches")
        self.same(f"{label} against its plain version", got, want)
        self.same(f"{label} against the numpy oracle", got, oracle)


def _tensor(a, dev):
    import torch

    return torch.as_tensor(np.ascontiguousarray(a)).to(dev)


def _gather(h: _Held, size) -> None:
    """Kernel 1 on a real scan-order index (RGB and gray, and three RGB
    frames in one launch, as the batch mode calls it) and on a random
    index with pads, at a length that fills no block."""
    from .codec.stage1 import gather_source
    from .geometry import compute_pyramid
    from .ops.hilbert_gather import hilbert_gather, hilbert_gather_plain

    rng = np.random.default_rng(1)
    w, h_ = size
    real = gather_source(compute_pyramid(w, h_))
    cases = [(real, (h_, w, c)) for c in (3, 1)] + [(real, (3, h_, w, 3))]
    rand = rng.integers(-1, 45 * 37, 70_001).astype(np.int32)
    cases.append((rand, (37, 45, 5)))
    for src, shape in cases:
        co = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(
            np.int32)
        frames = co.reshape(-1, shape[-3] * shape[-2], shape[-1])
        want = np.zeros((frames.shape[0], shape[-1], src.size), np.int32)
        ok = src >= 0
        want[:, :, ok] = frames[:, src[ok]].transpose(0, 2, 1)
        want = want.reshape(*shape[:-3], shape[-1], src.size)
        h.kernel(f"gather {shape} nlin={src.size}", hilbert_gather,
                 hilbert_gather_plain, want, _tensor(co, h.dev),
                 _tensor(src, h.dev))


def _elements(rng, n: int) -> np.ndarray:
    """Packed sign|magnitude elements over planes 0-12, some zero, a few
    -1 pads."""
    mag = np.where(rng.random(n) < 0.35, 0,
                   (1 << rng.integers(0, 13, n)) + rng.integers(0, 64, n))
    v = (mag | (rng.integers(0, 2, n) << 30)).astype(np.int64)
    v[rng.random(n) < 0.02] = -1
    return v.astype(np.int32)


def _chunk_units(rng, flat, sub: int, refined: bool) -> list:
    """Units of planes 0-9 sharing each chunk, whose valid lengths lie at
    the edges of kernel A's SUBLEN-element sub-ranges (and at 1, E - 1
    and E); counts equal to the true count, below it on a third of the
    units, and 0 on every unit of chunk 3; zero carries on kernel A's.
    Rows are shuffled, as the schedule order gives them."""
    from .ops.compact import E, MAGMASK, SUBLEN

    lens = (SUBLEN - 1, SUBLEN, SUBLEN + 1, 1, 2 * SUBLEN, E - 1, E,
            3 * SUBLEN + 1)
    units = []
    for k, elen in enumerate(lens):
        el = flat[k * E:k * E + elen].astype(np.int64)
        for p in range(10):
            sh = (el & MAGMASK) >> p
            hit = (el >= 0) & ((sh > 1) if refined else (sh == 1))
            cnt = 0 if k == 3 else int(hit.sum())
            if cnt and rng.random() < 0.3:
                cnt = int(rng.integers(0, cnt))
            carry = 0 if refined else int(rng.integers(0, 1 << 20))
            units.append([k * E // sub, elen, p, 0, 0, carry, cnt, 0])
    return [units[i] for i in rng.permutation(len(units))]


def _unit_outputs(flat, meta, sub: int, refined: bool):
    """Numpy oracle walk of the units: yields (unit row, element values,
    the mask of the unit's outputs, their ranks, sh)."""
    from .ops.compact import E, MAGMASK

    for m in meta.astype(np.int64):
        if m[6] <= 0:
            continue
        ln = min(m[1], E)
        el = flat[m[0] * sub:m[0] * sub + ln].astype(np.int64)
        sh = (el & MAGMASK) >> m[2]
        hit = (el >= 0) & ((sh > 1) if refined else (sh == 1))
        rank = np.cumsum(hit) - hit
        yield m, el, hit & (rank < m[6]), rank, sh


def _compact(h: _Held, size) -> None:
    """Kernel A over shared chunks at the sub-range edges, with the pair
    buffer whole and cut short."""
    from .ops import compact as K

    rng = np.random.default_rng(2)
    flat = _elements(rng, 9 * K.E)
    rows, base = _chunk_units(rng, flat, K.SUBA, refined=False), 5
    for r in rows:
        base += int(rng.integers(0, 300))
        r[3], r[4] = base & ~127, base & 127
        base += r[6]
    meta = np.asarray(rows, np.int32)
    vmag = _tensor(flat.reshape(-1, K.SUBA), h.dev)
    for npairs in (base + 512, base // 2):
        want = np.zeros(npairs, np.int64)
        for m, el, out, rank, _ in _unit_outputs(flat, meta, K.SUBA, False):
            zero = (el >= 0) & (((el & K.MAGMASK) >> m[2]) == 0)
            zpfx = m[5] + np.cumsum(zero) - zero
            slot = m[3] + m[4] + rank
            out &= (slot >= 0) & (slot < npairs)
            want[slot[out]] = (zpfx[out] << 1) | ((el[out] >> 30) & 1)
        h.kernel(f"compact_tokens npairs={npairs}", K.compact_tokens,
                 K.compact_tokens_plain, want.astype(np.int32), vmag,
                 _tensor(meta, h.dev), npairs)


def _refbits(h: _Held, size) -> None:
    """Kernel B over the same shared chunks, into random prior words, with
    the buffer whole and ending inside the last units' bits."""
    from .ops import compact as K

    rng = np.random.default_rng(3)
    flat = _elements(rng, 9 * K.E)
    rows, bit = _chunk_units(rng, flat, K.SUBB, refined=True), 37
    for r in rows:
        r[3] = (bit >> 5) & ~127
        r[4] = bit - 32 * r[3]
        bit += r[6] + int(rng.integers(0, 300))
    meta = np.asarray(rows, np.int32)
    vmag = _tensor(flat.reshape(-1, K.SUBB), h.dev)
    for nwords in (bit // 32 + 512, bit // 32 - 1000):
        prior = rng.integers(-2**31, 2**31, nwords).astype(np.int32)
        acc = prior.astype(np.int64) & 0xFFFFFFFF
        for m, _, out, rank, sh in _unit_outputs(flat, meta, K.SUBB, True):
            b = 32 * m[3] + m[4] + rank
            out &= ((sh & 1) == 1) & (b >> 5 < nwords)
            np.add.at(acc, b[out] >> 5, np.int64(1) << (b[out] & 31))
        want = (acc & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        h.kernel(f"scatter_refbits nwords={nwords}", K.scatter_refbits,
                 K.scatter_refbits_plain, want, vmag, _tensor(meta, h.dev),
                 _tensor(prior, h.dev))


def _pack(h: _Held, size) -> None:
    """The pack kernel at one tile of tokens and one more or less, with
    every token on one word, and with jumps of widx past the 4,096-word
    shared window; nwords below the last word drops the pieces past it."""
    from .ops import pack as K

    tile = 2048  # tokens a block of csrc/pack.cu
    rng = np.random.default_rng(4)
    cases = [(n, "steps") for n in (tile - 1, tile, tile + 1, 2 * tile + 1)]
    cases += [(3 * tile, "one word"), (40_000, "jumps"),
              (40_000, "nwords short")]
    for n, kind in cases:
        steps = rng.integers(0, 4, n)
        if kind == "one word":
            steps[:] = 0
        if kind in ("jumps", "nwords short"):
            steps[rng.random(n) < 0.002] += 4096 + int(rng.integers(1, 9000))
        widx = (np.cumsum(steps) - steps[0]).astype(np.int32)
        cs = [rng.integers(-2**31, 2**31, n).astype(np.int32)
              for _ in range(3)]
        nwords = int(widx[-1]) + 3 - (200 if kind == "nwords short" else 0)
        acc = np.zeros(nwords + 2, np.int64)
        live = (widx >= 0) & (widx < nwords)
        for k, c in enumerate(cs):
            np.add.at(acc, widx[live] + k, c[live].astype(np.int64)
                      & 0xFFFFFFFF)
        want = (acc[:nwords] & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        h.kernel(f"pack_words n={n} {kind}", K.pack_words,
                 K.pack_words_plain, want, _tensor(widx, h.dev),
                 *(_tensor(c, h.dev) for c in cs), nwords)


def _scatter(h: _Held, size) -> None:
    """Kernel 5 on the decoder's index of a geometry (1 and 3 channels)
    and on a shuffled index whose squares hold far more runs than one
    32-run round, with entries outside [0, L), at 1 and 24 channels (two
    channel groups)."""
    from .codec.decoder import scatter_source
    from .geometry import compute_pyramid
    from .ops import hilbert_scatter as K

    rng = np.random.default_rng(5)
    w, h_ = size
    real = scatter_source(compute_pyramid(w, h_))
    H, W = 70, 45
    shuffled = rng.permutation(H * W + 64)[:H * W].reshape(H, W)
    shuffled[rng.random((H, W)) < 0.05] = -1
    shuffled = shuffled.astype(np.int32)
    sq_ptr, _ = K.square_runs(shuffled)
    if int(np.diff(sq_ptr).max()) <= 32:
        h.fail("scatter: the shuffled index has no square past one round")
    for src, L, C in ((real, real.size, 3), (real, real.size, 1),
                      (shuffled, H * W, 1), (shuffled, H * W, 24)):
        lin = rng.integers(-2**31, 2**31, (C, L)).astype(np.int32)
        ok = (src >= 0) & (src < L)
        want = np.where(ok[..., None], lin[:, np.clip(src, 0, L - 1)]
                        .transpose(1, 2, 0), 0).astype(np.int32)
        args = [_tensor(lin, h.dev), _tensor(src, h.dev)]
        h.kernel(f"hilbert_scatter {src.shape} C={C}", K.hilbert_scatter,
                 K.hilbert_scatter_plain, want, *args)
        h.kernel(f"hilbert_scatter {src.shape} C={C}, run table given",
                 K.hilbert_scatter, K.hilbert_scatter_plain, want, *args,
                 *K.run_table(args[1]))


def _transpose(h: _Held, size) -> None:
    """Kernel 6, int32 and uint32 by the element kernel, int8 by the byte
    kernel (sides multiples of 16) and by the element kernel (not)."""
    import torch

    from .ops import transpose as K

    rng = np.random.default_rng(6)
    for shape, dtype in (((1, 1), np.int32), ((17, 33), np.int32),
                         ((100, 257), np.int32), ((33, 65), np.uint32),
                         ((128, 4096), np.int8), ((16, 48), np.int8),
                         ((130, 245), np.int8), ((1, 31), np.int8)):
        bits = rng.integers(0, 2**32, shape, dtype=np.uint64)
        x = bits.astype(dtype) if dtype != np.uint32 else \
            bits.astype(np.uint32).view(np.int32)
        t = torch.as_tensor(x)
        if dtype == np.uint32:  # the same bits; an int32 result
            t = t.view(torch.uint32)
        h.kernel(f"transpose2d {shape} {np.dtype(dtype).name}",
                 K.transpose2d, K.transpose2d_plain,
                 np.ascontiguousarray(x.T), t.to(h.dev))


def _probe(h: _Held, size) -> None:
    """The tile engines' probe: its one host call on its buffers (three
    launches on the card), whose output must be ``arange`` twice with no
    value counted wrong; then ``engine_supported``."""
    import torch

    from .ops import hilbert_gather as K

    bufs = K.probe_buffers(h.dev)
    for b in bufs[2:]:
        b.fill_(-7)
    before = K.engine_supported.launches
    K.engine_probe(*bufs)
    if h.dev.type == "cuda":
        torch.cuda.synchronize()
    if K.engine_supported.launches - before != 3 * (h.dev.type == "cuda"):
        h.fail(f"probe: {K.engine_supported.launches - before} launches")
    n = K.TS * K.TS
    h.same("probe output", bufs[2], np.tile(np.arange(n, dtype=np.int32), 2))
    h.same("probe wrong-value counts", bufs[3], np.zeros(2, np.int32))
    if K.engine_supported(h.dev) is not True:
        h.fail("engine_supported did not return True")


def _streams(size) -> list:
    """(image, CPU stream) of the encode and decode configurations: a
    "mixed" RGB image of ``size`` and a "noise" gray one 7x3 smaller."""
    from .codec.encoder import Encoder

    w, h = size
    rng = np.random.default_rng(11)
    out = []
    for (ww, hh), kind, c in (((w, h), "mixed", 3),
                              ((w - 7, h - 3), "noise", 1)):
        img = random_image(rng, ww, hh, c, kind)
        out.append((img, Encoder(ww, hh, c, device="cpu").encode(img)))
    return out


def _launches() -> list:
    """The encode kernels' launch counts, then the scatter kernel's.  The
    transpose (kernel 6) is not among them: no encode launches it, and
    its own configuration holds it."""
    from .ops import (codeword, compact, hilbert_gather, hilbert_scatter,
                      lifting, pack, plane_stats, vli_scan)

    return [compact.compact_tokens.launches, compact.scatter_refbits.launches,
            hilbert_gather.hilbert_gather.launches, pack.pack_words.launches,
            vli_scan.vli_orders.launches,
            codeword.codeword_pieces.launches,
            lifting.forward_transform.launches,
            plane_stats.plane_stats.launches,
            hilbert_scatter.hilbert_scatter.launches]


def _encode(h: _Held, size) -> None:
    """Streams encoded on the card equal the CPU path's, byte for byte."""
    from .codec.encoder import Encoder

    for img, want in _streams(size):
        hh, ww, c = img.shape
        before = _launches()
        got = Encoder(ww, hh, c, device=h.dev).encode(img)
        ran = [a - b for a, b in zip(_launches(), before)]
        if not all(ran[:-1]):
            h.fail(f"encode {ww}x{hh}x{c}: an encode kernel did not launch "
                   f"{ran[:-1]}")
        h.same(f"encode {ww}x{hh}x{c}", np.frombuffer(got, np.uint8),
               np.frombuffer(want, np.uint8))


def _decode(h: _Held, size) -> None:
    """The same streams decoded on the card and on the CPU, lossless (the
    image back) and at a prefix of a third."""
    from .codec import decoder

    for img, stream in _streams(size):
        for s in (stream, stream[:len(stream) // 3]):
            label = f"decode {img.shape} of {len(s)} bytes"
            before = _launches()
            got, _ = decoder.decode(s, device=h.dev)
            if _launches()[-1] == before[-1]:
                h.fail(f"{label}: the scatter kernel did not launch")
            want, _ = decoder.decode(s, device="cpu")
            h.same(label, got, want)
            if s is stream:
                h.same(f"{label}, the image", got, img)


CHECKS = {"gather": _gather, "compact": _compact, "refbits": _refbits,
          "pack": _pack, "scatter": _scatter, "transpose": _transpose,
          "probe": _probe, "encode": _encode, "decode": _decode}


def check(name: str, device, size=(192, 160)) -> bool:
    """Run one configuration in this process; True when everything held."""
    import torch

    h = _Held(torch.device(device))
    CHECKS[name](h, size)
    return h.ok


def run(size: str = "192x160", configs=None, device: str = "cuda",
        timeout: int = 600) -> dict:
    """Each configuration (all, or those named) in a subprocess; returns
    {name: "ok"|"fail"|"timeout"|"n/a"} in configuration order."""
    results = {}
    for name in CONFIGS:
        if configs and name not in configs:
            continue
        if device == "cpu" and name in CARD_ONLY:
            results[name] = "n/a"
        else:
            try:
                r = subprocess.run(
                    [sys.executable, "-m", "dwt_tpu_torch.selftest",
                     "--child", name, "--size", size, "--device", device],
                    timeout=timeout, cwd=ROOT)
                results[name] = "ok" if r.returncode == 0 else "fail"
            except subprocess.TimeoutExpired:
                results[name] = "timeout"
        print(f"selftest {name}: {results[name]}", file=sys.stderr,
              flush=True)
    return results


USAGE = ("usage: python -m dwt_tpu_torch.selftest [--configs a,b] "
         "[--size WxH] [--device cuda|cpu]")


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    opts = {"--configs": None, "--size": "192x160", "--device": "cuda",
            "--child": None}
    while args:
        a = args.pop(0)
        if a not in opts or not args:
            print(USAGE, file=sys.stderr)
            return 2
        opts[a] = args.pop(0)
    configs = opts["--configs"] and opts["--configs"].split(",")
    device = opts["--device"]
    if set(configs or ()) - set(CONFIGS) or device not in ("cuda", "cpu"):
        print(f"{USAGE}\nconfigurations: {','.join(CONFIGS)}",
              file=sys.stderr)
        return 2
    w, h = (int(x) for x in opts["--size"].split("x"))
    if opts["--child"]:
        return 0 if check(opts["--child"], device, (w, h)) else 1
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("selftest: no CUDA device (pass --device cpu to hold the "
              "plain versions to the numpy oracles)", file=sys.stderr)
        return 1
    results = run(opts["--size"], configs, device)
    print(json.dumps(results))
    return 0 if all(v in ("ok", "n/a") for v in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
