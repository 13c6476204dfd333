"""Command-line interface mirroring the reference programs' argv contract.

Port of ``dwt_tpu/cli.py``:

    python -m dwt_tpu_torch.cli encode input.pnm output.dwt [CAPACITY]
    python -m dwt_tpu_torch.cli decode input.dwt output.pnm [PIXELS]
    python -m dwt_tpu_torch.cli tiled-encode input.pnm output.dwtt [TILE] [BUDGET]

``-`` means stdin/stdout, as in the reference (bytes.h:26-28,42-44).
Prints the same style of bit-count stats to stderr (encode.c:176,180,230).

It runs on the CUDA card; ``DWT_DEVICE=cpu`` runs the kernels' plain
PyTorch versions on the CPU instead.  Without a card, and without that
request, it prints the error and exits 1.  ``DWT_TRACE=<dir>`` wraps the
run in a ``torch.profiler`` trace (``utils/trace.py``); ``DWT_SELFCHECK=1``
makes every lossless encode check that its stream decodes to the input
(``codec/encoder.py``).
"""

from __future__ import annotations

import os
import sys


def _err(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 1


def main(argv=None, device=None) -> int:
    """Run one command; ``device`` (else ``$DWT_DEVICE``, else the card)
    is where the codec runs.  Returns the exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("encode", "decode", "tiled-encode"):
        return _err("usage: dwt_tpu_torch {encode,decode,tiled-encode} IN "
                    "OUT [CAPACITY|PIXELS|TILE [BUDGET]]")
    mode, args = argv[0], argv[1:]

    from .codec.encoder import _device

    try:
        device = _device(device or os.environ.get("DWT_DEVICE") or None)
    except RuntimeError as e:  # no card, and the CPU was not asked for
        return _err(str(e))
    trace_dir = os.environ.get("DWT_TRACE")
    if trace_dir:
        from .utils.trace import device_trace

        with device_trace(trace_dir):
            return _run(mode, args, device)
    return _run(mode, args, device)


def _write(path: str, data: bytes) -> None:
    if path == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            f.write(data)


def _run(mode: str, args: list, device) -> int:
    from .io import pnm

    if mode == "tiled-encode":
        if len(args) not in (2, 3, 4):
            return _err("usage: dwt_tpu_torch tiled-encode input.pnm "
                        "output.dwtt [TILE] [BUDGET]")
        from .codec import tiled

        img, _ = pnm.read_pnm(args[0])
        t = int(args[2]) if len(args) >= 3 else 512
        budget = int(args[3]) if len(args) == 4 else 0
        data = tiled.encode_tiled(img, tile=(t, t), budget=budget,
                                  device=device)
        _write(args[1], data)
        print(f"{len(data)} bytes, {t}x{t} tiles", file=sys.stderr)
        return 0

    if len(args) not in (2, 3):
        if mode == "encode":
            return _err("usage: dwt_tpu_torch encode input.pnm output.dwt "
                        "[CAPACITY]")
        return _err("usage: dwt_tpu_torch decode input.dwt output.pnm "
                    "[PIXELS]")

    if mode == "encode":
        from .codec import encoder
        from .geometry import MAX_DIM, MIN_LEN

        img, _ = pnm.read_pnm(args[0])
        h, w = img.shape[:2]
        if w > MAX_DIM or h > MAX_DIM or w < MIN_LEN or h < MIN_LEN:
            return _err(f"unsupported image size {w}x{h}")
        capacity = int(args[2]) if len(args) == 3 else 0
        enc = encoder.get_encoder(w, h, img.shape[2], device)
        stream, info = enc.encode_with_stats(img, capacity=capacity)
        _write(args[1], stream)
        # Reference-style stage counters (encode.c:176,180,230): meta and
        # root bits separately, then the total (which includes both).
        print(f"{info['meta_bits']} bits for meta data", file=sys.stderr)
        print(f"{info['root_bits']} bits for root image", file=sys.stderr)
        print(f"{info['payload_bits'] + info['meta_bits']} bits "
              f"({(len(stream) + 512) // 1024} KiB) encoded; "
              f"planes={info['planes']} levels={info['levels']} "
              f"{info['mps']:.2f} MP/s", file=sys.stderr)
        return 0

    from .codec import decoder

    if args[0] == "-":
        stream = sys.stdin.buffer.read()
    else:
        with open(args[0], "rb") as f:
            stream = f.read()
    pixels = int(args[2]) if len(args) == 3 else 0
    try:
        # decoder.decode reads a tiled container (magic 'WT') too.
        img, gray = decoder.decode(stream, pixels_max=pixels, device=device)
    except ValueError as e:
        return _err(str(e))
    pnm.write_pnm(args[1], img, gray=gray)
    return 0


if __name__ == "__main__":
    sys.exit(main())
