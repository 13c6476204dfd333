"""Netpbm P5/P6 binary image I/O (behavioral parity with reference pnm.h).

The port's own copy of ``dwt_tpu/io/pnm.py`` (numpy only): importing the
JAX package would import JAX, which the GPU package never does.

Parsing rules (pnm.h:14-82): magic 'P5'|'P6'; then three decimal integers
(width, height, maxval) separated by arbitrary non-digit bytes, with '#'
comments running to end-of-line skipped anywhere a token may start; maxval
must be 255; pixel payload is raw bytes.  Writer (pnm.h:89-117) emits
``P{5,6} {w} {h} 255\\n`` and clamps samples to [0, 255].
"""

from __future__ import annotations

import io
import sys

import numpy as np


def read_pnm(path) -> tuple:
    """Returns (img, gray): img is (H, W, C) uint8 with C in {1, 3}."""
    if path == "-":
        data = sys.stdin.buffer.read()
    elif isinstance(path, (bytes, bytearray)):
        data = bytes(path)
    else:
        with open(path, "rb") as f:
            data = f.read()
    if len(data) < 2 or data[0:1] != b"P" or data[1:2] not in (b"5", b"6"):
        raise ValueError("not a binary P5/P6 PNM file")
    gray = data[1:2] == b"5"
    channels = 1 if gray else 3

    pos = 2
    fields = []
    n = len(data)
    while len(fields) < 3:
        if pos >= n:
            raise ValueError("EOF in PNM header")
        c = data[pos]
        if c == ord("#"):
            while pos < n and data[pos] != ord("\n"):
                pos += 1
            pos += 1
            continue
        if ord("0") <= c <= ord("9"):
            start = pos
            while pos < n and ord("0") <= data[pos] <= ord("9"):
                pos += 1
            fields.append(int(data[start:pos]))
            continue
        pos += 1
    width, height, maxval = fields
    if not (width and height and maxval):
        raise ValueError("bad PNM dimensions")
    if maxval != 255:
        raise ValueError("only 8-bit-per-channel PNM supported")
    # Exactly one whitespace byte separates the header from the payload.
    pos += 1
    need = width * height * channels
    if len(data) - pos < need:
        raise ValueError("EOF in PNM payload")
    # A copy: a writable array, which torch.as_tensor takes without a
    # warning.
    img = np.frombuffer(data, np.uint8, need, pos).reshape(
        height, width, channels).copy()
    return img, gray


def write_pnm(path, img: np.ndarray, gray: bool | None = None) -> None:
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if gray is None:
        gray = c == 1
    header = f"P{5 if gray else 6} {w} {h} 255\n".encode()
    payload = np.clip(img, 0, 255).astype(np.uint8).tobytes()
    if path == "-":
        sys.stdout.buffer.write(header + payload)
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            f.write(header + payload)


def pnm_bytes(img: np.ndarray, gray: bool | None = None) -> bytes:
    """Serialize to an in-memory PNM byte string."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if gray is None:
        gray = c == 1
    header = f"P{5 if gray else 6} {w} {h} 255\n".encode()
    return header + np.clip(img, 0, 255).astype(np.uint8).tobytes()
