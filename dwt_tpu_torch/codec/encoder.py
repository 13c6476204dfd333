"""Single-stream encoder: the entry point of the port's encode path.

Port of ``dwt_tpu/codec/encoder.py``'s ``Encoder``, ``get_encoder`` and
``encode``: stage 1 (codec/stage1.py), the tokens half (codec/tokens.py)
and the emit half (codec/emit.py), writing the same ``.dwt`` bytes as the
JAX package and the reference C encoder.  CUDA kernels run on the
path: the forward transform and the plane statistics, the linearization
gather (and its one-time probe when an encoder is built), compaction
kernels A and B, the VLI order scan, and the codeword packer.  The stages take a leading frame axis:
``Encoder.stage1_frames`` and ``Encoder.emit_frames`` run N frames of the
geometry through one pipeline (``codec/tiled.py``'s batch mode), and one
stream is the case N = 1 (``Encoder.stage1``, ``Encoder.emit``).

A byte budget (``capacity > 0``) masks the schedule steps that start past
it before stage 2 (``_truncate_schedule``), and ``encode`` routes to the
tiled ``.dwtt`` container (``codec/tiled.py``) when asked to, or when an
image does not fit one stream.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from ..geometry import compute_pyramid
from ..ops import compact, pack
from ..ops.hilbert_gather import engine_supported
from .emit import _stage2_emit, _stream_words
# _check_planes is the encoder's too (its callers and tests reach it here).
from .stage1 import (ALIGN, NSTATE, PMAX, _check_planes,  # noqa: F401
                     _transform_and_stats, frame, gather_source, one_frame)
from .tokens import _stage2_tokens

# Coefficient ceiling of one .dwt stream (as in the JAX package): beyond it
# the JAX package writes the tiled .dwtt container.
SINGLE_STREAM_MAX_COEFFS = 1 << 27


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _batch_needs(n: int, nlin: int, pyr, channels: int,
                 padded_T: int) -> dict:
    """The int32 index ranges of one stage-2 launch over ``n`` frames (see
    :func:`_check_batch`), each linear in ``n``."""
    return {
        "stream words": n * _stream_words(pyr, channels, padded_T),
        "token pairs": n * (padded_T // 2 + compact.WTOK_BIG + 256),
        "packed elements": n * channels * nlin + compact.E,
        "token slots": n * (padded_T + 1),
    }


def max_tokens(pyr, channels: int) -> int:
    """The most token slots (``stats["T"]``) a frame of the geometry can
    need, from the format: a root band of ``pix0`` coefficients gives a
    channel at most 1 + 2 * pix0 tokens, the steps' base starts C slots
    later, every detail coefficient turns significant at one plane at
    most (2 tokens), each of the C * L * PMAX steps adds at most one
    refinement-run token and one pad slot, and one flush token ends the
    stream."""
    steps = channels * pyr.levels * PMAX
    return 2 * channels * (1 + pyr.total) + 2 * steps + 1


def max_batch(nlin: int, pyr, channels: int, padded_T: int) -> int:
    """The largest ``n`` for which :func:`_check_batch` passes (0 when not
    even one frame does)."""
    at0 = _batch_needs(0, nlin, pyr, channels, padded_T)
    at1 = _batch_needs(1, nlin, pyr, channels, padded_T)
    return max(0, min((2**31 - 1 - at0[k]) // (at1[k] - at0[k])
                      for k in at0))


def _check_batch(n: int, nlin: int, pyr, channels: int,
                 padded_T: int) -> None:
    """The int32 bounds of one stage-2 launch over ``n`` frames laid end to
    end at token bucket ``padded_T`` (``nlin``: the linearized length of a
    channel): the pack kernel's word indices and kernel B's word windows
    (n stream buffers), kernel A's pair windows (n pair buffers), the
    packed elements' index and the token slots must stay below 2^31.
    Raises before anything is allocated: a sub-batch is never split behind
    the caller's back (``BatchEncoder`` sizes its sub-batches by
    :func:`max_batch`)."""
    need = _batch_needs(n, nlin, pyr, channels, padded_T)
    over = {k: v for k, v in need.items() if v >= 2**31}
    if over:
        raise ValueError(
            f"a sub-batch of {n} {pyr.width}x{pyr.height} frames at token "
            f"bucket {padded_T} needs {over}, past the kernels' int32 "
            "indices (2^31); encode fewer frames a sub-batch")


def _host_totals(bits_parts, order_flag, layer_ends) -> tuple:
    """Exact stream bit count of each frame from the (N, K) int32 partial
    sums, totaled in Python ints so nothing can wrap, after the pack
    kernel's order check (:func:`pack.check_order`), and the (N, LMAX)
    layer-end bit offsets as int64: one device-to-host copy for the
    sub-batch.  Returns (list of totals, layer ends)."""
    n, k = bits_parts.shape
    host = torch.cat([order_flag, bits_parts.reshape(-1),
                      layer_ends.reshape(-1)]).cpu().numpy()
    pack.check_order(host[:1])
    parts = host[1:1 + n * k].reshape(n, k).astype(np.int64)
    return ([int(t) for t in parts.sum(axis=1)],
            host[1 + n * k:].reshape(n, -1).astype(np.int64))


def _check_stream_bits(total_bits: int) -> int:
    """Single-stream bit offsets are int32: a stream of 2^31 bits or more
    would have wrapped them."""
    if total_bits >= 2**31:
        raise ValueError(
            f"stream needs {total_bits} bits; single .dwt streams are "
            "limited to 2^31 bits — use the tiled container "
            "(container=True / encode_tiled)")
    return total_bits


def _stream_words_bytes(words: torch.Tensor, nbytes: int) -> bytes:
    """The first ``nbytes`` bytes of the little-endian stream words."""
    n = (nbytes + 3) // 4
    return words[:n].cpu().numpy().astype("<i4").tobytes()[:nbytes]


def _bucket(t: int) -> int:
    """Token counts padded to coarse buckets (sixteenths of powers of two,
    multiples of the pack block), as in the JAX package."""
    t = max(t, 4 * pack.BLOCKN)
    b = 1 << (t - 1).bit_length()
    for m in range(9, 16):
        if m * b // 16 >= t:
            b = m * b // 16
            break
    return _round_up(b, pack.BLOCKN)


def _ilog2_host(x: int) -> int:
    return x.bit_length() - 1


def _root_bits_host(stats, pix0: int) -> int:
    """Exact bit count of the root-band coding (encode.c:97-110), replayed
    on the host from the stage-1 stats' host copy (:func:`host_stats`):
    per channel one VLI(cnt) through the adaptive order chain (which
    starts at 0), then cnt raw bits per coefficient and one sign bit per
    nonzero."""
    root_cnt = np.asarray(stats["root_cnt"])
    root_base = np.asarray(stats["root_base"])
    planes_base = int(stats["planes_base"])
    ends = np.concatenate([root_base[1:], [planes_base]])
    bits = 0
    s = 0
    for c in range(root_cnt.shape[0]):
        v = cnt = int(root_cnt[c])
        k = max(_ilog2_host(v + (1 << s)) - s, 0)
        bits += 2 * k + s + 1
        s = min(max(s + k - 2, 0), NSTATE - 1)
        if cnt > 0:
            nnz = int(ends[c] - root_base[c]) - 1 - pix0
            bits += pix0 * cnt + nnz
    return bits


_TRUNC_STATS_KEYS = ("order", "valid_sched", "nS_sched", "base_sched",
                     "valid", "nRef", "refrun_ok", "inj_pos", "T",
                     "root_cnt", "root_base", "planes_base", "planes_max")

# The stats leaves that a schedule cut replaces, with their dtypes.
_PATCH_DTYPES = {"valid": torch.bool, "refrun_ok": torch.bool,
                 "inj_pos": torch.int32, "valid_sched": torch.bool,
                 "nS_sched": torch.int32, "T": torch.int32}


def host_stats(stats, keys: tuple = _TRUNC_STATS_KEYS) -> dict:
    """Numpy copies of the stats leaves ``keys`` (by default those that the
    schedule cuts read), with the stats' leading frame axis if they have
    one (:func:`frame` takes a frame's): one device-to-host copy."""
    ts = [torch.as_tensor(stats[k]) for k in keys]
    flat = torch.cat([t.reshape(-1).to(torch.int32) for t in ts]).cpu()
    out, o = {}, 0
    for k, t in zip(keys, ts):
        v = flat[o:o + t.numel()].reshape(t.shape)
        out[k] = (v != 0 if t.dtype == torch.bool else v).numpy()
        o += t.numel()
    return out


def patch_stats(stats, upd: dict) -> dict:
    """One frame's ``stats`` with the leaves of a schedule cut (numpy)
    replaced by tensors on the stats' device, in the stage-1 dtypes."""
    dev = stats["order"].device
    return {**stats, **{k: torch.as_tensor(v, dtype=_PATCH_DTYPES[k],
                                           device=dev)
                        for k, v in upd.items()}}


def patch_frames(stats, upds: dict) -> dict:
    """Batched ``stats`` with frame i's leaves replaced by the schedule
    cut ``upds[i]`` (numpy, as :func:`patch_stats` takes), for each frame
    of ``upds``: one host-to-device copy a leaf.  The given stats are left
    as they were."""
    if not upds:
        return stats
    dev = stats["order"].device
    ids = sorted(upds)
    rows = torch.as_tensor(ids, device=dev)
    out = dict(stats)
    for k, dt in _PATCH_DTYPES.items():
        t = stats[k].clone()
        t[rows] = torch.as_tensor(np.stack([upds[i][k] for i in ids]),
                                  dtype=dt, device=dev)
        out[k] = t
    return out


def _step_lb_bits(sh: dict) -> np.ndarray:
    """(S,) int64 lower bound on each schedule step's bits: a VLI bit and a
    sign bit per significant pair, one bit per ref-run token, one bit per
    refinement bit."""
    order = sh["order"]
    nref = np.where(sh["valid"].reshape(-1), sh["nRef"].reshape(-1), 0)
    rro = sh["refrun_ok"].reshape(-1)[order] & sh["valid_sched"]
    return (2 * sh["nS_sched"].astype(np.int64) + rro.astype(np.int64)
            + nref[order].astype(np.int64))


def _truncate_schedule(sh: dict, capacity: int, pyr, channels: int):
    """Budget-bounded work (bytes.h:75-78 as work skipping, not just
    output slicing): given host copies of the stage-1 stats, mask every
    schedule step that provably starts at or beyond ``capacity`` bytes and
    shrink the token count accordingly.  The bits below the budget are
    untouched (every included token keeps its full-encode rank, VLI order
    and bit offset), so ``stream[:capacity]`` equals the cut of the full
    encode, while a deep cut runs stage 2 over a fraction of the tokens.

    Inclusion uses per-step lower bounds on bit cost
    (:func:`_step_lb_bits`, and the exact root-band bits): a step whose
    bounded start reaches the budget truly starts past it.

    Returns a dict of replacement stats leaves (numpy), or None when the
    whole schedule might be needed."""
    lb_s = _step_lb_bits(sh)
    pre = _root_bits_host(sh, pyr.pixels[0]) + channels  # + plane VLIs
    start_lb = pre + np.cumsum(lb_s) - lb_s
    include = start_lb < capacity * 8
    if include.all():
        return None
    k = int(np.nonzero(include)[0][-1]) if include.any() else -1
    return _mask_schedule_suffix(sh, k, pyr, channels)


def _mask_schedule_suffix(sh: dict, k: int, pyr, channels: int):
    """Mask every schedule step after index ``k`` (schedule order); the
    shared tail of :func:`_truncate_schedule` and the tiled layer cap.
    Returns the replacement stats leaves (numpy), or None if nothing is
    cut."""
    order = sh["order"]
    base_s = sh["base_sched"]
    S = order.size
    T_old = int(sh["T"])
    T_new = int(base_s[k + 1]) + 1 if k + 1 < S else T_old
    if T_new >= T_old:
        return None
    excl = order[k + 1:]
    shape = (channels, pyr.levels, PMAX)
    valid_new = sh["valid"].reshape(-1).copy()
    valid_new[excl] = False
    rro_new = sh["refrun_ok"].reshape(-1).copy()
    rro_new[excl] = False
    inj_new = sh["inj_pos"].reshape(-1).copy()
    if k >= 0:
        # The last included step injects its refinement bits at the flush
        # slot, as the full schedule's final step does.
        inj_new[order[k]] = T_new - 1
    vs_new = sh["valid_sched"].copy()
    vs_new[k + 1:] = False
    ns_new = sh["nS_sched"].copy()
    ns_new[k + 1:] = 0
    return dict(
        valid=valid_new.reshape(shape),
        refrun_ok=rro_new.reshape(shape),
        inj_pos=inj_new.reshape(shape).astype(np.int32),
        valid_sched=vs_new,
        nS_sched=ns_new.astype(np.int32),
        T=np.int32(T_new),
    )


def _schedule_layers_host(sh: dict, pyr, channels: int):
    """(S,) quality-layer bucket of each schedule step, in schedule order
    (pre-step = 0; as emit._layer_boundaries buckets them)."""
    L = pyr.levels
    order = sh["order"]
    pm = int(sh["planes_max"])
    c_s = order // (L * PMAX)
    l_s = (order // PMAX) % L
    p_s = order % PMAX
    layers = np.where(c_s == 0, pm - 2 - p_s + l_s, pm - 1 - p_s + l_s)
    return np.maximum(layers, -1) + 1


def _layer_lb_bytes_host(sh: dict, pyr, channels: int, n_layers: int):
    """(n_layers,) lower-bound byte cost each quality layer adds to this
    tile's stream (floor of the bit bound; layer 0 includes the exact
    root-band and plane-count bits).  True layer costs are >= these, so a
    budget waterline computed from them includes a superset of the layers
    the true allocation keeps: masking beyond it is always safe."""
    lb_s = np.where(sh["valid_sched"], _step_lb_bits(sh), 0)
    buckets = _schedule_layers_host(sh, pyr, channels)
    bits = np.zeros(n_layers, np.int64)
    np.add.at(bits, np.clip(buckets, 0, n_layers - 1), lb_s)
    bits[0] += _root_bits_host(sh, pyr.pixels[0]) + channels
    return bits // 8


def _truncate_schedule_to_layer(sh: dict, max_layer: int, pyr,
                                channels: int):
    """Mask every schedule step of a quality layer beyond ``max_layer``
    (steps are schedule-ordered, so later layers form a suffix).  Returns
    replacement stats leaves or None (nothing cut)."""
    buckets = _schedule_layers_host(sh, pyr, channels)
    include = (buckets <= max_layer) & sh["valid_sched"]
    k = int(np.nonzero(include)[0][-1]) if include.any() else -1
    return _mask_schedule_suffix(sh, k, pyr, channels)


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dwt_tpu_torch: no CUDA device; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


class Encoder:
    """Encoder for one (width, height, channels) geometry on one device:
    holds the static layout (the gather's source index) and reuses it
    across images.  ``device`` defaults to the CUDA card."""

    def __init__(self, width: int, height: int, channels: int, device=None):
        self.device = _device(device)
        self.pyr = compute_pyramid(width, height)
        self.channels = channels
        self.gray = channels == 1
        seg_max = max((self.pyr.pixels[l + 1] - self.pyr.pixels[l]
                       for l in range(self.pyr.levels)), default=0) + ALIGN
        if seg_max >= 1 << 30:
            # Kernel A packs (zero-prefix << 1) | sign into one int32.
            raise NotImplementedError(
                f"{width}x{height}: a detail segment of 2^30 elements or more "
                "is not supported by the single-stream encoder; use the tiled "
                "container (encode() reroutes such images)")
        engine_supported(self.device)  # the gather's probe, once a device
        self._src = torch.as_tensor(gather_source(self.pyr),
                                    device=self.device)
        # Pinned staging buffers of the upload, one a frame shape and dtype,
        # each with the event recorded behind its last copy.
        self._staging: dict = {}

    def header(self) -> bytes:
        w, h = self.pyr.width, self.pyr.height
        return bytes([
            ord("W"), ord("5") if self.gray else ord("6"),
            (w - 1) & 255, ((w - 1) >> 8) & 255,
            (h - 1) & 255, ((h - 1) >> 8) & 255,
        ])

    def encode(self, img: np.ndarray, capacity: int = 0) -> bytes:
        return self.encode_with_stats(img, capacity)[0]

    def stage1_frames(self, imgs: np.ndarray) -> tuple:
        """Stage 1 of N (N, H, W, C) or (N, H, W) frames in one pipeline:
        (lin, stats) on the encoder's device, every leaf with a leading
        frame axis.  Raises if a frame needs more planes than the format
        holds."""
        imgs = np.asarray(imgs)
        if imgs.ndim == 3:
            imgs = imgs[..., None]
        shape = (self.pyr.height, self.pyr.width, self.channels)
        if imgs.ndim != 4 or imgs.shape[1:] != shape:
            raise ValueError(f"frames of shape {imgs.shape[1:]} do not "
                             f"match the encoder's {shape}")
        return _transform_and_stats(self._upload(imgs), self.pyr,
                                    self.channels, self.gray, self._src)

    def _upload(self, imgs: np.ndarray) -> torch.Tensor:
        """The frames on the encoder's device, in their own dtype.  To the
        card through a pinned staging buffer kept per frame shape, copied
        without blocking on the current stream; the buffer is refilled
        only after the copy recorded behind its last use has completed."""
        if self.device.type != "cuda":
            return torch.as_tensor(imgs, device=self.device)
        host = torch.from_numpy(np.ascontiguousarray(imgs))
        key = (tuple(host.shape), host.dtype)
        if key not in self._staging:
            self._staging[key] = [torch.empty(host.shape, dtype=host.dtype,
                                              pin_memory=True), None]
        staged = self._staging[key]
        if staged[1] is not None:
            staged[1].synchronize()
        staged[0].copy_(host)
        out = torch.empty(host.shape, dtype=host.dtype, device=self.device)
        out.copy_(staged[0], non_blocking=True)
        staged[1] = torch.cuda.Event()
        staged[1].record(torch.cuda.current_stream(self.device))
        return out

    def emit_frames(self, lin, stats, padded_T: int) -> tuple:
        """Stage 2 of N frames (``stage1_frames``' output) at token bucket
        ``padded_T`` (>= every frame's T), each kernel launched once for
        the N frames.  Returns (payloads without the header, total bits,
        (N, LMAX) int64 layer-end bit offsets)."""
        pyr, C = self.pyr, self.channels
        _check_batch(lin.shape[0], lin.shape[-1], pyr, C, padded_T)
        tv, tr, tf, orders, vmag, com = _stage2_tokens(lin, stats, pyr, C,
                                                       padded_T)
        order_flag = torch.zeros(1, dtype=torch.int32, device=self.device)
        words, bits_parts, _, layer_ends = _stage2_emit(
            lin, stats, tv, tr, tf, orders, vmag, com, pyr, C, padded_T,
            order_flag)
        totals, ends = _host_totals(bits_parts, order_flag, layer_ends)
        totals = [_check_stream_bits(t) for t in totals]
        return ([_stream_words_bytes(words[i], (t + 7) // 8)
                 for i, t in enumerate(totals)], totals, ends)

    def stage1(self, img: np.ndarray) -> tuple:
        """Stage 1 of one (H, W, C) or (H, W) image: (lin, stats) on the
        encoder's device, the N = 1 case of :meth:`stage1_frames` (frame
        0's views)."""
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        lin, stats = self.stage1_frames(img[None])
        return lin[0], frame(stats, 0)

    def emit(self, lin, stats, padded_T: int) -> tuple:
        """Stage 2 of one image at token bucket ``padded_T`` (>= T), the N
        = 1 case of :meth:`emit_frames`.  Returns (payload bytes without
        the header, total bits, (LMAX,) int64 layer-end bit offsets)."""
        payloads, totals, ends = self.emit_frames(lin[None],
                                                  one_frame(stats), padded_T)
        return payloads[0], totals[0], ends[0]

    def encode_with_stats(self, img: np.ndarray, capacity: int = 0) -> tuple:
        """Returns (stream bytes, info dict) — the structured counterpart of
        the reference's stderr bit counters (encode.c:176,180,230).
        ``capacity > 0`` cuts the stream to that many bytes, and skips the
        coding work of every schedule step that starts past it."""
        pyr = self.pyr
        t0 = time.perf_counter()
        img = np.asarray(img)
        lin, stats = self.stage1(img)
        T = int(stats["T"])
        if capacity > 0:
            # Budget-bounded work: mask schedule steps past the byte budget
            # before stage 2 (encode.c:192-216).
            upd = _truncate_schedule(host_stats(stats), capacity, pyr,
                                     self.channels)
            if upd is not None:
                stats = patch_stats(stats, upd)
                T = int(upd["T"])
        payload, total_bits, layer_ends = self.emit(lin, stats, _bucket(T))
        stream = self.header() + payload
        if capacity > 0:
            stream = stream[:capacity]
        dt = time.perf_counter() - t0
        if os.environ.get("DWT_SELFCHECK") == "1" and capacity <= 0:
            # Sanitizer mode (the codec's analog of the reference's ASan
            # build): every lossless stream must decode to the input before
            # it is returned, so a kernel that corrupts the stream is caught
            # here, not by a far-away reader.  Outside the timed span.
            from . import decoder as _decoder

            back, _ = _decoder.decode(stream, device=self.device)
            if back.size != img.size or not np.array_equal(
                    back.reshape(img.shape), img):
                raise AssertionError(
                    "DWT_SELFCHECK: stream does not decode to the input")
        le = layer_ends
        sh = host_stats(stats, ("root_cnt", "root_base", "planes_base",
                                "planes"))
        info = {
            "tokens": T,
            "payload_bits": total_bits,
            "meta_bits": 8 * len(self.header()),
            "root_bits": _root_bits_host(sh, pyr.pixels[0]),
            "bytes": len(stream),
            "planes": sh["planes"].tolist(),
            "levels": pyr.levels,
            "layer_end_bytes": np.unique(
                (le[le < 2**31 - 1] + 7) // 8).tolist(),
            "seconds": dt,
            "mps": pyr.total / 1e6 / dt,
        }
        return stream, info


@functools.lru_cache(maxsize=64)
def get_encoder(width: int, height: int, channels: int,
                device=None) -> Encoder:
    return Encoder(width, height, channels, device)


_warned_container = False


def _warn_container(reason: str) -> None:
    """One warning a process when ``encode`` writes a container that the
    reference decoder cannot read."""
    global _warned_container
    if not _warned_container:
        import warnings

        warnings.warn(
            f"dwt_tpu_torch.encode: {reason}; writing a tiled .dwtt "
            "container instead of a single .dwt stream (dwt_tpu_torch "
            "decodes it transparently; the reference C decoder cannot).  "
            "Pass container=False to force a single stream.",
            UserWarning, stacklevel=3)
        _warned_container = True


def encode(img: np.ndarray, gray: bool | None = None, capacity: int = 0,
           container: bool | None = None, device=None) -> bytes:
    """Encode to a .dwt stream (or a .dwtt container for oversized
    images).  ``gray`` is implied by the channel count (kept for the JAX
    package's signature).

    ``container``: None (default) routes images beyond the single-stream
    envelope to the tiled container with a one-time warning; True forces
    the container; False forbids it (raises instead)."""
    from . import tiled

    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if container:
        return tiled.encode_tiled(img, budget=capacity, device=device)
    if h * w * c > SINGLE_STREAM_MAX_COEFFS:
        if container is False:
            raise ValueError(
                f"{w}x{h}x{c} exceeds the single-stream envelope "
                f"({SINGLE_STREAM_MAX_COEFFS} coefficients); use the tiled "
                "container (container=True / encode_tiled)")
        _warn_container(f"{w}x{h}x{c} exceeds the single-stream envelope")
        return tiled.encode_tiled(img, budget=capacity, device=device)
    try:
        return get_encoder(w, h, c, device).encode(img, capacity)
    except ValueError as e:
        if "2^31 bits" not in str(e) or container is False:
            raise
        _warn_container("stream exceeds 2^31 bits")
        return tiled.encode_tiled(img, budget=capacity, device=device)
