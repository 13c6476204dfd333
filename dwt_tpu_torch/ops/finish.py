"""The encoder's token finisher and packed elements (kernels ``csrc/finish.cu``).

No TPU kernel to port: the JAX package computes both as XLA
(``dwt_tpu/codec/encoder.py:_finish_tokens`` and ``_packed_elems``, fused
into its stage-2 program on the TPU).

:func:`finish_tokens` (kernel 12) completes the (N, padded_T) token arrays
from kernel A's pairs (``(zero-prefix << 1) | sign`` at each newly
significant element's PAIR rank; step bases are even, so pair p is token
slots 2p and 2p + 1).  Its dense pass writes every slot: a pair inside its
step (``p < base / 2 + nS`` of the last step whose clamped pair base is at
most p) becomes a run token (the zero-prefix less the previous pair's, or
plus the step's zero carry at its first pair) and a raw sign bit; any
other pair keeps its zero-prefix and sign as they lie.  Then, per frame
and in the JAX package's order, the root counts, root magnitudes and
their raw counts, root signs, plane counts, ref-run tokens and the flush
at ``T - 1`` overwrite their slots; a masked one is not written.

:func:`packed_elems` (kernel 13) writes the ((N*C*n + E) / SUBA, SUBA)
int32 rows of kernels A and B: ``|c| | sign << 30`` of each valid detail
element, frame after frame and channel after channel, and -1 at pads and
in the E-element tail.

On the card each wrapper is one call of its C entry (``launches`` grows by
1): kernel 12 launches its dense pass over all the frames' pairs and then
one block a frame for the special tokens, on one stream; kernel 13 is one
launch.  Each raises on a layout its kernel does not take and never falls
back.  On the CPU: :func:`finish_tokens_plain` and
:func:`packed_elems_plain`, the eager passes the encoder ran before.
"""

from __future__ import annotations

import torch

from ..runtime import build
from . import compact
from ._launch import need
from .plane_stats import _excl_cumsum

_I32 = torch.int32
PAIRS = 4            # pairs a thread of the dense pass (csrc/finish.cu)
# Steps a frame's table may hold: the dense pass stages the table in shared
# memory, 16 bytes a step.  The format's schedule has C * L * 29 steps (783
# for a 4K RGB frame).
MAX_STEPS = 12288


def _split_pairs(pairs: torch.Tensor) -> tuple:
    """Kernel A's ``(zero-prefix << 1) | sign`` pairs -> (zero-prefixes,
    signs)."""
    return pairs >> 1, pairs & 1


def _interleave2(a, b):
    """``[a0, b0, a1, b1, ...]`` along the last axis of same-shape ``a``
    and ``b``."""
    return torch.stack([a, b], dim=-1).reshape(*a.shape[:-1], -1)


def _fill_max(pos, vals, idx):
    """``cummax(zeros(n).scatter_reduce(-1, pos, vals, "amax"))[..., idx]``:
    the max of 0 and of every ``vals[..., j]`` with ``pos[..., j] <= i``,
    by a binary search of the (..., S) sorted positions instead of a scan
    over all n (torch's cummax kernel is slow).  ``idx`` (n,) is shared by
    the leading axes."""
    o = torch.argsort(pos, dim=-1, stable=True)
    best = torch.cummax(vals.gather(-1, o).clamp(min=0), dim=-1).values
    idx = idx.expand(*pos.shape[:-1], -1).contiguous()
    k = torch.searchsorted(pos.gather(-1, o), idx, right=True) - 1
    return torch.where(k >= 0, best.gather(-1, k.clamp(min=0)), 0)


def _rows_ok(t: torch.Tensor) -> bool:
    """Rows of unit stride that do not overlap (any row stride past the
    row's length)."""
    w = t.shape[-1]
    return (w <= 1 or t.stride(-1) == 1) and all(
        t.shape[d] <= 1 or t.stride(d) >= w for d in range(t.dim() - 1))


def _strides(t: torch.Tensor) -> tuple:
    """The frame and channel strides of a 3-D tensor in elements (0 on an
    axis of one)."""
    return tuple(t.stride(d) if t.shape[d] > 1 else 0 for d in (0, 1))


def _check_finish(pairs, root, base_sched, nS_sched, cin_sched, valid_sched,
                  root_cnt, root_base, planes_base, planes, refrun_ok,
                  step_base, nS, refrun_val, T, carry_end) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on anything the kernel does not take."""
    need("finish_tokens pairs", pairs, _I32, 2)
    need("finish_tokens root", root, _I32, 3)
    N, npair = pairs.shape
    C = root.shape[1]
    for name, t in (("base_sched", base_sched), ("nS_sched", nS_sched),
                    ("cin_sched", cin_sched)):
        need(f"finish_tokens {name}", t, _I32, 2)
    need("finish_tokens valid_sched", valid_sched, torch.bool, 2)
    for name, t in (("root_cnt", root_cnt), ("root_base", root_base),
                    ("planes", planes)):
        need(f"finish_tokens {name}", t, _I32, 2)
    for name, t in (("planes_base", planes_base), ("T", T),
                    ("carry_end", carry_end)):
        need(f"finish_tokens {name}", t, _I32, 1)
    if refrun_ok.dtype != torch.bool:
        raise ValueError("finish_tokens: refrun_ok must be bool")
    for name, t in (("step_base", step_base), ("nS", nS),
                    ("refrun_val", refrun_val)):
        if t.dtype != _I32:
            raise ValueError(f"finish_tokens: {name} must be int32")
    S = base_sched.shape[1]
    grids = (refrun_ok, step_base, nS, refrun_val)
    shapes_ok = (
        root.shape[0] == N
        and all(t.shape == (N, S) for t in (nS_sched, cin_sched,
                                            valid_sched))
        and all(t.shape == (N, C) for t in (root_cnt, root_base, planes))
        and all(t.shape == (N,) for t in (planes_base, T, carry_end))
        and all(t.shape == refrun_ok.shape and t.shape[0] == N
                for t in grids))
    if not shapes_ok:
        raise ValueError("finish_tokens: inconsistent shapes: pairs "
                         f"{tuple(pairs.shape)}, root {tuple(root.shape)}, "
                         f"step tables {tuple(base_sched.shape)}, step grid "
                         f"{tuple(refrun_ok.shape)}")
    tensors = (pairs, root, base_sched, nS_sched, cin_sched, valid_sched,
               root_cnt, root_base, planes_base, planes, *grids, T,
               carry_end)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"finish_tokens: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"finish_tokens: unsupported device {dev}")
    if not all(_rows_ok(t) for t in tensors[:6]):
        raise ValueError("finish_tokens: the pairs, the root band and the "
                         "step tables must be rows of unit stride that do "
                         "not overlap")
    if any(not t.is_contiguous() for t in tensors[6:]):
        raise ValueError("finish_tokens: the frame tables and the step grid "
                         "must be contiguous")
    row = pairs.stride(0) if N > 1 else npair
    if npair % PAIRS or row % PAIRS or pairs.data_ptr() % 16:
        raise ValueError(
            f"finish_tokens: the kernel reads {PAIRS} pairs a 16-byte word: "
            f"{npair} pairs a frame at row stride {row} from address "
            f"{pairs.data_ptr():#x} do not lie so")
    if S > MAX_STEPS:
        raise ValueError(f"finish_tokens: {S} steps a frame, past the "
                         f"kernel's {MAX_STEPS}")
    return True


def finish_tokens_plain(pairs, root, base_sched, nS_sched, cin_sched,
                        valid_sched, root_cnt, root_base, planes_base, planes,
                        refrun_ok, step_base, nS, refrun_val, T,
                        carry_end) -> tuple:
    """Plain PyTorch version of :func:`finish_tokens`: step membership by
    forward fills of the schedule-step tables (:func:`_fill_max`), run
    values as diffs of consecutive zero-prefixes (+ the step's cross-step
    zero carry at its first pair), then root, plane-count, ref-run and
    flush tokens as small scatters, each frame's into its own row (flat
    index f * (padded_T + 1) + slot; slot padded_T takes masked writes).
    Constants go in by ``index_fill_``, whose scalar needs no host-to-device
    copy."""
    _check_finish(pairs, root, base_sched, nS_sched, cin_sched, valid_sched,
                  root_cnt, root_base, planes_base, planes, refrun_ok,
                  step_base, nS, refrun_val, T, carry_end)
    zp, sgn = _split_pairs(pairs)
    N, C, pix0 = root.shape
    dev = zp.device
    npair = zp.shape[1]
    padded_T = 2 * npair
    DUMP = padded_T

    pa = torch.arange(npair, dtype=_I32, device=dev)
    base_p = base_sched >> 1
    bpos = base_p.clamp(0, npair - 1).long()
    zero_p = torch.zeros((N, npair), dtype=_I32, device=dev)
    sb_f = _fill_max(bpos, base_p, pa)
    se_f = _fill_max(bpos, base_p + nS_sched, pa)
    in_sig = pa < se_f  # pad pairs / pre-step region: se_f <= pa
    first = pa == sb_f
    cin_add = zero_p.scatter_add(1, bpos, torch.where(
        valid_sched & (nS_sched > 0), cin_sched, 0))
    prev1 = torch.cat([zero_p[:, :1], zp[:, :-1]], dim=1)
    runval = zp - torch.where(first, 0, prev1) + cin_add

    # spare DUMP slot for masked small scatters
    tok_val = torch.cat([_interleave2(torch.where(in_sig, runval, zp), sgn),
                         zero_p[:, :1]], dim=1)
    tok_raw = torch.cat([_interleave2(zero_p, in_sig.to(_I32)),
                         zero_p[:, :1]], dim=1)
    tok_vli = torch.cat([_interleave2(in_sig, torch.zeros_like(in_sig)),
                         in_sig[:, :1] & False], dim=1)
    val, raw, vli = (t.view(-1) for t in (tok_val, tok_raw, tok_vli))
    rows = torch.arange(N, device=dev) * (padded_T + 1)  # row starts

    def at(slot):
        """Flat indices of the (N, ...) per-frame slots ``slot``."""
        return (slot.long() + rows.view(N, *[1] * (slot.dim() - 1))
                ).reshape(-1)

    # --- root band tokens (encode.c:97-110) -------------------------------
    nnzpfx = _excl_cumsum((root != 0).to(_I32), dim=2)
    i_ix = torch.arange(pix0, dtype=_I32, device=dev)[None, None, :]
    val[at(root_base)] = root_cnt.reshape(-1)
    vli.index_fill_(0, at(root_base), True)
    r_rank = root_base[:, :, None] + 1 + i_ix + nnzpfx
    r_ok = root_cnt[:, :, None] > 0
    r_rank_m = at(torch.where(r_ok, r_rank, DUMP))
    val[r_rank_m] = root.abs().reshape(-1)
    raw[r_rank_m] = root_cnt[:, :, None].expand(root.shape).reshape(-1)
    s_ok = r_ok & (root != 0)
    s_rank = at(torch.where(s_ok, r_rank + 1, DUMP))
    val[s_rank] = (root < 0).to(_I32).reshape(-1)
    raw.index_fill_(0, s_rank, 1)

    # --- per-channel plane counts (encode.c:181-182) ----------------------
    pr = at(planes_base[:, None] + torch.arange(C, dtype=_I32, device=dev))
    val[pr] = planes.reshape(-1)
    vli.index_fill_(0, pr, True)

    # --- ref-pass leading run tokens + final flush (rle_flush) ------------
    rr_rank = at(torch.where(refrun_ok, step_base + 2 * nS, DUMP))
    val[rr_rank] = refrun_val.reshape(-1)
    vli.index_fill_(0, rr_rank, True)
    t_last = at(T[:, None] - 1)
    val[t_last] = carry_end
    vli.index_fill_(0, t_last, True)

    return tuple(t[:, :padded_T].contiguous()
                 for t in (tok_val, tok_raw, tok_vli))


def finish_tokens(pairs, root, base_sched, nS_sched, cin_sched, valid_sched,
                  root_cnt, root_base, planes_base, planes, refrun_ok,
                  step_base, nS, refrun_val, T, carry_end) -> tuple:
    """Kernel A's (N, padded_T / 2) int32 pairs (rows of unit stride at any
    row stride, as the pair buffer lies), the (N, C, pix0) root band and
    the (N, S) schedule-ordered step tables (``base_sched``, ``nS_sched``,
    ``cin_sched``, ``valid_sched``), all likewise, and the contiguous
    per-frame tables and step grid of stage 1 -> fresh contiguous (N,
    padded_T) ``tok_val`` int32, ``tok_raw`` int32 and ``tok_vli`` bool.

    The kernel relies on the schedule's order: within a frame both
    ``base_sched`` and ``base_sched / 2 + nS_sched`` are nondecreasing
    (each base is the one before plus an even count of at least twice its
    pairs, and a cut schedule keeps its bases: ``stage1._stats_from_lin``,
    ``encoder._mask_schedule_suffix``).  The step whose pair base is the
    last at most p is then the one whose fills the plain version takes at
    p; a table out of that order stops the kernel (``__trap``), since only
    the card sees it.  On the card one call (``launches`` grows by 1)."""
    if not _check_finish(pairs, root, base_sched, nS_sched, cin_sched,
                         valid_sched, root_cnt, root_base, planes_base,
                         planes, refrun_ok, step_base, nS, refrun_val, T,
                         carry_end):
        return finish_tokens_plain(
            pairs, root, base_sched, nS_sched, cin_sched, valid_sched,
            root_cnt, root_base, planes_base, planes, refrun_ok, step_base,
            nS, refrun_val, T, carry_end)
    N, npair = pairs.shape
    C, pix0 = root.shape[1], root.shape[2]
    padded_T = 2 * npair
    dev = pairs.device
    tok_val = torch.empty((N, padded_T), dtype=_I32, device=dev)
    tok_raw = torch.empty((N, padded_T), dtype=_I32, device=dev)
    tok_vli = torch.empty((N, padded_T), dtype=torch.bool, device=dev)
    if N * npair == 0:
        return tok_val, tok_raw, tok_vli
    steps = [(t.data_ptr(), t.stride(0) if N > 1 else 0)
             for t in (base_sched, nS_sched, cin_sched, valid_sched)]
    lib = build.library()
    build.check(lib.dwt_finish_tokens(
        pairs.data_ptr(), pairs.stride(0) if N > 1 else npair,
        *(x for step in steps for x in step), base_sched.shape[1],
        root.data_ptr(), *_strides(root), pix0, C,
        root_cnt.data_ptr(), root_base.data_ptr(), planes_base.data_ptr(),
        planes.data_ptr(), refrun_ok.data_ptr(), step_base.data_ptr(),
        nS.data_ptr(), refrun_val.data_ptr(), refrun_ok.numel() // N,
        T.data_ptr(), carry_end.data_ptr(), tok_val.data_ptr(),
        tok_raw.data_ptr(), tok_vli.data_ptr(), N, padded_T,
        build.stream_of(pairs)), "finish_tokens")
    finish_tokens.launches += 1
    return tok_val, tok_raw, tok_vli


finish_tokens.launches = 0


def _check_packed(lin: torch.Tensor, valid: torch.Tensor) -> bool:
    """True when both tensors lie on one CUDA device, False when both lie
    on the CPU; raises on anything the kernel does not take."""
    need("packed_elems lin", lin, _I32, 3)
    need("packed_elems valid", valid, torch.bool, 1)
    n, nlin = valid.numel(), lin.shape[2]
    if n > nlin:
        raise ValueError(f"packed_elems: {n} detail elements in rows of "
                         f"{nlin}")
    if (lin.shape[0] * lin.shape[1] * n + compact.E) % compact.SUBA:
        raise ValueError(f"packed_elems: {lin.shape[0] * lin.shape[1]} rows "
                         f"of {n} elements and a tail of {compact.E} fill no "
                         f"whole row of {compact.SUBA}")
    if lin.device != valid.device:
        raise ValueError(f"packed_elems: tensors on several devices "
                         f"{lin.device}, {valid.device}")
    if lin.device.type == "cpu":
        return False
    if lin.device.type != "cuda":
        raise ValueError(f"packed_elems: unsupported device {lin.device}")
    if not _rows_ok(lin) or not valid.is_contiguous():
        raise ValueError("packed_elems: lin must be rows of unit stride that "
                         "do not overlap, and valid contiguous")
    words = (lin.data_ptr() // 4, *_strides(lin), nlin - n, n, compact.E,
             valid.data_ptr() // 4)
    if any(w % 4 for w in words) or lin.data_ptr() % 4:
        raise ValueError(
            "packed_elems: the kernel moves 4 elements a 16-byte word: the "
            "detail rows (their start, frame and channel strides, root pad "
            "and length), the tail and the mask must lie on 16-byte words")
    return True


def packed_elems_plain(lin: torch.Tensor, valid: torch.Tensor):
    """Plain PyTorch version of :func:`packed_elems`."""
    _check_packed(lin, valid)
    det = lin[..., lin.shape[2] - valid.numel():]
    vm = torch.where(valid[None, :], det.abs() | ((det < 0).to(_I32) << 30),
                     -1)
    flat = torch.cat([vm.reshape(-1),
                      torch.full((compact.E,), -1, dtype=_I32,
                                 device=lin.device)])
    return flat.reshape(-1, compact.SUBA)


def packed_elems(lin: torch.Tensor, valid: torch.Tensor):
    """(N, C, nlin) int32 linearized coefficients, whose last ``n =
    valid.numel()`` elements are the detail axis, and its (n,) pad mask ->
    ((N*C*n + E) / SUBA, SUBA) int32 packed elements of kernels A and B
    (bits 0-29 ``|c|``, bit 30 the sign, -1 at pads and in the E-element
    tail).  On the card one launch (``launches`` grows by 1)."""
    if not _check_packed(lin, valid):
        return packed_elems_plain(lin, valid)
    N, C, nlin = lin.shape
    n = valid.numel()
    out = torch.empty(((N * C * n + compact.E) // compact.SUBA,
                       compact.SUBA), dtype=_I32, device=lin.device)
    lib = build.library()
    build.check(lib.dwt_packed_elems(
        lin.data_ptr(), *_strides(lin), N, C, nlin - n, n,
        valid.data_ptr(), compact.E, out.data_ptr(), build.stream_of(lin)),
        "packed_elems")
    packed_elems.launches += 1
    return out


packed_elems.launches = 0
