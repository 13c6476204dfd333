"""Stage 1's level sums, step order and carry chain (kernel 14,
``csrc/schedule.cu``).

No TPU kernel to port: the JAX package computes all of it as XLA inside
``dwt_tpu/codec/encoder.py:_stats_from_lin`` (:355): the level
reductions of ``_plane_stats`` (:273-289), the stable argsort of the
schedule keys (:391), the zero-run carry chain as a ``lax.scan``
(:404-414) and the token bases.  :func:`schedule` takes the chunk tables
of the plane statistics (``ops/plane_stats.py``) of N frames of C
channels and writes every stats leaf of stage 1 (``OUT_KEYS``).

Per (frame, channel, level, plane) step (S = C * L * PMAX a frame, in
(c, l, p) order): ``nS``, ``nZ`` (the level's sums of ``nS_ck`` and of
``nZ_ck = z0_ck + exclusive cumsum over p of nS_ck``) and ``trailZ`` (the
zeros after the level's last newly significant element: ``nZ`` less the
level-exclusive cumsum of ``nZ_ck`` plus ``zup_ck`` at the chunks that
hold the level's largest ``lastS_ck``, when it is >= 0); ``nRef``; the
schedule key, ``order`` (its stable argsort: valid steps by key, then the
invalid ones, which all tie at 2^30, by index); the carry chain over the
steps in that order, where a valid step maps the carry to 0 (nRef > 0),
``trailZ`` (nS > 0) or carry + nZ, an invalid one leaves it, and the
chain starts at ``real[0]`` when ``planes_max`` is 0 (the degenerate
pre-step, encode.c:190-194); the root band's token counts; the
pair-aligned step bases, T, the injection sites and refinement-bit
prefixes, each put back at its (c, l, p) slot.  Three extra leaves serve
kernel A's unit tables (``ops/units.py``): ``scar_ck`` and ``zcar_ck``,
the level-exclusive cumsums over the chunks of ``nS_ck`` and ``nZ_ck``,
and ``ubase_sched``, each step's first unit: the exclusive sum in
schedule order of the steps' level chunk counts (the ``ubase`` of
``dwt_tpu/codec/encoder.py:_unit_common``, :535-536; it depends on
``order`` alone, so the schedule cuts leave it as it is).  ``head`` is
(2, N): ``planes_max`` and ``T`` (views of its rows), which the encoder
copies to the host in one copy.  ``planes`` and ``nS_ck`` are the inputs
themselves.

On the card one launch (``launches`` grows by 1) of a cluster of blocks a
frame, its outputs carved from one allocation (:func:`_layout`).  On the
CPU: :func:`schedule_plain`, the eager passes and a vectorised chain.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from ..runtime import build
from ._launch import arena_layout, carve, cuda_or_cpu, need
from .plane_stats import PMAX, _excl_cumsum, _ilog2

_I32 = torch.int32
# Steps a frame the schedule kernel takes: its block of 1,024 threads
# walks at most 2 a thread, and its shared memory holds 5 int32 tables of
# S.
MAX_STEPS = 2048
# Channels a frame: one lane of a warp each.
MAX_CHANNELS = 32
# Levels: the schedule key's level field has 6 bits.
MAX_LEVELS = 64

OUT_KEYS = (
    "head", "planes", "planes_max", "nS", "nRef", "root_cnt", "root_base",
    "planes_base", "step_base", "step_end", "inj_pos", "refpfx", "carry_in",
    "refrun_val", "refrun_ok", "valid", "carry_end", "T", "order", "nS_ck",
    "nZ_ck", "base_sched", "nS_sched", "cin_sched", "valid_sched",
    "scar_ck", "zcar_ck", "ubase_sched")

# The tensors the kernel writes, in the order of csrc/schedule.cu's ``enum
# Out``: int32, then the three bool grids.
_INT_OUTS = ("head", "root_cnt", "root_base", "planes_base", "carry_end",
             "nS", "nRef", "step_base", "step_end", "inj_pos", "refpfx",
             "carry_in", "refrun_val", "order", "base_sched", "nS_sched",
             "cin_sched", "ubase_sched", "nZ_ck", "scar_ck", "zcar_ck")
_BOOL_OUTS = ("refrun_ok", "valid", "valid_sched")
_OUTS = _INT_OUTS + _BOOL_OUTS
# After the kernel's outputs: head's rows, and the inputs passed through.
_ALIASES = ("planes_max", "T")
_PASSED = ("planes", "nS_ck")
# OUT_KEYS from [outputs, aliases, passed].
_PICK = operator.itemgetter(*((_OUTS + _ALIASES + _PASSED).index(k)
                              for k in OUT_KEYS))
# The inputs: names, dimensions.
_IN_NAMES = ("planes", "nS_ck", "lastS_ck", "z0_ck", "zup_ck", "root",
             "real", "level_chunk_base", "level_nchunk")
_IN_DIMS = (2, 4, 4, 3, 4, 3, 1, 1, 1)


def _shapes(N: int, C: int, L: int, nchunk: int) -> dict:
    """The shape of each tensor the kernel writes."""
    grid, ck = (N, C, L, PMAX), (N, C, nchunk, PMAX)
    out = {"head": (2, N), "root_cnt": (N, C), "root_base": (N, C),
           "planes_base": (N,), "carry_end": (N,)}
    out.update({k: grid for k in ("nS", "nRef", "step_base", "step_end",
                                  "inj_pos", "refpfx", "carry_in",
                                  "refrun_val", "refrun_ok", "valid")})
    out.update({k: (N, C * L * PMAX) for k in (
        "order", "base_sched", "nS_sched", "cin_sched", "ubase_sched",
        "valid_sched")})
    out.update({k: ck for k in ("nZ_ck", "scar_ck", "zcar_ck")})
    return out


@functools.lru_cache(maxsize=64)
def _layout(N: int, C: int, L: int, nchunk: int) -> tuple:
    """The kernel's one allocation at a shape: (its bytes, the views of
    its outputs in ``_OUTS`` order and of head's two rows, as
    ``_launch.carve`` takes them, the offsets struct the C entry point
    takes)."""
    shapes = _shapes(N, C, L, nchunk)
    nbytes, views, offsets = arena_layout(
        [(torch.bool if k in _BOOL_OUTS else _I32, shapes[k])
         for k in _OUTS])
    head = views[_OUTS.index("head")][3]
    rows = tuple((_I32, (N,), (1,), head + r * N) for r in range(2))
    return (nbytes, views + rows,
            build.offsets(len(offsets))((ctypes.c_int64 * len(offsets))(
                *offsets)))


def level_sums_plain(nS_ck, lastS_ck, z0_ck, zup_ck, bases, counts) -> tuple:
    """(R, nchunk, PMAX) chunk tables (``z0_ck`` (R, nchunk)) and each
    level's first chunk and chunk count -> (nS, nZ, trailZ) (R, L, PMAX)
    and (nZ_ck, scar_ck, zcar_ck) (R, nchunk, PMAX), int32.

    trailZ decomposes because level-local indices are monotone across a
    level's chunks: the level's lastS lies in one chunk k*, so z_upto =
    sum_{k<k*} nZ_ck[k] + (chunk-local zeros at idx <= lastS)."""
    spans = list(zip(bases, counts))
    nZ_ck = z0_ck[..., None] + _excl_cumsum(nS_ck, dim=2)

    def lvl(x, red):
        return torch.stack([red(x[:, b:b + c]) for b, c in spans], dim=1)

    def level_excl(x):
        return torch.cat([_excl_cumsum(x[:, b:b + c], dim=1)
                          for b, c in spans], dim=1)

    def total(s):
        return s.sum(dim=1, dtype=_I32)

    nS, nZ = lvl(nS_ck, total), lvl(nZ_ck, total)
    lastS = lvl(lastS_ck, lambda s: s.amax(dim=1))  # (R, L, PMAX)
    level_of = torch.repeat_interleave(
        torch.arange(len(spans), device=nS_ck.device),
        torch.as_tensor(counts, device=nS_ck.device))
    scar, zcar = level_excl(nS_ck), level_excl(nZ_ck)
    is_k = (lastS_ck == lastS[:, level_of]) & (lastS_ck >= 0)
    z_upto = lvl(torch.where(is_k, zcar + zup_ck, 0), total)
    return nS, nZ, nZ - z_upto, nZ_ck, scar, zcar


def chain_plain(carry0, valid_s, nS_s, nZ_s, trailZ_s, nRef_s) -> tuple:
    """The zero-run carry chain (rle.h cnt threading) over (N, S) step
    tables in schedule order from the (N,) ``carry0``, without a loop: a
    valid step maps the carry to 0 (nRef > 0), to trailZ (nS > 0) or to
    carry + nZ, an invalid one leaves it, so the carry after step s is the
    sum of the additions since the last step that set it (or since
    ``carry0``).  Returns (carry_in, refrun_val) int32, refrun_ok bool
    (N, S) and the (N,) int32 carry at the end."""
    N, S = valid_s.shape
    c0 = carry0.long()[:, None]
    if S == 0:
        z = torch.zeros((N, 0), dtype=_I32, device=valid_s.device)
        return z, z.clone(), valid_s.clone(), carry0.to(_I32)
    passes = ~valid_s | ((nRef_s <= 0) & (nS_s <= 0))
    add = torch.where(valid_s & (nRef_s <= 0),
                      torch.where(nS_s > 0, trailZ_s, nZ_s), 0).long()
    incl = torch.cumsum(add, dim=1)
    ix = torch.arange(S, device=valid_s.device).expand(N, S)
    last = torch.cummax(torch.where(passes, -1, ix), dim=1).values
    after = torch.where(last >= 0,
                        incl - (incl - add).gather(1, last.clamp(min=0)),
                        c0 + incl)
    carry_in = torch.cat([c0, after[:, :-1]], dim=1)
    rv = torch.where(nS_s > 0, trailZ_s.long(), carry_in + nZ_s)
    rro = valid_s & (nRef_s > 0) & (rv > 0)
    return (carry_in.to(_I32), rv.to(_I32), rro, after[:, -1].to(_I32))


def _check(planes, nS_ck, lastS_ck, z0_ck, zup_ck, root, real,
           level_chunk_base, level_nchunk) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on anything the kernel does not take.  One pass over
    the tensors: the wrapper's host time is most of the call's."""
    ts = (planes, nS_ck, lastS_ck, z0_ck, zup_ck, root, real,
          level_chunk_base, level_nchunk)
    if (any(t.dtype != _I32 for t in ts)
            or tuple(t.dim() for t in ts) != _IN_DIMS):
        for name, t, nd in zip(_IN_NAMES, ts, _IN_DIMS):
            need(f"schedule {name}", t, _I32, nd)
    N, C = planes.shape
    nchunk, L = nS_ck.shape[2], real.numel()
    ck = (N, C, nchunk, PMAX)
    if (nS_ck.shape != ck or lastS_ck.shape != ck or zup_ck.shape != ck
            or z0_ck.shape != ck[:3] or root.shape[:2] != (N, C)
            or level_chunk_base.numel() != L or level_nchunk.numel() != L):
        raise ValueError(
            f"schedule: inconsistent shapes: planes {tuple(planes.shape)}, "
            f"chunk tables {tuple(nS_ck.shape)}, zeros "
            f"{tuple(z0_ck.shape)}, root {tuple(root.shape)}, {L} levels")
    if (not 1 <= C <= MAX_CHANNELS or not 1 <= L <= MAX_LEVELS
            or root.shape[2] < 1):
        raise ValueError(f"schedule: {C} channels (1 to {MAX_CHANNELS}), "
                         f"{L} levels (1 to {MAX_LEVELS}) and a root band "
                         f"of {root.shape[2]} do not fit")
    if not cuda_or_cpu("schedule", ts):
        return False
    if not all(t.is_contiguous() for t in ts if t is not root):
        raise ValueError("schedule: every table must be contiguous")
    if root.stride(2) != 1 and root.shape[2] > 1:
        raise ValueError("schedule: the root band's rows must be of unit "
                         "stride")
    if C * L * PMAX > MAX_STEPS:
        raise ValueError(f"schedule: {C * L * PMAX} steps a frame, past the "
                         f"kernel's {MAX_STEPS}")
    return True


def schedule_plain(planes, nS_ck, lastS_ck, z0_ck, zup_ck, root, real,
                   level_chunk_base, level_nchunk) -> tuple:
    """Plain PyTorch version of :func:`schedule` (it reads the level
    tables on the host)."""
    _check(planes, nS_ck, lastS_ck, z0_ck, zup_ck, root, real,
           level_chunk_base, level_nchunk)
    N, C = planes.shape
    nchunk, L, pix0 = nS_ck.shape[2], real.numel(), root.shape[2]
    S = C * L * PMAX
    dev = planes.device

    def rows(t):
        return t.reshape(N * C, *t.shape[2:])

    sums = level_sums_plain(*map(rows, (nS_ck, lastS_ck, z0_ck, zup_ck)),
                            level_chunk_base.tolist(), level_nchunk.tolist())
    nS, nZ, trailZ = (x.reshape(N, C, L, PMAX) for x in sums[:3])
    nZ_ck, scar, zcar = (x.reshape(N, C, nchunk, PMAX) for x in sums[3:])
    planes_max = planes.amax(dim=1)  # (N,)
    pm = planes_max[:, None, None, None]
    p_ix = torch.arange(PMAX, dtype=_I32, device=dev)[None, None, None, :]
    nRef = torch.where(p_ix < pm, real[None, None, :, None] - nZ - nS, 0)

    # --- schedule order over each frame's (C, L, PMAX) step grid ----------
    c_ix = torch.arange(C, dtype=_I32, device=dev)[None, :, None, None]
    l_ix = torch.arange(L, dtype=_I32, device=dev)[None, None, :, None]
    sec = (c_ix > 0).to(_I32)
    layers = torch.where(sec == 0, pm - 2 - p_ix + l_ix,
                         pm - 1 - p_ix + l_ix)
    valid = (p_ix < planes[:, :, None, None]).expand(N, C, L, PMAX)
    key = ((layers + 1) << 16) | (sec << 12) | (l_ix << 6) | c_ix
    key = torch.where(valid, key, 2**30).reshape(N, S)
    order = torch.argsort(key, dim=1, stable=True)  # schedule order of steps

    def sched(x):
        return x.reshape(N, S).gather(1, order)

    nS_s, nZ_s, trailZ_s, nRef_s = map(sched, (nS, nZ, trailZ, nRef))
    # Each step's first unit: the chunk counts of the steps before it.
    ubase_s = _excl_cumsum(level_nchunk[(order // PMAX) % L]).to(_I32)
    valid_s = sched(valid)
    carry0 = torch.where(planes_max == 0, real[0], 0).to(_I32)
    carry_in_s, refrun_val_s, refrun_ok_s, carry_end = chain_plain(
        carry0, valid_s, nS_s, nZ_s, trailZ_s, nRef_s)

    # --- token counts / bases ---------------------------------------------
    root_max = root.abs().amax(dim=2)
    root_cnt = torch.where(root_max > 0,
                           1 + _ilog2(root_max.clamp(min=1)), 0).to(_I32)
    nnz_root = (root != 0).sum(dim=2, dtype=_I32)
    root_tokens = (1 + torch.where(root_cnt > 0, pix0 + nnz_root, 0)).to(_I32)
    root_base = _excl_cumsum(root_tokens)
    planes_base = root_tokens.sum(dim=1, dtype=_I32)  # (N,)
    steps_base0 = planes_base + C

    # Refinement bits are not tokens: they are raw bits at closed-form
    # positions, packed straight into the stream words.  Each step's base
    # is padded to an even slot (the extra slot is a 0-bit raw token), as
    # kernel A and the token finisher work in pair space.  (The JAX
    # package pads to its TPU pack kernel's blocks instead; the CUDA pack
    # kernel has no blocks, and this is the JAX package's layout on the
    # CPU, so every intermediate still compares one to one.)
    cnt_s = torch.where(valid_s, 2 * nS_s + refrun_ok_s.to(_I32), 0)
    cnt_al = (cnt_s + 1) // 2 * 2
    steps_base0_al = (steps_base0 + 1) // 2 * 2
    base_s = (steps_base0_al[:, None] + _excl_cumsum(cnt_al)).to(_I32)
    T = (steps_base0_al + cnt_al.sum(dim=1, dtype=_I32) + 1).to(_I32)  # flush
    # Refinement-bit injection site of a step: the next step's base.
    inj_pos_s = torch.cat([base_s[:, 1:], (T - 1)[:, None]], dim=1).to(_I32)
    refpfx_s = _excl_cumsum(torch.where(valid_s, nRef_s, 0)).to(_I32)

    def unsort(x):
        out = torch.zeros((N, S), dtype=x.dtype, device=dev)
        return out.scatter_(1, order, x).reshape(N, C, L, PMAX)

    head = torch.stack([planes_max, T])
    out = dict(
        head=head, planes=planes, planes_max=head[0], nS=nS, nRef=nRef,
        root_cnt=root_cnt, root_base=root_base, planes_base=planes_base,
        step_base=unsort(base_s), step_end=unsort((base_s + cnt_s).to(_I32)),
        inj_pos=unsort(inj_pos_s), refpfx=unsort(refpfx_s),
        carry_in=unsort(carry_in_s), refrun_val=unsort(refrun_val_s),
        refrun_ok=unsort(refrun_ok_s), valid=valid.contiguous(),
        carry_end=carry_end, T=head[1], order=order.to(_I32), nS_ck=nS_ck,
        nZ_ck=nZ_ck, base_sched=base_s,
        nS_sched=torch.where(valid_s, nS_s, 0), cin_sched=carry_in_s,
        valid_sched=valid_s, scar_ck=scar, zcar_ck=zcar,
        ubase_sched=ubase_s)
    return tuple(out[k] for k in OUT_KEYS)


def schedule(planes, nS_ck, lastS_ck, z0_ck, zup_ck, root, real,
             level_chunk_base, level_nchunk) -> tuple:
    """Chunk tables of N frames of C channels (``planes`` (N, C) and the
    (N, C, nchunk, PMAX) tables of ``ops/plane_stats.py``, ``z0_ck`` (N, C,
    nchunk)), their (N, C, pix0) root band (rows of unit stride at any
    frame and channel stride), each level's real element count, first
    chunk and chunk count (L,) -> the stats leaves of ``OUT_KEYS``, int32
    but for the bool ``refrun_ok``, ``valid`` and ``valid_sched``.  On the
    card one launch (``launches`` grows by 1); its outputs are views of
    one new allocation a call, 256-byte aligned."""
    if not _check(planes, nS_ck, lastS_ck, z0_ck, zup_ck, root, real,
                  level_chunk_base, level_nchunk):
        return schedule_plain(planes, nS_ck, lastS_ck, z0_ck, zup_ck, root,
                              real, level_chunk_base, level_nchunk)
    N, C = planes.shape
    nchunk, L = nS_ck.shape[2], real.numel()
    nbytes, views, offsets = _layout(N, C, L, nchunk)
    outs = carve(nbytes, views, planes.device)
    if N:
        build.check(build.library().dwt_schedule(
            planes.data_ptr(), nS_ck.data_ptr(), lastS_ck.data_ptr(),
            z0_ck.data_ptr(), zup_ck.data_ptr(), root.data_ptr(),
            root.stride(0), root.stride(1), root.shape[2], real.data_ptr(),
            level_chunk_base.data_ptr(), level_nchunk.data_ptr(), N, C, L,
            nchunk, outs[0].data_ptr(), offsets, build.stream_of(planes)),
            "schedule")
        schedule.launches += 1
    outs += (planes, nS_ck)
    return _PICK(outs)


schedule.launches = 0
