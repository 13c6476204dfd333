"""Multi-process setup and the collectives of the sharded paths.

Port of ``dwt_tpu/parallel/hosts.py`` onto ``torch.distributed``.  The JAX
package runs one process a host and a global ``Mesh`` over every device of
every process; here each rank is one process with one device, and the
process group is the mesh (:class:`Mesh`).  Ranks on the card talk through
NCCL; gloo runs only where the caller asks for the CPU (the tests).
Nothing falls back from NCCL to gloo.

The collectives the sharded paths make (the halo rows of
``parallel/tiled.py``, the all-gathers and all-reduces of
``parallel/encode.py``) go through :func:`shift`, :func:`all_gather` and
:func:`all_reduce_max`, which log each message this rank sends and each
gathered or reduced tensor in :data:`comm_log`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..codec.encoder import _device

# (op, bytes) of every collective this process made: ("send", bytes of one
# point-to-point message), ("all_gather", bytes of the gathered tensor),
# ("all_reduce", bytes of the reduced tensor).  Cleared by its readers.
comm_log: list[tuple[str, int]] = []

# torch 2.13 deprecates all_gather_into_tensor for all_gather_single, which
# older releases lack; both gather rank blocks along dim 0.
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclass(frozen=True)
class Mesh:
    """The ranks of one sharded program: the process group (None in a
    process with no group: one rank, no collectives), its size, this
    process's rank and this rank's device."""

    group: object
    size: int
    rank: int
    device: torch.device


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None) -> None:
    """Join this process to a group of ``num_processes`` ranks whose rank 0
    listens at ``coordinator`` ("host:port"): NCCL on the card, gloo only
    when ``device="cpu"``.  A no-op for one process (or none given)."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("initialize: give the coordinator's host:port and "
                         "this process's id")
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def global_mesh(device=None) -> Mesh:
    """The mesh of every rank of the process group (a mesh of one rank when
    there is none).  This rank's device is ``cuda:{rank % device_count}``
    unless ``device`` names one; without a card this raises unless
    ``device="cpu"``.  A gloo group does not run on the card, nor an NCCL
    group on the CPU."""
    dev = _device(device)
    group, size, rank = None, 1, 0
    if dist.is_initialized():
        group, size, rank = dist.group.WORLD, dist.get_world_size(), \
            dist.get_rank()
        backend = dist.get_backend()
        if backend != ("gloo" if dev.type == "cpu" else "nccl"):
            raise RuntimeError(f"global_mesh: a {backend} process group "
                               f"cannot run the sharded paths on {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(group, size, rank, dev)


def shift(mesh: Mesh, t: torch.Tensor, step: int,
          out: torch.Tensor) -> torch.Tensor:
    """JAX's ``ppermute`` with pairs ``[(i + step, i)]``: this rank sends
    ``t`` to rank ``rank - step`` and receives the ``t`` of rank ``rank +
    step`` into ``out`` (left as it was where there is no such rank, where
    ``ppermute`` gives zeros: the halo levels never read it there).  One
    ``batch_isend_irecv``; returns ``out``."""
    t = t.contiguous()
    ops = []
    dst, src = mesh.rank - step, mesh.rank + step
    if 0 <= dst < mesh.size:
        ops.append(dist.P2POp(dist.isend, t, dst, group=mesh.group))
        comm_log.append(("send", t.numel() * t.element_size()))
    if 0 <= src < mesh.size:
        ops.append(dist.P2POp(dist.irecv, out, src, group=mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked along dim 0 in rank order (JAX's
    ``all_gather(tiled=True)``); ``t`` itself where there is no group."""
    if mesh.group is None:
        return t
    t = t.contiguous()
    out = t.new_empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]))
    _all_gather_single(out, t, group=mesh.group)
    comm_log.append(("all_gather", out.numel() * out.element_size()))
    return out


def all_reduce_max(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks (in place)."""
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
        comm_log.append(("all_reduce", t.numel() * t.element_size()))
    return t
