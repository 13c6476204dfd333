"""A pool of gloo ranks for the CPU tests of the port's sharded paths.

``Ranks(n)`` spawns n processes, each joined to one gloo process group by
``hosts.initialize(..., device="cpu")``; ``run(task, **kwargs)`` has every
rank call the task of that name below on its mesh and returns the n
results in rank order.  Spawning costs seconds, so a test module starts a
pool once for each world size.  Nothing here imports JAX: the tests hold
the results against the JAX package in their own process.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import sys
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reserve_port() -> socket.socket:
    """A socket that holds a free TCP port of this host (``getsockname()``)
    until it is closed: bound with SO_REUSEADDR and not listening, so that
    a process group's store, which binds its port the same way, can listen
    on it, while no other socket of the host takes the port meanwhile.  A
    port found free and let go at once can be taken by the sockets of
    another test's ranks before the store binds it."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("localhost", 0))
    return s


def halo_image(w: int, h: int, seed: int) -> np.ndarray:
    """(h, w, 3) int32 in [-255, 255], as tests/test_parallel.py makes."""
    return np.random.default_rng(seed).integers(-255, 256, (h, w, 3)).astype(
        np.int32)


# --- tasks: each runs on every rank with the rank's mesh -------------------

def halo_fwd(mesh, w: int, h: int, seed: int) -> tuple:
    """This rank's fine block and the coarse result of ``halo_dwt2d_fwd`` on
    :func:`halo_image`, and the collectives it made."""
    import torch

    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.parallel import hosts, tiled

    pyr = compute_pyramid(w, h)
    xb = tiled.rank_rows(torch.as_tensor(halo_image(w, h, seed)), mesh, pyr)
    hosts.comm_log.clear()
    fine, coarse = tiled.halo_dwt2d_fwd(xb, mesh, pyr)
    return fine.numpy(), coarse.numpy(), list(hosts.comm_log)


def halo_inv(mesh, fine: np.ndarray, w: int, h: int) -> tuple:
    """This rank's block of ``halo_dwt2d_inv`` of the whole fine buffer, and
    the collectives it made."""
    import torch

    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.parallel import hosts, tiled

    pyr = compute_pyramid(w, h)
    rb = fine.shape[0] // mesh.size
    fb = torch.as_tensor(fine[mesh.rank * rb:(mesh.rank + 1) * rb])
    hosts.comm_log.clear()
    out = tiled.halo_dwt2d_inv(fb, mesh, pyr)
    return out.numpy(), list(hosts.comm_log)


def halo_rgb(mesh, img: np.ndarray, fine: np.ndarray) -> tuple:
    """The fused colour routes on a uint8 RGB image: this rank's fine
    block and the coarse result of ``halo_dwt2d_fwd(rank_rows(img),
    colour=True)`` with the collectives it made, and the gathered uint8
    pixels (H rows) of ``halo_dwt2d_inv(to_bytes=True)`` of the whole
    ``fine`` buffer."""
    import torch

    from dwt_tpu_torch.geometry import compute_pyramid
    from dwt_tpu_torch.parallel import hosts, tiled

    h, w = img.shape[:2]
    pyr = compute_pyramid(w, h)
    hosts.comm_log.clear()
    fb, coarse = tiled.halo_dwt2d_fwd(tiled.rank_rows(img, mesh, pyr), mesh,
                                      pyr, colour=True)
    log = list(hosts.comm_log)
    rb = fine.shape[0] // mesh.size
    px = tiled.halo_dwt2d_inv(
        torch.as_tensor(fine[mesh.rank * rb:(mesh.rank + 1) * rb]), mesh,
        pyr, to_bytes=True)
    px = hosts.all_gather(mesh, px)[:h]
    return fb.numpy(), coarse.numpy(), px.numpy(), log


def encode(mesh, img: np.ndarray) -> bytes:
    from dwt_tpu_torch.parallel.encode import ShardedEncoder

    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    return ShardedEncoder(w, h, c, mesh).encode(img)


def decode(mesh, stream: bytes, w: int, h: int, c: int) -> np.ndarray:
    from dwt_tpu_torch.parallel.encode import ShardedDecoder

    return ShardedDecoder(w, h, c, mesh).decode(stream)


def encode_tiled(mesh, img: np.ndarray, tile: tuple, budget: int) -> bytes:
    from dwt_tpu_torch.parallel.encode import encode_tiled_sharded

    return encode_tiled_sharded(img, mesh, tile=tile, budget=budget)


TASKS = {f.__name__: f for f in (halo_fwd, halo_inv, halo_rgb, encode,
                                 decode, encode_tiled)}


def _serve(rank: int, n: int, port: int, tasks, results) -> None:
    """One rank: join the group, then run tasks until a None arrives."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from dwt_tpu_torch.parallel import hosts

    torch.set_num_threads(1)
    hosts.initialize(f"localhost:{port}", n, rank, device="cpu")
    mesh = hosts.global_mesh("cpu")
    try:
        while (item := tasks.get()) is not None:
            name, kwargs = item
            try:
                results.put((rank, True, TASKS[name](mesh, **kwargs)))
            except Exception:  # sent back: the test raises it
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Ranks:
    """n gloo ranks in spawned processes (see the module docstring)."""

    def __init__(self, n: int, timeout: float = 180.0):
        ctx = mp.get_context("spawn")
        self.n, self.timeout = n, timeout
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.port = reserve_port()  # held until close()
        port = self.port.getsockname()[1]
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, n, port, self.tasks[r],
                                        self.results))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, task: str, **kwargs) -> list:
        """Every rank's result of ``task(mesh, **kwargs)``, in rank order;
        raises with the ranks' tracebacks if any rank failed."""
        for q in self.tasks:
            q.put((task, kwargs))
        got, errors = {}, []
        for _ in range(self.n):
            try:
                rank, ok, value = self.results.get(timeout=self.timeout)
            except queue.Empty:
                raise TimeoutError(f"{task}: {self.n - len(got)} of "
                                   f"{self.n} ranks gave no result in "
                                   f"{self.timeout} s") from None
            got[rank] = value
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"{task} failed\n" + "\n".join(errors))
        return [got[r] for r in range(self.n)]

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self.port.close()
