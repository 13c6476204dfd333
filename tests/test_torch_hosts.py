"""The port's multi-process setup (``dwt_tpu_torch/parallel/hosts.py``), as
tests/test_hosts.py runs the JAX package's: two real processes join one
gloo process group through ``hosts.initialize``, ``hosts.global_mesh`` is
the mesh of both, and an all-reduce over it sees both processes' data.
Also: one process is a no-op, and the card's NCCL is never swapped for
gloo."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from torch_ranks import reserve_port

ROOT = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, %(root)r)
    import numpy as np
    import torch
    import torch.distributed as dist
    from dwt_tpu_torch.parallel import hosts

    pid, port = int(sys.argv[1]), sys.argv[2]
    hosts.initialize("localhost:" + port, 2, pid, device="cpu")
    mesh = hosts.global_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.device.type) == (2, pid, "cpu"), mesh
    # Each process sums its own rows; the all-reduce must see both.
    local = torch.as_tensor(np.full((2, 4), pid * 10 + 1, np.int32)).sum()
    dist.all_reduce(local, group=mesh.group)
    total = int(local)
    # Process 0's rows sum to 1 * 8, process 1's to 11 * 8.
    assert total == 8 + 88, total
    # A gloo group does not run the sharded paths on the card.
    try:
        hosts.global_mesh("cuda")
    except RuntimeError as e:
        assert "gloo" in str(e), e
    else:
        raise AssertionError("global_mesh put a gloo group on the card")
    dist.destroy_process_group()
    print("HOSTS_OK", pid, total, flush=True)
""")


def test_two_process_initialize_and_collective(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER % {"root": str(ROOT)})
    # The coordinator's port stays reserved while the workers run: let go
    # before rank 0 binds it, another test's ranks could take it.
    with reserve_port() as held:
        port = str(held.getsockname()[1])
        procs = [subprocess.Popen([sys.executable, str(script), str(pid),
                                   port], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for pid in (0, 1)]
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{out}\n{err}"
        assert "HOSTS_OK" in out, out


def test_initialize_single_process_noop():
    import torch.distributed as dist

    from dwt_tpu_torch.parallel import hosts

    hosts.initialize(num_processes=1)
    hosts.initialize("localhost:1", 1, 0)
    assert not dist.is_initialized()
    mesh = hosts.global_mesh("cpu")
    assert (mesh.group, mesh.size, mesh.rank) == (None, 1, 0)
    assert mesh.device == torch.device("cpu")


def test_mesh_needs_card_unless_cpu(monkeypatch):
    from dwt_tpu_torch.parallel import hosts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hosts.global_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hosts.initialize("localhost:1", 2, 0)
    with pytest.raises(ValueError, match="coordinator"):
        hosts.initialize(None, 2, 0, device="cpu")
