"""The port stands alone: no JAX, no ``dwt_tpu``, no PyTorch extension
builder, on the card or anywhere; its entry points use the card unless the
CPU is asked for; the kernel wrappers take their plain path only for CPU
tensors; and what the port does not support is refused, not
approximated.  Its benchmark, ``bench_torch``, and its measurement
scripts, ``tools/``, import neither JAX nor ``dwt_tpu`` either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "dwt_tpu_torch").rglob("*.py")) + sorted(
    (ROOT / "bench_torch").rglob("*.py")) + sorted(
    (ROOT / "tools").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dwt_tpu", "conftest", "torch.utils.cpp_extension")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_imports_without_jax():
    """Every module of the port and of its benchmark, and chip_smoke.py,
    imports in a process where importing JAX or the JAX package fails."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT_FILES)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'dwt_tpu'): sys.modules[m] = None\n"
        f"import importlib\nfor m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dwt_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\nprint('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_bench_modules_are_checked():
    """The benchmark's modules are among the files the import checks
    read."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {f"bench_torch/{m}.py" for m in (
        "__init__", "run", "cells", "kernels", "measure", "digests")} <= names


def test_encoder_needs_card_unless_cpu(monkeypatch):
    from dwt_tpu_torch.codec import encoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder.Encoder(64, 48, 3)
    assert encoder.Encoder(64, 48, 3, device="cpu").device.type == "cpu"


def test_sharded_modules_are_checked():
    """The multi-GPU modules are among the files the import checks read."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {f"dwt_tpu_torch/parallel/{m}.py"
            for m in ("hosts", "tiled", "encode")} <= names


def test_sharded_entry_points_need_card_unless_cpu(monkeypatch):
    """The sharded entry points take the card's mesh unless a mesh on the
    CPU is given; with no card they raise."""
    from dwt_tpu_torch.parallel import encode, hosts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((48, 64, 3), np.uint8)
    for make in (lambda: encode.ShardedEncoder(64, 48, 3),
                 lambda: encode.ShardedDecoder(64, 48, 3),
                 lambda: encode.encode_tiled_sharded(img, tile=(32, 32)),
                 hosts.global_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    mesh = hosts.global_mesh("cpu")
    assert encode.ShardedEncoder(64, 48, 3, mesh).mesh.device.type == "cpu"
    assert encode.encode_tiled_sharded(img, mesh, tile=(32, 32))[:2] == b"WT"


def test_later_slices_refuse():
    """The budget and container routes of the JAX package's ``encode`` are
    ported (no refusal is left on them); the single-stream encoder still
    refuses a detail segment of 2^30 elements or more, and a single stream
    past the envelope is refused when the container is forbidden."""
    from conftest import random_image
    from dwt_tpu_torch.codec import encoder

    img = random_image(np.random.default_rng(0), 32, 32, 3, "mixed")
    full = encoder.encode(img, device="cpu")
    assert encoder.encode(img, capacity=100, device="cpu") == full[:100]
    assert encoder.encode(img, container=True, device="cpu")[:2] == b"WT"
    with pytest.raises(ValueError, match="single-stream envelope"):
        encoder.encode(np.zeros((12000, 12000), np.uint8), container=False,
                       device="cpu")
    with pytest.raises(NotImplementedError, match="2\\^30 elements"):
        encoder.Encoder(65536, 65536, 1, device="cpu")


def test_plain_path_counts_no_launch():
    """On CPU tensors the wrappers run their plain versions, and a launch
    count moves only where a kernel is launched."""
    from conftest import random_image
    from dwt_tpu import specmodel
    from dwt_tpu_torch.codec import decoder, encoder
    from dwt_tpu_torch.ops import (codeword, compact, emit_tables,
                                   hilbert_gather, hilbert_scatter, lifting,
                                   pack, transpose)

    fns = (hilbert_gather.hilbert_gather, hilbert_gather.engine_supported,
           compact.compact_tokens, compact.scatter_refbits, pack.pack_words,
           hilbert_scatter.hilbert_scatter, transpose.transpose2d,
           codeword.codeword_pieces, lifting.inverse_transform,
           emit_tables.emit_tables)
    before = [f.launches for f in fns]
    img = random_image(np.random.default_rng(1), 40, 24, 3, "mixed")
    stream = encoder.encode(img, device="cpu")
    assert stream == specmodel.encode(img, False)
    assert np.array_equal(decoder.decode(stream, device="cpu")[0], img)
    assert [f.launches for f in fns] == before


def test_wrappers_check_their_arguments():
    from dwt_tpu_torch.ops import compact, hilbert_gather, hilbert_scatter, pack

    i32 = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        pack.pack_words(i32.long(), i32, i32, i32, 4)
    with pytest.raises(ValueError, match="shape"):
        pack.pack_words(i32, i32[:4], i32, i32, 4)
    with pytest.raises(ValueError, match="contiguous"):
        hilbert_gather.hilbert_gather(
            torch.zeros((4, 4, 3), dtype=torch.int32).transpose(0, 1), i32)
    with pytest.raises(ValueError, match="2-D"):
        hilbert_scatter.hilbert_scatter(i32.reshape(2, 4), i32)
    with pytest.raises(ValueError, match="contiguous"):
        hilbert_scatter.hilbert_scatter(i32.reshape(4, 2).T, i32.reshape(2, 4))
    meta = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        compact.compact_tokens(
            torch.zeros((4, compact.SUBA), dtype=torch.int32, device="meta"),
            meta, 16)


def test_pack_words_rejects_unsorted_widx():
    """The CUDA kernel needs nondecreasing word indices; the wrapper
    refuses others on every device, so kernel and plain never disagree."""
    from dwt_tpu_torch.ops import pack

    c = torch.ones(4, dtype=torch.int32)
    widx = torch.tensor([0, 2, 1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="nondecreasing"):
        pack.pack_words(widx, c, c, c, 8)
    got = pack.pack_words(widx.sort().values, c, c, c, 8)
    assert got.tolist() == [1, 2, 3, 3, 2, 1, 0, 0]


def test_engine_probe_on_cpu():
    """The tile engines' probe: on the CPU there is no kernel to probe, and
    the probe tile through the plain gather and scatter gives back
    ``arange`` with no value counted wrong, also on a second call on the
    buffers made once; a corrupted index is counted."""
    from dwt_tpu_torch.ops import hilbert_gather as hg

    before = hg.engine_supported.launches
    assert hg.engine_supported("cpu") is True
    co, src = hg.probe_tile("cpu")
    assert co.shape == (hg.TS, hg.TS, 1)
    bufs = hg.probe_buffers("cpu")
    assert hg.probe_buffers("cpu") is bufs
    tile, idx, out, bad = bufs
    ar = torch.arange(hg.TS * hg.TS, dtype=torch.int32)
    for _ in range(2):
        hg.engine_probe(*bufs)
        assert torch.equal(out, torch.cat([ar, ar]))
        assert bad.tolist() == [0, 0]
    idx = idx.clone()
    idx[5] = 7
    hg.engine_probe(tile, idx, out, bad)
    assert bad.tolist() == [1, 1]
    assert hg.engine_supported.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Without nvcc the build fails loudly (nothing falls back)."""
    import shutil

    from dwt_tpu_torch.runtime import build

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert build.library_path().parent.parent == tmp_path
    assert [p.name for p in build.sources()] == [
        "codeword.cu", "compact.cu", "emit_tables.cu", "finish.cu",
        "halo_lifting.cu", "hilbert_gather.cu", "hilbert_scatter.cu",
        "lifting.cu",
        "lifting_inv.cu", "pack.cu", "plane_stats.cu", "probe.cu",
        "runtime.cu", "schedule.cu", "transpose.cu", "units.cu",
        "vli_scan.cu"]
