"""The port stands alone: no JAX, no ``dwt_tpu``, no PyTorch extension
builder, on the card or anywhere; its entry points use the card unless the
CPU is asked for; the kernel wrappers take their plain path only for CPU
tensors; and the routes of later slices refuse rather than approximate."""

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
PORT_FILES = sorted((ROOT / "dwt_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
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
    """Every module of the port, and chip_smoke.py, imports in a process
    where importing JAX or the JAX package fails."""
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


def test_encoder_needs_card_unless_cpu(monkeypatch):
    from dwt_tpu_torch.codec import encoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder.Encoder(64, 48, 3)
    assert encoder.Encoder(64, 48, 3, device="cpu").device.type == "cpu"


def test_later_slices_refuse():
    from conftest import random_image
    from dwt_tpu_torch.codec import encoder

    img = random_image(np.random.default_rng(0), 32, 32, 3, "mixed")
    with pytest.raises(NotImplementedError, match="later slice"):
        encoder.encode(img, capacity=100, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        encoder.encode(img, container=True, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        encoder.encode(np.zeros((12000, 12000), np.uint8), device="cpu")


def test_plain_path_counts_no_launch():
    """On CPU tensors the wrappers run their plain versions, and a launch
    count moves only where a kernel is launched."""
    from conftest import random_image
    from dwt_tpu import specmodel
    from dwt_tpu_torch.codec import encoder
    from dwt_tpu_torch.ops import compact, hilbert_gather, pack

    fns = (hilbert_gather.hilbert_gather, hilbert_gather.engine_supported,
           compact.compact_tokens, compact.scatter_refbits, pack.pack_words)
    before = [f.launches for f in fns]
    img = random_image(np.random.default_rng(1), 40, 24, 3, "mixed")
    assert encoder.encode(img, device="cpu") == specmodel.encode(img, False)
    assert [f.launches for f in fns] == before


def test_wrappers_check_their_arguments():
    from dwt_tpu_torch.ops import compact, hilbert_gather, pack

    i32 = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        pack.pack_words(i32.long(), i32, i32, i32, 4)
    with pytest.raises(ValueError, match="shape"):
        pack.pack_words(i32, i32[:4], i32, i32, 4)
    with pytest.raises(ValueError, match="contiguous"):
        hilbert_gather.hilbert_gather(
            torch.zeros((4, 4, 3), dtype=torch.int32).transpose(0, 1), i32)
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
    """The gather's probe: on the CPU there is no kernel to probe, and the
    probe tile through the plain version gives back ``arange``."""
    from dwt_tpu_torch.ops import hilbert_gather as hg

    before = hg.engine_supported.launches
    assert hg.engine_supported("cpu") is True
    co, src = hg.probe_tile("cpu")
    assert co.shape == (hg.TS, hg.TS, 1)
    assert torch.equal(hg.engine_probe(co, src).reshape(-1),
                       torch.arange(hg.TS * hg.TS, dtype=torch.int32))
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
        "compact.cu", "hilbert_gather.cu", "pack.cu", "runtime.cu"]
