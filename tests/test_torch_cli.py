"""The port's command line (``python -m dwt_tpu_torch.cli``) against the
JAX package's (``dwt_tpu.cli``) on the same inputs: the same files,
stdout bytes, exit codes and stderr lines (but for the MP/s figure).
Both run in this process on the CPU (the port with ``device="cpu"``).
The JAX side runs once per module: its compiles dominate."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from conftest import random_image

torch.set_num_threads(1)

W, H = 48, 32  # 16x16 tiles: one tile geometry for the tiled commands


def _call(main, argv, **kw):
    """(exit code, stdout bytes, stderr text) of ``main(argv)``."""
    out = io.TextIOWrapper(io.BytesIO())
    err = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, **kw)
    out.flush()
    return rc, out.buffer.getvalue(), err.getvalue()


def _mps(text):
    return re.sub(r"[\d.]+ MP/s", "MP/s", text)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The inputs, and every command's result by the JAX package's CLI:
    {name: (exit code, stdout, stderr, output file bytes or None)}."""
    from dwt_tpu import cli as jcli
    from dwt_tpu_torch.io import pnm

    mp = pytest.MonkeyPatch()
    mp.setenv("DWT_NO_COMPILE_CACHE", "1")  # the JAX CLI's cache: off
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(12)
    pnm.write_pnm(str(d / "rgb.pnm"), random_image(rng, W, H, 3, "mixed"))
    pnm.write_pnm(str(d / "tiny.pnm"), random_image(rng, 7, 20, 1, "mixed"))
    runs = {}
    for name, argv in _commands(d).items():
        out = d / f"jax-{name}"
        rc, so, se = _call(jcli.main, [a.replace("OUT", str(out))
                                       for a in argv])
        runs[name] = (rc, so, se, out.read_bytes() if out.exists() else None)
        if name in ("encode", "tiled-encode"):  # inputs of later commands
            (d / f"{name}.out").write_bytes(runs[name][3])
        if name == "encode":  # cut inside its root band
            (d / "corrupt.dwt").write_bytes(runs[name][3][:9])
    mp.undo()
    return d, runs


def _commands(d):
    return {
        "encode": ["encode", str(d / "rgb.pnm"), "OUT"],
        "encode capacity": ["encode", str(d / "rgb.pnm"), "OUT", "400"],
        "encode stdout": ["encode", str(d / "rgb.pnm"), "-"],
        "too small": ["encode", str(d / "tiny.pnm"), "OUT"],
        "tiled-encode": ["tiled-encode", str(d / "rgb.pnm"), "OUT", "16",
                         "900"],
        "decode": ["decode", str(d / "encode.out"), "OUT"],
        "decode pixels": ["decode", str(d / "encode.out"), "OUT", "100"],
        "decode dwtt": ["decode", str(d / "tiled-encode.out"), "OUT"],
        "decode corrupt": ["decode", str(d / "corrupt.dwt"), "OUT"],
        "usage": ["recode", "a", "b"],
    }


@pytest.mark.parametrize("name", ["encode", "encode capacity",
                                  "encode stdout", "too small",
                                  "tiled-encode", "decode", "decode pixels",
                                  "decode dwtt", "decode corrupt"])
def test_cli_equals_jax(files, name):
    from dwt_tpu_torch import cli

    d, runs = files
    out = d / f"port-{name}"
    argv = [a.replace("OUT", str(out)) for a in _commands(d)[name]]
    rc, so, se = _call(cli.main, argv, device="cpu")
    jrc, jso, jse, jout = runs[name]
    assert rc == jrc
    assert so == jso
    assert _mps(se) == _mps(jse)
    assert (out.read_bytes() if out.exists() else None) == jout
    if name.startswith("decode") and name != "decode corrupt":
        assert jout[:2] in (b"P5", b"P6")
    if name in ("too small", "decode corrupt"):
        assert rc == 1 and jout is None


def test_cli_usage_and_no_card(files, monkeypatch):
    """A bad mode prints the usage and exits 1; without a card, and
    without DWT_DEVICE=cpu, the CLI prints the error and exits 1; with it,
    it runs on the CPU."""
    from dwt_tpu_torch import cli

    d, runs = files
    rc, so, se = _call(cli.main, _commands(d)["usage"])
    assert (rc, so) == runs["usage"][:2] == (1, b"")
    assert se.startswith("usage: dwt_tpu_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DWT_DEVICE", raising=False)
    out = d / "nocard.dwt"
    argv = ["encode", str(d / "rgb.pnm"), str(out)]
    rc, so, se = _call(cli.main, argv)
    assert rc == 1 and "no CUDA device" in se and not out.exists()
    monkeypatch.setenv("DWT_DEVICE", "cpu")
    assert _call(cli.main, argv)[0] == 0
    assert out.read_bytes() == runs["encode"][3]


def test_cli_trace_and_selfcheck(files, monkeypatch, tmp_path):
    """DWT_TRACE=<dir> writes a trace of the run; DWT_SELFCHECK=1 reaches
    the encoder (its decode runs) and leaves the stream as it is."""
    from dwt_tpu_torch import cli
    from dwt_tpu_torch.codec import decoder

    d, runs = files
    monkeypatch.setenv("DWT_TRACE", str(tmp_path / "trace"))
    monkeypatch.setenv("DWT_SELFCHECK", "1")
    checked = []
    real = decoder.decode
    monkeypatch.setattr(decoder, "decode",
                        lambda *a, **k: (checked.append(1), real(*a, **k))[1])
    rc, so, _ = _call(cli.main, ["encode", str(d / "rgb.pnm"), "-"],
                      device="cpu")
    assert rc == 0 and so == runs["encode"][3]
    assert checked
    traces = list((tmp_path / "trace").glob("*.json"))
    assert traces and "aten::" in traces[0].read_text()
