"""The port's on-card self-test (``python -m dwt_tpu_torch.selftest``) on
the CPU: its JSON contract and exit codes, each kernel configuration's
plain version against its numpy oracle (``--device cpu``, one subprocess
run per module), and that every oracle catches a wrong kernel result."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
KERNEL_CONFIGS = ["gather", "compact", "refbits", "pack", "scatter",
                  "transpose", "probe"]


def _selftest(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "dwt_tpu_torch.selftest", *args], cwd=ROOT,
        env={**os.environ, **(env or {})}, capture_output=True, text=True,
        timeout=600)


@pytest.fixture(scope="module")
def cpu_run():
    return _selftest("--device", "cpu")


def test_cpu_run_contract(cpu_run):
    """Every kernel configuration ok on its plain version, encode and
    decode n/a, one stderr line a configuration in order, exit 0."""
    assert cpu_run.returncode == 0, cpu_run.stderr
    results = json.loads(cpu_run.stdout.strip().splitlines()[-1])
    assert results == {**{k: "ok" for k in KERNEL_CONFIGS},
                       "encode": "n/a", "decode": "n/a"}
    lines = [ln for ln in cpu_run.stderr.splitlines()
             if ln.startswith("selftest ")]
    assert lines == [f"selftest {k}: {v}" for k, v in results.items()]


def test_no_card_exits_1():
    """Without a card and without --device cpu: a one-line error naming
    the missing device, no result, exit 1."""
    r = _selftest("--configs", "gather", env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1 and r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_results_and_exit_codes(monkeypatch, capsys):
    """ok, fail, timeout and n/a from the configurations' processes, the
    configurations named by --configs only, and exit 1 unless every
    configuration run is ok; bad arguments exit 2."""
    from dwt_tpu_torch import selftest

    codes = {"gather": 0, "pack": 1, "probe": "timeout"}

    def fake(cmd, timeout, cwd):
        name = cmd[cmd.index("--child") + 1]
        assert cmd[cmd.index("--device") + 1] == "cpu"
        if codes[name] == "timeout":
            raise subprocess.TimeoutExpired(cmd, timeout)
        return subprocess.CompletedProcess(cmd, codes[name])

    monkeypatch.setattr(selftest.subprocess, "run", fake)
    rc = selftest.main(["--device", "cpu", "--configs",
                        "gather,pack,probe,encode"])
    out, err = capsys.readouterr()
    assert rc == 1
    assert json.loads(out) == {"gather": "ok", "pack": "fail",
                               "probe": "timeout", "encode": "n/a"}
    assert err.splitlines() == ["selftest gather: ok", "selftest pack: fail",
                                "selftest probe: timeout",
                                "selftest encode: n/a"]
    assert selftest.main(["--device", "cpu", "--configs", "gather"]) == 0
    capsys.readouterr()
    for bad in (["--configs", "nope"], ["--device", "tpu"], ["--size"]):
        assert selftest.main(bad) == 2


def _corrupt(fn):
    """``fn`` with the first element of its result changed."""
    def run(*args):
        out = fn(*args)
        out.view(-1)[0] ^= 1
        return out
    run.launches = fn.launches
    return run


@pytest.mark.parametrize("name,module,attr", [
    ("gather", "hilbert_gather", "hilbert_gather"),
    ("compact", "compact", "compact_tokens"),
    ("refbits", "compact", "scatter_refbits"),
    ("pack", "pack", "pack_words"),
    ("scatter", "hilbert_scatter", "hilbert_scatter"),
    ("transpose", "transpose", "transpose2d"),
    ("probe", "hilbert_gather", "engine_probe")])
def test_each_oracle_catches_a_wrong_result(monkeypatch, name, module, attr):
    """A configuration holds in this process, and fails when its kernel
    wrapper gets one value wrong."""
    import importlib

    from dwt_tpu_torch import selftest

    assert selftest.check(name, "cpu")
    mod = importlib.import_module(f"dwt_tpu_torch.ops.{module}")
    real = getattr(mod, attr)
    if attr == "engine_probe":
        def wrong(tile, idx, out, bad):
            real(tile, idx, out, bad)
            out[0] ^= 1
        monkeypatch.setattr(mod, attr, wrong)
    else:
        monkeypatch.setattr(mod, attr, _corrupt(real))
    assert not selftest.check(name, "cpu")


def test_own_image_generator_equals_the_tests():
    """The self-test keeps its own copy of tests/imagegen.py's images."""
    from imagegen import random_image

    from dwt_tpu_torch import selftest

    for kind in ("mixed", "noise"):
        a = selftest.random_image(np.random.default_rng(3), 37, 21, 3, kind)
        b = random_image(np.random.default_rng(3), 37, 21, 3, kind)
        assert np.array_equal(a, b)
