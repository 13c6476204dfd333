"""The port's benchmark (``bench_torch``) on the CPU, at tiny sizes: its
``BENCHMARK.json``, its frames, its kernel byte counts, its gates and its
output.  The rates it prints here are the CPU's and name it; the card's
numbers come only from a run on the card."""

import contextlib
import hashlib
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch import cells, kernels, measure, run

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CELLS = ("uhd4k-encode", "uhd4k-decode", "uhd4k-preview", "fhd-batch64",
         "uhd16k-tiled", "uhd4k-capacity", "uhd16k-tiled-sharded")
SHARDED = "uhd16k-tiled-sharded"
# Metrics that only a CUDA device gives.
DEVICE_METRICS = ({"idle_share", "d2h_copies", "h2d_copies", "peak_mem_gib",
                   "build_s"}
                  | {f"{k}_{m}" for k in kernels.KERNELS
                     for m in ("ms", "roofline")})


@contextlib.contextmanager
def jax_hidden():
    """``sys.modules`` without JAX and the JAX package for the block (the
    tests' conftest imports JAX, and some tests make digests with the JAX
    package), put back after it: the run's own check then sees only what
    the run itself imports, as in a process of its own."""
    held = {m: sys.modules.pop(m) for m in measure.foreign_modules()}
    try:
        yield
    finally:
        for m in measure.foreign_modules():
            del sys.modules[m]
        sys.modules.update(held)


def bench(capsys, tmp_path, *args) -> tuple:
    """``python3 -m bench_torch.run --device cpu --tiny *args`` in this
    process, with JAX hidden from it (:func:`jax_hidden`): (exit code, the
    JSON lines of its standard output)."""
    with jax_hidden():
        rc = run.main(["--device", "cpu", "--tiny", "--out", str(tmp_path),
                       *args])
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(line) for line in lines]


def _cpu_ctx(cell: str, seed: int) -> cells.Ctx:
    """A tiny CPU context for ``cell`` in this process: the sharded cell on
    a mesh of one rank (no process group)."""
    mesh = None
    if cells.CELLS[cell][3] > 1:
        from dwt_tpu_torch.parallel import hosts

        mesh = hosts.global_mesh("cpu")
    return cells.Ctx(cells.TINY, seed, torch.device("cpu"), "cpu", mesh)


def test_benchmark_json_has_the_five_one_chip_cells():
    """The five first cells, then the capacity encode (one chip) and the
    sharded tiled encode (four), as ``cells.CELLS`` runs them; no cell
    lists a metric of kernel 6, which no path runs."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = spec["workloads"]
    assert [w["name"] for w in work] == list(CELLS) == list(cells.CELLS)
    for w in work:
        assert w["chips"] == cells.CELLS[w["name"]][3] \
            == (4 if w["name"] == SHARDED else 1)
        assert w["config"] == cells.CELLS[w["name"]][0] in spec["configs"]
        assert w["traffic"]["timed_passes"] == cells.CELLS[w["name"]][1]
        assert not [m for m in w["layer_metrics"] if "transpose" in m]
        assert len(w["source"]) <= 200
        assert w["command"].startswith("python3 -m bench_torch.run")
        for name, m in w["metrics"].items():
            assert name in ("encode_mps", "decode_mps")
            assert m["unit"] == "MP/s" and m["higher_is_better"]
            assert 0.05 <= m["regression_bound"] < 1
        assert set(w["layer_metrics"]) <= set(run.UNITS)
    ends = {n for w in work for n in w["metrics"]}
    assert ends == {"encode_mps", "decode_mps"}
    assert set(spec["metrics"]) <= set(run.UNITS)


@pytest.mark.parametrize("cell", CELLS)
def test_frames_are_deterministic_from_the_seed(cell):
    a = cells.frames(cell, cells.TINY, 3)
    b = cells.frames(cell, cells.TINY, 3)
    c = cells.frames(cell, cells.TINY, 4)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    first = (np.asarray(a) if cell.startswith("uhd16k")
             else np.asarray(a)[0])
    w, h = first.shape[1], first.shape[0]
    assert np.array_equal(first, cells.random_image(w, h, 3))
    if cell == "fhd-batch64":
        assert np.asarray(a).shape == (15, 24, 40, 3)


def test_kernel_byte_counts_equal_their_closed_forms():
    i32 = torch.int32
    # gather: index, (N, H, W, C) coefficients, (N, C, nlin) out
    co = torch.zeros((2, 8, 8, 3), dtype=i32)
    src = torch.arange(70, dtype=i32)
    assert kernels.gather_bytes(torch, co, src) == 4 * (70 + 384 + 420)
    # kernel 16: the int32 coefficients read, the bias table read, the
    # image (uint8, or int32) written; kernel 8: 9 bytes a token
    x = torch.zeros((2, 8, 9, 3), dtype=i32)
    bias = torch.zeros((2, 3, 16), dtype=i32)
    assert kernels.inverse_work(torch, x, (), True, True, bias) \
        == (432 * 5 + 4 * 96, 0)
    assert kernels.inverse_work(torch, x, (), True, False) == (432 * 8, 0)
    vli = torch.zeros((3, 40), dtype=torch.bool)
    vli[1, :7] = True
    assert kernels.vli_work(torch, torch.zeros((3, 40), dtype=i32), vli) \
        == (9 * 120, kernels.VLI_OPS_PER_TOKEN * 7)
    # scatter: the index, the valid pixels of each row, the plane out
    lin = torch.zeros((6, 50), dtype=i32)
    s = torch.full((8, 9), -1, dtype=i32)
    s.view(-1)[:40] = torch.arange(40, dtype=i32)
    s.view(-1)[40] = 60  # past lin's length: not read
    sq = torch.zeros(2, dtype=i32)
    runs = torch.zeros((5, 2), dtype=i32)
    assert kernels.scatter_bytes(torch, lin, s, sq, runs) \
        == 4 * (72 + 6 * (40 + 72))
    # pack: 16 B a token, each word with a nonzero piece
    widx = torch.tensor([0, 0, 2, 5, 9], dtype=i32)
    c0 = torch.tensor([1, 1, 1, 1, 1], dtype=i32)
    c1 = torch.tensor([0, 1, 0, 1, 0], dtype=i32)   # words 1, 6
    c2 = torch.tensor([0, 0, 0, 1, 1], dtype=i32)   # words 7, 11 (dropped)
    # words 0, 2, 5, 9 + 1, 6 + 7 = 7 words below nwords = 10
    assert kernels.pack_bytes(torch, widx, c0, c1, c2, 10) == 16 * 5 + 4 * 7
    # kernels A and B: units over rows of 1,024 elements
    vmag = torch.zeros((300, 1024), dtype=i32)
    meta = torch.zeros((3, 8), dtype=i32)
    #          row, len, plane, window, offset, carry, count
    meta[0] = torch.tensor([0, 2000, 3, 10, 0, 0, 5, 0])
    meta[1] = torch.tensor([1, 500, 2, 40, 7, 0, 900, 0])  # rows overlap
    meta[2] = torch.tensor([200, 100, 1, 0, 0, 0, 0, 0])   # not live
    elements = 2000  # [0, 2000) and [1024, 1524) overlap
    pairs = 5 + 500  # at most count, at most its elements
    assert kernels.unit_elements(torch, vmag, meta) == elements
    assert kernels.compact_bytes(torch, vmag, meta, 10_000) \
        == 4 * (elements + 24 + pairs)
    assert kernels.compact_bytes(torch, vmag, meta, 100) \
        == 4 * (elements + 24 + 100)
    # B: unit 0's bits [320, 325) -> word 10; unit 1's [1287, 2187) ->
    # words 40-68
    words = torch.zeros(100, dtype=i32)
    assert kernels.refbits_bytes(torch, vmag, meta, words) \
        == 4 * (elements + 24 + 2 * (1 + 29))


def test_kernel_byte_counts_on_the_codecs_calls():
    """The counter reads every kernel of the encode and decode paths and
    counts the same bytes whatever the kernel: on the CPU the wrappers run
    their plain versions, and the counts still follow the call's data.
    Kernel 6 has no key: the VLI order scan reads the token arrays in
    place.  The profiled pass's marks before each kernel call leave the
    stream as it was, and count one call a call site, as the warm-up's
    counter does."""
    from dwt_tpu_torch.codec import decoder, encoder

    img = cells.random_image(96, 64, 0)
    acc = {}
    with measure.kernel_bytes(torch, acc) as ncalls:
        s = encoder.encode(img, device="cpu")
        decoder.decode(s, device="cpu")
    assert set(acc) == set(ncalls) == set(kernels.KERNELS)
    assert "transpose" not in acc
    assert all(n > 0 for n in acc.values())
    again = {}
    with measure.kernel_bytes(torch, again) as ncalls, \
            measure.marked(torch) as calls:
        assert encoder.encode(img, device="cpu") == s
    decode_only = {"scatter", "inverse"}
    assert again == {k: v for k, v in acc.items() if k not in decode_only}
    assert calls == ncalls == {k: 1 for k in kernels.KERNELS
                               if k not in decode_only}
    for k in kernels.KERNELS:  # each call site holds its ops wrapper
        fn = getattr(*kernels.site(k))
        assert fn.__module__.startswith("dwt_tpu_torch.ops.")
        assert fn.__name__ == kernels.KERNELS[k].name


class _Event:
    """A profiler event as :func:`measure.kernel_readings` reads one."""

    def __init__(self, device, name, id, start, end):
        from torch.autograd import DeviceType

        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.name, self.id = name, id
        self.time_range = types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start)


def test_kernel_readings_follow_the_launch_records():
    """A call's device time is that of its CUDA kernels among the device
    events of the launches made inside its range (not a PyTorch fill it
    launched, not a launch outside it); a launch with no device event, or
    an event of its kernels that no launch of its calls claims, makes the
    reading incomplete and says where."""
    from torch.autograd import DeviceType

    def session(drop=(), stray=False):
        ev = [_Event(False, "bench::lifting", 0, 10, 50),
              _Event(False, "bench::lifting", 0, 60, 90),
              _Event(False, "bench::pack", 0, 100, 120)]
        # (host time, id, device name): the lifting's two calls launch a
        # fill and two levels, then one level; the pack one kernel; a
        # fill between the calls belongs to none.
        for t, i, name in ((12, 1, "void at::native::fill_kernel<int>"),
                           (20, 2, "void lift_level_kernel<4>(Params)"),
                           (30, 3, "lift_tail_kernel"),
                           (55, 4, "void at::native::fill_kernel<int>"),
                           (70, 5, "void lift_level_kernel<2>(Params)"),
                           (110, 6, "pack_words_kernel")):
            ev.append(_Event(False, "cudaLaunchKernelExC_v11060"
                             if i == 3 else "cudaLaunchKernel", i, t, t + 1))
            if i not in drop:
                ev.append(_Event(True, name, i, 200 + i, 200 + 2 * i))
        if stray:
            ev.append(_Event(True, "lift_level_kernel", 9, 300, 310))
        return measure.kernel_readings(ev, DeviceType)

    x = session()
    assert x["launches"]["lifting"] == x["events"]["lifting"] == 4
    assert x["kernel_ms"]["lifting"] == pytest.approx((2 + 3 + 5) / 1e3)
    assert x["kernel_ms"]["pack"] == pytest.approx(6 / 1e3)
    assert x["launches"]["pack"] == 1 and x["launches"]["gather"] == 0
    assert all(x["complete"].values())
    x = session(drop=(5,))
    assert x["missing"]["lifting"] == [[1, 0]]
    assert x["events"]["lifting"] == 3 and not x["complete"]["lifting"]
    assert x["complete"]["pack"]
    x = session(drop=(1,))  # a fill's event lost: still not whole
    assert x["missing"]["lifting"] == [[0, 0]]
    assert not x["complete"]["lifting"]
    x = session(stray=True)
    assert x["unclaimed"]["lifting"] == 1 and not x["complete"]["lifting"]
    assert x["complete"]["pack"]


def test_marks_are_ranges_of_the_profiler():
    """Each kernel call of the profiled pass is one profiler range named
    by its key, which the launch records are read within."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dwt_tpu_torch.codec import encoder

    img = cells.random_image(96, 64, 0)
    with measure.marked(torch) as calls, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        encoder.encode(img, device="cpu")
    marks = [e.name[len(measure.MARK):] for e in prof.events()
             if e.device_type == DeviceType.CPU
             and e.name.startswith(measure.MARK)]
    assert sorted(marks) == sorted(calls) and set(calls.values()) == {1}


def test_kernel_numbers_come_from_sessions_with_every_event(monkeypatch):
    """A profiled session that misses an event of a kernel call's launches
    is taken again; a kernel's time and roofline share come only from
    sessions whose reading of it is whole, and read "not measured" when
    there is none."""
    def reading(kernel_ms, complete, calls=1):
        used = {k: calls if k in ("scatter", "pack") else 0
                for k in kernels.KERNELS}
        return {"wall": 10.0, "busy": 4.0, "d2h": 0, "h2d": 0,
                "kernel_ms": {k: kernel_ms for k in kernels.KERNELS},
                "calls": used, "launches": {k: 2 * n for k, n in used.items()},
                "events": {k: 2 * n - (not complete and k == "scatter")
                           for k, n in used.items()},
                "unclaimed": dict.fromkeys(kernels.KERNELS, 0),
                "missing": {k: [] if complete or k != "scatter" else [[0, 1]]
                            for k in kernels.KERNELS},
                "complete": {k: complete or k != "scatter"
                             for k in kernels.KERNELS}}

    seq = iter([reading(0.0, True),                     # the start-up
                reading(2.0, False), reading(2.0, True),  # request 0
                reading(9.0, False), reading(9.0, False),
                reading(9.0, False)])                   # request 1
    monkeypatch.setattr(measure, "profiled",
                        lambda torch, fn, calls: (fn(), next(seq))[1])
    called = {"scatter": 1, "pack": 1}
    warm = [(called, {"scatter": 3.35e9, "pack": 6.7e9})] * 2  # 1, 2 ms
    reqs = [cells.Request("decode_mps", "decode", 1.0, lambda: b"", None)
            for _ in range(2)]
    got = {m["metric"]: m for m in run.profile_metrics(
        torch, reqs, lambda *a: None, warm)}
    assert got["idle_share"]["value"] == pytest.approx(0.6)
    assert got["idle_share"]["retaken"] == 4
    assert got["scatter_ms"]["value"] == 2.0
    assert got["scatter_ms"]["sessions"] == "1/2"
    assert got["scatter_ms"]["calls"] == 1
    assert got["scatter_ms"]["launches"] == 2
    assert got["scatter_roofline"]["value"] == pytest.approx(0.5)
    assert got["pack_ms"]["value"] == pytest.approx((2.0 + 9.0) / 2)
    assert got["pack_roofline"]["value"] == pytest.approx(4.0 / 11.0)
    assert "gather_ms" not in got and "d2h_copies" not in got
    seq = iter([reading(0.0, True)] + [reading(1.0, False)] * 6)
    got = {m["metric"]: m for m in run.profile_metrics(
        torch, reqs, lambda *a: None, warm)}
    assert got["scatter_ms"]["value"] is None
    assert got["scatter_ms"]["note"] == "not measured"
    assert got["scatter_ms"]["events_short"] == [[1, 2]] * 2
    assert got["scatter_ms"]["missing"] == [[0, 1]]
    assert got["scatter_roofline"]["value"] is None
    # A request that made other kernel calls than its warm-up is retaken.
    seq = iter([reading(0.0, True)] + [reading(1.0, True, calls=2)] * 6)
    got = {m["metric"]: m for m in run.profile_metrics(
        torch, reqs, lambda *a: None, warm)}
    assert got["idle_share"]["retaken"] == 6
    assert got["pack_ms"]["value"] is None
    assert got["pack_ms"]["events_short"] == [[4, 4]] * 2


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_cpu_and_says_so(cell, capsys, tmp_path):
    rc, lines = bench(capsys, tmp_path, "--cells", cell, "--seed", "2")
    assert rc == 0
    assert all(x["card"] == "cpu" and x["device"] == "cpu"
               and x["scale"] == "tiny" and x["seed"] == 2 for x in lines)
    names = {x["metric"] for x in lines if x.get("cell") == cell}
    enc = {"encode_mps", "stage1_ms", "tokens_ms", "emit_ms"}
    dec = {"decode_mps", "parse_ms", "upload_ms", "tail_ms"}
    want = {"uhd4k-encode": enc, "uhd4k-decode": dec, "uhd4k-preview": dec,
            "fhd-batch64": enc, "uhd16k-tiled": enc | dec,
            "uhd4k-capacity": enc,
            SHARDED: enc | {"tiles_ms", "payloads_ms", "container_ms"}}[cell]
    assert names == want | {"setup_s"}
    for x in lines[:-1]:
        assert x["unit"] == run.UNITS[x["metric"]]
        if x["metric"].endswith("_mps"):  # the host beside every rate
            h = x["host"]
            assert len(h["loadavg_before"]) == len(h["loadavg_after"]) == 3
            assert h["cpus"] >= 1
            assert h["card_before"] is h["card_after"] is None
            assert h["process_cpu"] > 0
    # A rate is all the timed passes' megapixels over all their time; the
    # spread is that of the passes' rates, each pass a sum of requests.
    reqs = {"uhd4k-encode": 8, "uhd4k-decode": 8, "uhd4k-preview": 8,
            "fhd-batch64": 1, "uhd16k-tiled": 1, "uhd4k-capacity": 8,
            SHARDED: 1}[cell]
    rates = [x for x in lines[:-1] if x["metric"].endswith("_mps")]
    assert rates
    for x in rates:
        assert x["value"] == x["mpix"] / x["seconds"]
        assert x["passes"]["n"] == cells.TINY.max_passes
        assert x["requests"]["n"] == reqs * cells.TINY.max_passes
        assert x["passes"]["q1"] <= x["passes"]["median"] \
            <= x["passes"]["q3"]
    last = lines[-1]
    assert last["ok"] is True and last["correct"] == {cell: True}
    assert last["platform"]["platform"] == "cpu"
    assert set(last["cells"][cell]) == names
    files = list(tmp_path.glob("bench_seed2_*.jsonl"))
    assert len(files) == 1
    assert [json.loads(t) for t in files[0].read_text().splitlines()] \
        == lines


def _flip_stream(monkeypatch):
    from dwt_tpu_torch.codec import encoder

    real = encoder.encode

    def flipped(img, *a, **k):
        s = bytearray(real(img, *a, **k))
        s[len(s) // 2] ^= 0xFF
        return bytes(s)
    monkeypatch.setattr(encoder, "encode", flipped)


def _wrong_digest(monkeypatch):
    monkeypatch.setitem(cells.TINY.digests, 0, {
        "streams": [(1, "0" * 64)] * 8, "batch": (1, "0" * 64)})


def _not_a_prefix(monkeypatch):
    from dwt_tpu_torch.codec import tiled

    real = tiled.encode_tiled

    def cut_wrong(img, tile=(512, 512), budget=0, device=None):
        data = bytearray(real(img, tile, budget, device))
        if budget > 0:
            data[-1] ^= 0x01  # the last tile's last byte
        return bytes(data)
    monkeypatch.setattr(tiled, "encode_tiled", cut_wrong)


def _budgeted(monkeypatch, lengths):
    """Make every budgeted ``encode_tiled`` give the lossless container's
    tiles cut to ``lengths(lossless lengths, budget)``: prefixes of the
    lossless payloads, within the budget."""
    from dwt_tpu_torch.codec import tiled

    real = tiled.encode_tiled

    def cut(img, tile=(512, 512), budget=0, device=None):
        data = real(img, tile, 0, device)
        if budget <= 0:
            return data
        pls = cells.container_tiles(data)[4]
        n = lengths(np.array([len(p) for p in pls]), budget)
        out = data[:16] + np.asarray(n, "<u4").tobytes() + b"".join(
            p[:int(k)] for p, k in zip(pls, n))
        assert len(out) <= budget
        return out
    monkeypatch.setattr(tiled, "encode_tiled", cut)


def _zero_cuts(monkeypatch):
    _budgeted(monkeypatch, lambda full, budget: np.zeros_like(full))


def _lopsided(monkeypatch):
    """The first tiles whole, the rest empty, as far as the budget goes."""
    def lengths(full, budget):
        room = budget - 20 - 4 * full.size
        return np.where(np.cumsum(full) <= room, full, 0)
    _budgeted(monkeypatch, lengths)


def _wrong_tile_decode(monkeypatch):
    from dwt_tpu_torch.codec import tiled

    real = tiled.decode_tiled

    def off(data, *a, **k):
        img, gray = real(data, *a, **k)
        img = img.copy()
        img[-1, -1, 0] ^= 1  # the last tile's last pixel
        return img, gray
    monkeypatch.setattr(tiled, "decode_tiled", off)


@pytest.mark.parametrize("fault, failing, passing", [
    (_flip_stream, ("uhd4k-encode", "uhd4k-decode", "fhd-batch64",
                    "uhd4k-capacity"), "uhd16k-tiled"),
    (_wrong_digest, ("uhd4k-encode", "uhd4k-decode", "uhd4k-preview",
                     "fhd-batch64", "uhd4k-capacity"), "uhd16k-tiled"),
    (_not_a_prefix, ("uhd16k-tiled",), "uhd4k-decode"),
    (_zero_cuts, ("uhd16k-tiled",), "uhd4k-decode"),
    (_lopsided, ("uhd16k-tiled",), "uhd4k-decode"),
    (_wrong_tile_decode, ("uhd16k-tiled",), "uhd4k-decode"),
], ids=["flipped-byte", "wrong-digest", "not-a-prefix", "zero-cuts",
        "lopsided", "wrong-tile-decode"])
def test_a_failed_gate_fails_the_command_and_prints_no_metric(
        fault, failing, passing, monkeypatch, capsys, tmp_path):
    fault(monkeypatch)
    rc, lines = bench(capsys, tmp_path, "--cells",
                      ",".join(failing + (passing,)))
    assert rc != 0
    last = lines[-1]
    assert last["ok"] is False
    assert [c for c, ok in last["correct"].items() if not ok] \
        == list(failing)
    for c in failing:
        assert [x for x in lines if x.get("cell") == c] == [
            {"cell": c, "config": cells.CELLS[c][0], "correct": False,
             "error": next(x["error"] for x in lines
                           if x.get("cell") == c),
             "card": "cpu", "device": "cpu", "scale": "tiny", "seed": 0}]
        assert c not in last["cells"]
    assert last["correct"][passing] is True and passing in last["cells"]


def _allocations():
    """(name, layer ends (n, layers), budget, cuts, whether they keep the
    waterline) on a 3-tile table; the reserve is 20 + 4 * 3 = 32 bytes."""
    ends = np.array([[10, 30, 60], [5, 25, 45], [8, 18, 58]])
    ok = ((32 + 23, [10, 5, 8]),          # layer 0 whole in every tile
          (32 + 23 + 25, [30, 10, 8]),    # inside layer 1, in tile order
          (32 + 23 + 50, [30, 25, 18]),   # layer 1 whole
          (32 + 23 + 50 + 2, [32, 25, 18]),
          (32 + 163, [60, 45, 58]),       # the lossless tiles fit
          (32 + 500, [60, 45, 58]))
    bad = ((32 + 23 + 25, [10, 25, 8]),   # layer 1 not in tile order
           (32 + 23 + 25, [30, 5, 8]),    # 5 bytes of the budget unused
           (32 + 23 + 50 + 2, [30, 25, 20]),
           (32 + 23 + 50 + 2, [34, 25, 16]),  # past one waterline
           (32 + 23, [0, 0, 0]),          # every tile cut to nothing
           (32 + 500, [60, 45, 50]))      # lossless tiles fit, one cut
    return ([(f"ok{i}", ends, b, c, True) for i, (b, c) in enumerate(ok)]
            + [(f"bad{i}", ends, b, c, False)
               for i, (b, c) in enumerate(bad)])


@pytest.mark.parametrize("name, ends, budget, cuts, keeps",
                         _allocations(), ids=[a[0] for a in _allocations()])
def test_allocation_check_on_closed_cases(name, ends, budget, cuts, keeps):
    if keeps:
        cells.check_allocation(cuts, ends, budget)
    else:
        with pytest.raises(cells.GateError):
            cells.check_allocation(cuts, ends, budget)


def test_allocation_check_holds_the_reference_allocation():
    """The JAX package's ``allocate_budget`` keeps the waterline on random
    layer tables, zero-byte layers among them; moving one byte from one
    tile to another never does."""
    import jax.numpy as jnp

    from dwt_tpu.parallel.tiled import allocate_budget

    rng = np.random.default_rng(7)
    for trial in range(40):
        n, nl = rng.integers(1, 9), rng.integers(1, 6)
        per = rng.integers(0, 40, (n, nl)) * (rng.random((n, nl)) < 0.8)
        budget = int(rng.integers(0, per.sum() + 60)) + 20 + 4 * n
        cuts = np.asarray(allocate_budget(jnp.asarray(per, jnp.int32),
                                          budget - 20 - 4 * n))
        ends = np.cumsum(per, axis=1)
        cells.check_allocation(cuts, ends, budget)
        i, j = rng.integers(0, n, 2)
        if i != j and cuts[i] > 0 and cuts[j] < ends[j, -1]:
            moved = cuts.copy()
            moved[i] -= 1
            moved[j] += 1
            with pytest.raises(cells.GateError):
                cells.check_allocation(moved, ends, budget)


@pytest.mark.parametrize("cell", CELLS)
def test_every_span_fires_for_each_request(cell):
    """Each request's span pass fires every span its kind needs, so no
    layer metric reads a call that has moved."""
    from bench_torch import measure

    ctx = _cpu_ctx(cell, 1)
    reqs = cells.CELLS[cell][2](ctx)
    for r in reqs:
        r.check(r.run())  # as the warm-up pass: the decode reads its cut
        acc = {}
        with measure.spans(torch, ctx.device, r.kind, acc):
            r.run()
        assert {n for n, k in acc["calls"].items() if k > 0} \
            == set(measure.SPANS[r.kind])
        assert run.layer_values(r.kind, acc)


def test_a_span_that_does_not_fire_fails_the_cell(monkeypatch, capsys,
                                                  tmp_path):
    from bench_torch import measure
    from dwt_tpu_torch.codec import encoder

    real = measure.span_targets

    def moved(kind):
        out = real(kind)
        if kind == "encode":
            out["tokens"] = [(encoder, "_never_called")]
        return out
    monkeypatch.setattr(encoder, "_never_called", lambda: None,
                        raising=False)
    monkeypatch.setattr(measure, "span_targets", moved)
    rc, lines = bench(capsys, tmp_path, "--cells",
                      "uhd4k-encode,uhd4k-decode")
    assert rc != 0
    assert lines[-1]["correct"] == {"uhd4k-encode": False,
                                    "uhd4k-decode": True}
    err = [x for x in lines if x.get("cell") == "uhd4k-encode"]
    assert len(err) == 1 and "did not fire" in err[0]["error"]


@pytest.mark.parametrize("module, fails", [
    ("jax", True), ("jaxlib.xla_extension", True), ("flax", True),
    ("dwt_tpu.codec.encoder", True), ("jaxtyping", False),
    ("dwt_tpu_torch_extra", False)])
def test_a_cell_whose_process_imports_jax_fails(module, fails, monkeypatch,
                                                capsys, tmp_path):
    """A cell after whose passes the process holds a module of JAX or of
    the JAX package, or one of their submodules, fails with its error
    line; a module whose name only begins like one does not."""
    from dwt_tpu_torch.codec import encoder

    real, fake = encoder.encode, types.ModuleType(module)

    def importing(img, *a, **k):
        sys.modules.setdefault(module, fake)
        return real(img, *a, **k)
    monkeypatch.setattr(encoder, "encode", importing)
    rc, lines = bench(capsys, tmp_path, "--cells", "uhd4k-encode")
    if sys.modules.get(module) is fake:
        del sys.modules[module]
    assert lines[-1]["correct"] == {"uhd4k-encode": not fails}
    assert rc == int(fails)
    if fails:
        err, = [x for x in lines if x.get("cell") == "uhd4k-encode"]
        assert err["error"].startswith("ForeignError")
        assert module in err["error"]


def test_tiled_digest_gates_hold_against_the_jax_package(
        capsys, tmp_path, monkeypatch):
    """At the tiny size, the JAX package's lossless-then-cut containers
    (``encode_tiled_sharded`` on one device) and the pixels of the
    budgeted one's decode, given as the digests, hold; one of them off
    fails the cell."""
    import jax
    from jax.sharding import Mesh

    from dwt_tpu.codec.tiled import decode_tiled
    from dwt_tpu.parallel.encode import encode_tiled_sharded

    sc = cells.TINY
    img = cells.frames("uhd16k-tiled", sc, 0)
    mesh = Mesh(np.array(jax.devices()[:1]), ("y",))
    full = encode_tiled_sharded(img, mesh, tile=sc.tile)
    cut = encode_tiled_sharded(img, mesh, tile=sc.tile,
                               budget=len(full) // 3)
    pixels = cells.sha256_pixels(decode_tiled(cut)[0])
    want = (len(full), hashlib.sha256(full).hexdigest(), len(cut),
            hashlib.sha256(cut).hexdigest(), pixels)
    monkeypatch.setitem(sc.digests, 0, {"tiled": want})
    rc, lines = bench(capsys, tmp_path, "--cells", "uhd16k-tiled")
    assert rc == 0 and lines[-1]["ok"] is True
    for k in (1, 3, 4):
        monkeypatch.setitem(sc.digests, 0, {
            "tiled": want[:k] + ("0" * 64,) + want[k + 1:]})
        rc, lines = bench(capsys, tmp_path, "--cells", "uhd16k-tiled")
        assert rc != 0 and lines[-1]["correct"] == {"uhd16k-tiled": False}


def test_digest_gates_hold_against_the_jax_package(capsys, tmp_path,
                                                   monkeypatch):
    """At the tiny size, the JAX package's streams and preview pixels of
    seed 0's frames, given as the digests, hold: the gates compare what
    they should."""
    from dwt_tpu.codec.decoder import decode
    from dwt_tpu.codec.encoder import get_encoder

    sc = cells.TINY
    streams, prefix, reduced = [], [], []
    for img in cells.frames("uhd4k-encode", sc, 0):
        s = get_encoder(*sc.uhd, 3).encode(img)
        streams.append((len(s), hashlib.sha256(s).hexdigest()))
        for dst, p, px in ((prefix, s[:sc.prefix], 0),
                           (reduced, s, sc.pixels_max)):
            im, _ = decode(p, px)
            dst.append((im.shape, cells.sha256_pixels(im)))
    assert reduced[0][0][0] * reduced[0][0][1] <= sc.pixels_max
    assert reduced[0][0] != prefix[0][0]
    monkeypatch.setitem(sc.digests, 0, {
        "streams": streams, "prefix": prefix, "reduced": reduced})
    rc, lines = bench(capsys, tmp_path, "--cells",
                      "uhd4k-encode,uhd4k-preview")
    assert rc == 0 and lines[-1]["ok"] is True
    # one pixel digest off fails the preview alone
    monkeypatch.setitem(sc.digests, 0, {
        "streams": streams, "prefix": prefix,
        "reduced": reduced[:1] + [(reduced[1][0], "0" * 64)] + reduced[2:]})
    rc, lines = bench(capsys, tmp_path, "--cells",
                      "uhd4k-encode,uhd4k-preview")
    assert rc != 0
    assert lines[-1]["correct"] == {"uhd4k-encode": True,
                                    "uhd4k-preview": False}


def test_refuses_to_measure_without_a_card(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--tiny", "--cells", "uhd4k-encode", "--out",
                     str(tmp_path)]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    assert not list(tmp_path.iterdir())
    with pytest.raises(SystemExit):
        run.main(["--device", "cpu", "--cells", "no-such-cell"])


# The calls each kernel key's count reads on a tiny encode and decode, by
# the codec's own call sites.
NEW_KEYS = ("vli_scan", "lifting", "plane_stats", "schedule", "units",
            "packed", "finish", "codeword", "emit_tables", "inverse")


@pytest.fixture(scope="module")
def codec_calls():
    """{key: the arguments of its first call} of a tiny encode and decode
    on the CPU, kept at the call sites the benchmark wraps."""
    from bench_torch import measure
    from dwt_tpu_torch.codec import decoder, encoder

    kept = {}

    def keep(key):
        def wrap(fn):
            def run(*args, **kwargs):
                kept.setdefault(key, args)
                return fn(*args, **kwargs)
            return run
        return wrap

    with measure.wrapped([(*kernels.site(k), keep(k))
                          for k in kernels.KERNELS]):
        s = encoder.encode(cells.random_image(96, 64, 0), device="cpu")
        decoder.decode(s, device="cpu")
    return kept


def _old_count(key: str, args: tuple) -> int:
    """The bytes each of kernels 8-17 was counted for by ``chip_smoke.py``
    before its count moved to ``bench_torch/kernels.py``, written out
    again from its closed form."""
    from dwt_tpu_torch.ops import emit_tables, schedule
    from dwt_tpu_torch.ops.compact import E
    from dwt_tpu_torch.ops.plane_stats import PMAX

    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    if key == "vli_scan":
        return 9 * args[0].numel()
    if key == "lifting":
        return args[0].numel() * (args[0].element_size() + 4)
    if key == "plane_stats":
        lin, valid, chunk_base = args[0], args[1], args[5]
        R, n = lin.shape[0], valid.numel()
        return 4 * R * n + n + 4 * (R * chunk_base.numel() * (3 * PMAX + 1)
                                    + R)
    if key == "schedule":
        out = dict(zip(schedule.OUT_KEYS, schedule.schedule_plain(*args)))
        return (sum(size(t) for t in args if torch.is_tensor(t))
                + sum(size(t) for k, t in out.items()
                      if k not in ("planes", "planes_max", "T", "nS_ck")))
    if key == "units":
        N, S = args[0].shape
        U = args[4][0].numel()
        small = sum(4 * t.numel() for t in args[7:10])
        return 13 * N * S + 12 * N * U + small + 57 * N * U
    if key == "packed":
        lin, valid = args
        rows, n = lin.shape[0] * lin.shape[1], valid.numel()
        return 4 * rows * n + n + 4 * (rows * n + E)
    if key == "finish":
        N, npair = args[0].shape
        return sum(size(t) for t in args if torch.is_tensor(t)) \
            + 18 * N * npair
    if key == "codeword":
        val, site = args[0], args[4]
        return (33 * val.numel() + 4 * val.shape[0] * -(-val.shape[1] // 2048)
                + 8 * site.numel())
    if key == "emit_tables":
        N, S = args[2].shape
        U = args[14].shape[1]
        K = -(-args[1].shape[1] // 512) + -(-S // 8)
        named = dict(zip(emit_tables._IN_NAMES, args))
        reads = ("chunks", "planes", "planes_max", "nS_ck", "nZ_ck", "elem",
                 "elen", "p", "flat_step", "flat_ck", "valid", "ch_valid",
                 "level_chunk_base", "level_nchunk")
        return (28 * N * S + sum(size(named[k]) for k in reads)
                + 4 * N * S + 32 * N * U + 4 * (1 + N * (K + 64)))
    assert key == "inverse"
    x, to_bytes = args[0], args[3]
    bias = args[4] if len(args) > 4 else None
    return x.numel() * (5 if to_bytes else 8) + (
        0 if bias is None else 4 * bias.numel())


# Each new key's count in ``bench_torch/kernels.py``, by function name.
NEW_WORK = {"vli_scan": "vli_work", "lifting": "transform_work",
            "plane_stats": "plane_stats_work", "schedule": "schedule_work",
            "units": "units_work", "packed": "packed_work",
            "finish": "finish_work", "codeword": "codeword_work",
            "emit_tables": "emit_tables_work", "inverse": "inverse_work"}


@pytest.mark.parametrize("key", NEW_KEYS)
def test_new_byte_counts_equal_chip_smokes_on_the_codecs_calls(
        key, codec_calls):
    """Each count of kernels 8-17, on the codec's own call, equals its
    closed form and the bytes and operations that ``chip_smoke.py``'s own
    copy of the count gives (its ``kernel_work``; kernel 16's
    ``inverse_work``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_counts", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    args = codec_calls[key]
    nbytes = kernels.KERNELS[key].nbytes(torch, *args)
    assert nbytes == _old_count(key, args) > 0
    work = getattr(kernels, NEW_WORK[key])(torch, *args)
    assert work[0] == nbytes
    if key == "inverse":
        assert smoke.inverse_work(torch, args) == work
    else:
        assert smoke.kernel_work(torch, kernels.KERNELS[key].name,
                                 args) == work


# Kernel 6's CUDA kernels and the probe's own: no call of an encode or a
# decode launches them.  Kernels 18 and 19, the halo levels: no cell
# reaches the sharded encode and decode that launch them (PERF.md
# section 7).
UNTIMED = {"transpose_kernel", "transpose_bytes_kernel",
           "probe_compare_kernel", "halo_fwd_kernel", "halo_inv_kernel"}


def test_each_keys_cuda_names_are_kernels_of_its_source():
    """Each key's CUDA names are ``__global__`` kernels of ``csrc/``, and
    every kernel there but kernel 6's and the probe's belongs to exactly
    one key; a name matches a profiler event only as a whole
    identifier."""
    import re

    found = set()
    for src in (ROOT / "dwt_tpu_torch" / "csrc").glob("*.cu"):
        found |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(\w+)", src.read_text()))
    assert UNTIMED <= found
    named = [n for k in kernels.KERNELS.values() for n in k.cuda]
    assert len(named) == len(set(named))
    assert set(named) == found - UNTIMED
    assert kernels.is_kernel_of("lifting", "void lift_level_kernel<4>(P)")
    assert kernels.is_kernel_of("inverse", "inverse_level_kernel")
    assert not kernels.is_kernel_of("lifting", "inverse_level_kernel")
    assert not kernels.is_kernel_of("pack", "packed_elems_kernel")
    assert not kernels.is_kernel_of("units", "void units_kernel2()")


@pytest.mark.parametrize("cell", CELLS)
def test_layer_metrics_are_what_the_cells_run_prints(cell):
    """Every name in a cell's ``layer_metrics`` is one its run can print,
    and its kernel metrics are those of the kernels its requests call:
    the kernel metrics print wherever a request calls the kernel (a value
    or "not measured"), the spans by each request's kind, the copies for
    an encode."""
    from bench_torch import measure

    spec = {w["name"]: w for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]}[cell]
    reqs = cells.CELLS[cell][2](_cpu_ctx(cell, 0))
    printed = {"setup_s", "peak_mem_gib", "idle_share"}
    called = set()
    for r in reqs:
        r.check(r.run())  # as the warm-up pass: the decode reads its cut
        with measure.marked(torch) as calls:
            r.run()
        called |= {k for k, n in calls.items() if n}
        printed |= set(run.layer_values(r.kind, {
            **dict.fromkeys(measure.SPANS[r.kind], 0.0),
            "calls": dict.fromkeys(measure.SPANS[r.kind], 1)}))
        if r.kind != "decode":
            printed |= {"d2h_copies", "h2d_copies"}
    kernel_metrics = {f"{k}_{m}" for k in called for m in ("ms", "roofline")}
    listed = set(spec["layer_metrics"])
    assert listed <= printed | kernel_metrics
    assert {m for m in listed if m.endswith(("_ms", "_roofline"))
            and m[:m.rindex("_")] in kernels.KERNELS} == kernel_metrics


def test_capacity_cell_holds_the_jax_packages_capacity_streams(
        capsys, tmp_path, monkeypatch):
    """At the tiny size the JAX package's capacity encode of each frame is
    its lossless stream's prefix; with its lossless streams as the
    digests, the capacity cell's gates hold, so each of the port's
    capacity streams is the JAX package's."""
    from dwt_tpu.codec.encoder import get_encoder

    sc = cells.TINY
    streams = []
    for img in cells.frames("uhd4k-capacity", sc, 0):
        enc = get_encoder(*sc.uhd, 3)
        s = enc.encode(img)
        assert enc.encode(img, capacity=sc.capacity) == s[:sc.capacity]
        assert len(s) > sc.capacity
        streams.append((len(s), hashlib.sha256(s).hexdigest()))
    monkeypatch.setitem(sc.digests, 0, {"streams": streams})
    rc, lines = bench(capsys, tmp_path, "--cells", "uhd4k-capacity")
    assert rc == 0 and lines[-1]["correct"] == {"uhd4k-capacity": True}


def test_sharded_cell_gives_the_single_process_container(
        capsys, tmp_path, monkeypatch):
    """On 4 gloo ranks the sharded cell's containers, lossless and at a
    third of its bytes, are the single-process ``encode_tiled``'s: with
    those as the digests its gates hold on every rank; with the budgeted
    digest off by one byte the cell fails with its error line."""
    from dwt_tpu_torch.codec import tiled

    sc = cells.TINY
    img = cells.frames(SHARDED, sc, 0)
    full = tiled.encode_tiled(img, tile=sc.tile, device="cpu")
    cut = tiled.encode_tiled(img, tile=sc.tile, budget=len(full) // 3,
                             device="cpu")
    want = (len(full), hashlib.sha256(full).hexdigest(), len(cut),
            hashlib.sha256(cut).hexdigest(), "unused here")
    monkeypatch.setitem(sc.digests, 0, {"tiled": want})
    rc, lines = bench(capsys, tmp_path, "--cells", SHARDED)
    assert rc == 0 and lines[-1]["correct"] == {SHARDED: True}
    monkeypatch.setitem(sc.digests, 0, {"tiled": want[:2] + (
        len(cut) + 1,) + want[3:]})
    rc, lines = bench(capsys, tmp_path, "--cells", SHARDED)
    assert rc == 1 and lines[-1]["correct"] == {SHARDED: False}
    err, = [x for x in lines if x.get("cell") == SHARDED]
    assert err["correct"] is False and "budgeted container" in err["error"]


def test_sharded_cell_fails_on_fewer_than_four_cards(monkeypatch, capsys,
                                                     tmp_path):
    """Named alone on a machine of fewer cards than its ranks, the sharded
    cell starts nothing, prints its error line and the command exits 1;
    the default cells are the one-card cells."""
    from dwt_tpu_torch.runtime import build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(build, "build", lambda: ("lib", 0.0))
    monkeypatch.setattr(build, "library", lambda: None)
    monkeypatch.setattr(run, "card_label", lambda torch, device: "card")
    started = []
    monkeypatch.setattr(run.multiprocessing, "get_context",
                        lambda *a: started.append(a))
    assert run.main(["--tiny", "--cells", SHARDED, "--out",
                     str(tmp_path)]) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    err, = [x for x in lines if x.get("cell") == SHARDED]
    assert err["correct"] is False and "this machine has 1" in err["error"]
    assert lines[-1]["ok"] is False and not started
    assert run.default_cells() == list(CELLS[:6])
