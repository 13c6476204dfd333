"""The port's benchmark (``bench_torch``) on the CPU, at tiny sizes: its
``BENCHMARK.json``, its frames, its kernel byte counts, its gates and its
output.  The rates it prints here are the CPU's and name it; the card's
numbers come only from a run on the card."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch import cells, kernels, run

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CELLS = ("uhd4k-encode", "uhd4k-decode", "uhd4k-preview", "fhd-batch64",
         "uhd16k-tiled")
# Metrics that only a CUDA device gives.
DEVICE_METRICS = ({"idle_share", "d2h_copies", "h2d_copies", "peak_mem_gib",
                   "build_s"}
                  | {f"{k}_{m}" for k in kernels.KERNELS
                     for m in ("ms", "roofline")})


def bench(capsys, tmp_path, *args) -> tuple:
    """``python3 -m bench_torch.run --device cpu --tiny *args`` in this
    process: (exit code, the JSON lines of its standard output)."""
    rc = run.main(["--device", "cpu", "--tiny", "--out", str(tmp_path),
                   *args])
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(line) for line in lines]


def test_benchmark_json_has_the_five_one_chip_cells():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = spec["workloads"]
    assert [w["name"] for w in work] == list(CELLS) == list(cells.CELLS)
    for w in work:
        assert w["chips"] == 1
        assert w["config"] == cells.CELLS[w["name"]][0]
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
    first = np.asarray(a)[0] if cell != "uhd16k-tiled" else np.asarray(a)
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
    # transpose: read and written
    for dt, size in ((torch.int32, 4), (torch.int8, 1)):
        x = torch.zeros((7, 130), dtype=dt)
        assert kernels.transpose_bytes(torch, x) == 2 * 7 * 130 * size
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
    Kernel 6 (``transpose``) is on neither path: the VLI order scan reads
    the token arrays in place.  The profiled pass's marks before each
    kernel call leave the stream as it was."""
    from bench_torch import measure
    from dwt_tpu_torch.codec import decoder, encoder

    img = cells.random_image(96, 64, 0)
    acc = {}
    with measure.kernel_bytes(torch, acc):
        s = encoder.encode(img, device="cpu")
        decoder.decode(s, device="cpu")
    assert set(acc) == set(kernels.KERNELS) - {"transpose"}
    assert all(n > 0 for n in acc.values())
    again, before = {}, measure.launches()
    with measure.kernel_bytes(torch, again), measure.marked(torch):
        assert encoder.encode(img, device="cpu") == s
        assert measure.launches() == before  # read through the wraps
    assert again == {k: v for k, v in acc.items() if k != "scatter"}
    for k in kernels.KERNELS:
        assert kernels.wrapper(k) is getattr(*kernels.site(k))


def test_kernel_numbers_come_from_sessions_with_every_event(monkeypatch):
    """A profiled session that misses a launch's kernel event is taken
    again; a kernel's time and roofline share come only from sessions
    with an event for each of its launches, and read "not measured" when
    there is none."""
    from bench_torch import measure

    def reading(kernel_ms, complete, launches=1):
        return {"wall": 10.0, "busy": 4.0, "d2h": 0, "h2d": 0,
                "kernel_ms": {k: kernel_ms for k in kernels.KERNELS},
                "launches": {k: launches if k in ("scatter", "pack") else 0
                             for k in kernels.KERNELS},
                "complete": {k: complete or k != "scatter"
                             for k in kernels.KERNELS}}

    seq = iter([reading(0.0, True),                     # the start-up
                reading(2.0, False), reading(2.0, True),  # request 0
                reading(9.0, False), reading(9.0, False),
                reading(9.0, False)])                   # request 1
    # As measure.profiled does: the launch counts read around the call,
    # within the marks of the profiled pass.
    monkeypatch.setattr(measure, "profiled", lambda torch, fn: (
        measure.launches(), fn(), measure.launches(), next(seq))[3])
    launched = {k: int(k in ("scatter", "pack")) for k in kernels.KERNELS}
    warm = [(launched, {"scatter": 3.35e9, "pack": 6.7e9})] * 2  # 1, 2 ms
    reqs = [cells.Request("decode_mps", "decode", 1.0, lambda: b"", None)
            for _ in range(2)]
    got = {m["metric"]: m for m in run.profile_metrics(
        torch, reqs, lambda *a: None, warm)}
    assert got["idle_share"]["value"] == pytest.approx(0.6)
    assert got["idle_share"]["retaken"] == 4
    assert got["scatter_ms"]["value"] == 2.0
    assert got["scatter_ms"]["sessions"] == "1/2"
    assert got["scatter_roofline"]["value"] == pytest.approx(0.5)
    assert got["pack_ms"]["value"] == pytest.approx((2.0 + 9.0) / 2)
    assert got["pack_roofline"]["value"] == pytest.approx(4.0 / 11.0)
    assert "gather_ms" not in got and "d2h_copies" not in got
    seq = iter([reading(0.0, True)] + [reading(1.0, False)] * 6)
    got = {m["metric"]: m for m in run.profile_metrics(
        torch, reqs, lambda *a: None, warm)}
    assert got["scatter_ms"]["value"] is None
    assert got["scatter_ms"]["note"] == "not measured"
    assert got["scatter_roofline"]["value"] is None


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
            "fhd-batch64": enc, "uhd16k-tiled": enc | dec}[cell]
    assert names == want | {"setup_s"}
    for x in lines[:-1]:
        assert x["unit"] == run.UNITS[x["metric"]]
    # A rate is all the timed passes' megapixels over all their time; the
    # spread is that of the passes' rates, each pass a sum of requests.
    reqs = {"uhd4k-encode": 8, "uhd4k-decode": 8, "uhd4k-preview": 8,
            "fhd-batch64": 1, "uhd16k-tiled": 1}[cell]
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
    (_flip_stream, ("uhd4k-encode", "uhd4k-decode", "fhd-batch64"),
     "uhd16k-tiled"),
    (_wrong_digest, ("uhd4k-encode", "uhd4k-decode", "uhd4k-preview",
                     "fhd-batch64"), "uhd16k-tiled"),
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

    ctx = cells.Ctx(cells.TINY, 1, torch.device("cpu"), "cpu")
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
