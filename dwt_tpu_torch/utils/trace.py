"""Tracing and profiling harness.

Port of ``dwt_tpu/utils/trace.py``.  The reference's observability is
three stderr bit-count lines (encode.c:176,180,230); the port adds
structured stats (``encoder.encode_with_stats``) and, here, two tools:

* :func:`device_trace` — a context manager around ``torch.profiler`` that
  writes a Chrome trace of the region: every CUDA kernel and copy when a
  card is present, and the host's operators always.  Enabled on the CLI
  with ``DWT_TRACE=<dir>``.
* :class:`StageTimer` — wall-clock stage accounting with explicit device
  syncs, for MP/s breakdowns.

Both only observe: neither changes any number or stream byte.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the enclosed region, written on exit as
    ``<log_dir>/trace_<pid>.json`` (Chrome trace format: open it in
    Perfetto, or grep it for the kernels' names)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class StageTimer:
    """Accumulates named wall-clock stage timings.

    ``mark(name, *sync)`` first waits for the card's work on every CUDA
    tensor among ``sync`` (pass each stage's outputs), so that a stage's
    time includes its device work; CPU tensors and numpy arrays need no
    wait.
    """

    def __init__(self):
        self.stages: list[tuple[str, float]] = []
        self._t0 = time.perf_counter()

    def mark(self, name: str, *sync):
        for x in sync:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                torch.cuda.synchronize(x.device)
        now = time.perf_counter()
        self.stages.append((name, now - self._t0))
        self._t0 = now

    def report(self) -> str:
        total = sum(s for _, s in self.stages)
        lines = [f"{n:28s} {s * 1e3:9.2f} ms ({s / total:5.1%})"
                 for n, s in self.stages]
        lines.append(f"{'total':28s} {total * 1e3:9.2f} ms")
        return "\n".join(lines)
