"""A CUDA source of the port built for the CPU, its blocks run as threads.

``build(source)`` compiles ``dwt_tpu_torch/csrc/<source>`` with g++ and
the CUDA shim below into a shared library whose C entry points take host
pointers.  Each block's threads are threads of this process (a grid's
blocks one after the other on the same threads), with a barrier for
``__syncthreads``, a per-warp one for ``__syncwarp`` and the shuffles'
exchange, the block's dynamic shared memory a host buffer and its static
``__shared__`` arrays statics.  The source is the card's, built with
``HALO_HOST`` defined, under which it leaves its ``cp.async`` wrappers and
its dynamic shared memory to the shim: a copy that breaks the card's
alignment rule aborts, fills its destination with a marker byte when it
is issued and lands when a ``cp_wait`` lets its group complete, so a read
of a ring slot before its wait sees the marker.  Its ``<<<...>>>``
launches become calls of the shim.  It checks the kernels' indexing,
barriers and waits on the CPU; it says nothing of their speed.
"""

from __future__ import annotations

import ctypes
import functools
import re
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "dwt_tpu_torch" / "csrc"

SHIM = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define HALO_HOST
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct int4 { int x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return int4{a, b, c, d}; }
using std::max;
using std::min;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorInvalidConfiguration = 9 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct Emu {
  std::barrier<>* block;
  std::barrier<>* warp;
  int* lanes;
  char* smem;
};
struct EmuCopy {
  char* dst;
  const char* src;
};
extern thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
extern thread_local Emu emu;
extern thread_local std::vector<EmuCopy> emu_open;
extern thread_local std::vector<std::vector<EmuCopy>> emu_groups;
extern int emu_sms, emu_per_sm;
inline void __syncthreads() { emu.block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu.warp->arrive_and_wait(); }
inline int emu_shfl(int v, int d) {
  const int lane = threadIdx.x & 31, src = lane + d;
  emu.lanes[lane] = v;
  emu.warp->arrive_and_wait();
  const int r = (src < 0 || src > 31) ? v : emu.lanes[src];
  emu.warp->arrive_and_wait();
  return r;
}
inline int __shfl_up_sync(unsigned, int v, int d) { return emu_shfl(v, -d); }
inline int __shfl_down_sync(unsigned, int v, int d) { return emu_shfl(v, d); }
// cp.async: 16 bytes, landing when their group completes.
inline void cp16(char* d, const char* s) {
  if (((uintptr_t)d | (uintptr_t)s) & 15) std::abort();  // the card's rule
  std::memset(d, 0xa5, 16);
  emu_open.push_back({d, s});
}
inline void cp_commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}
template <int N>
inline void cp_wait() {
  while ((int)emu_groups.size() > N) {
    for (const EmuCopy& c : emu_groups.front())
      std::memcpy(c.dst, c.src, 16);
    emu_groups.erase(emu_groups.begin());
  }
}
inline char* dynamic_smem() { return emu.smem; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emu_sms;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
  *n = emu_per_sm;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// A grid of `grid` blocks of nt threads, one after the other on the same
// nt threads, a barrier between two.
template <typename F>
void emu_run(int grid, int nt, size_t smem, F f) {
  std::barrier<> block(nt), between(nt);
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<std::vector<int>> lanes;
  std::vector<char> mem(smem + 16, (char)0x5a);
  for (int w = 0; w < nt / 32; ++w) {
    warps.emplace_back(new std::barrier<>(32));
    lanes.emplace_back(32);
  }
  char* m = mem.data();
  m += (16 - ((uintptr_t)m & 15)) & 15;
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t)
    ts.emplace_back([&, t]() {
      threadIdx = dim3(t);
      blockDim = dim3(nt);
      gridDim = dim3(grid);
      emu = Emu{&block, warps[t / 32].get(), lanes[t / 32].data(), m};
      for (int b = 0; b < grid; ++b) {
        blockIdx = dim3(b);
        f();
        if (!emu_open.empty() || !emu_groups.empty()) std::abort();
        between.arrive_and_wait();
      }
    });
  for (auto& t : ts) t.join();
}
template <typename K, typename... A>
void emu_launch(K kernel, unsigned grid, int nt, size_t smem, cudaStream_t,
                A... args) {
  emu_run(grid, nt, smem, [&]() { kernel(args...); });
}
"""

GLOBALS = """
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local Emu emu;
thread_local std::vector<EmuCopy> emu_open;
thread_local std::vector<std::vector<EmuCopy>> emu_groups;
int emu_sms = 3, emu_per_sm = 2;
extern "C" void emu_card(int sms, int per_sm) {
  emu_sms = sms;
  emu_per_sm = per_sm;
}
"""


def host_source(text: str) -> str:
    """The card's source as the shim compiles it: its launches calls."""
    text, n = re.subn(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", text)
    assert n >= 1, "no launch to rewrite"
    return "#include <cuda_runtime.h>\n" + text + GLOBALS


@functools.lru_cache(maxsize=None)
def build(source: str) -> ctypes.CDLL:
    """``csrc/<source>`` built for the CPU and loaded (once a process)."""
    tmp = Path(tempfile.mkdtemp(prefix="cuda_cpu_"))
    (tmp / "cuda_runtime.h").write_text(SHIM)
    cpp = tmp / (Path(source).stem + ".cpp")
    cpp.write_text(host_source((CSRC / source).read_text()))
    lib = tmp / (Path(source).stem + ".so")
    r = subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                        f"-I{tmp}", f"-I{CSRC}", "-Wno-unknown-pragmas",
                        "-o", str(lib), str(cpp), "-lpthread"],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ of {source} failed:\n{r.stderr[-4000:]}")
    return ctypes.CDLL(str(lib))
