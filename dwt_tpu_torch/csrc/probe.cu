// The tile engines' one-time probe (ops/hilbert_gather.py:engine_supported)
// as one host call: the production gather and scatter kernels on one
// 32x32 tile that holds arange, through the identity source index (the
// scatter with the tile's one-square, one-run table, built here), then
// one compare launch that counts the values that are not arange.
//
// Replaces dwt_tpu/ops/pallas_hilbert.py:engine_supported, which sends one
// 32x32 tile through its Mosaic tile flatten and falls back to XLA
// gathers when the build rejects it.  Here a wrong value or a failed
// launch makes the caller raise; nothing falls back.
//
// Bound: none worth the name (8 KB in, 8 KB out).  Its time is host
// latency: one ctypes call issues the three launches from C, and the
// caller reads one pair of ints back.
#include "common.cuh"

extern "C" int dwt_hilbert_gather(const void* co, const void* src, void* out,
                                  int64_t nlin, int C, int nframes,
                                  int64_t frame_elems, void* stream);
extern "C" int dwt_hilbert_scatter(const void* lin, const void* src,
                                   const void* sq_ptr, const void* runs,
                                   void* out, int H, int W, int64_t L, int C,
                                   int64_t nruns, int group, void* stream);

namespace {

constexpr int SIDE = 32;  // the probe tile: one square of the scatter
constexpr int N = SIDE * SIDE;

// One block of n threads: bad[0] counts out[i] != i, bad[1] out[n + i] != i.
__global__ void probe_compare_kernel(const int* __restrict__ out, int n,
                                     int* __restrict__ bad) {
  const int i = threadIdx.x;
  const int g = __syncthreads_count(out[i] != i);
  const int s = __syncthreads_count(out[n + i] != i);
  if (i == 0) bad[0] = g, bad[1] = s;
}

}  // namespace

// The tile's run table: one square holding one run, positions [0, N).
// Plain device globals with external linkage, so each device's copy has
// an address (cudaGetSymbolAddress) to hand the scatter kernel.
__device__ int dwt_probe_sq_ptr[2] = {0, 1};
__device__ int dwt_probe_runs[2] = {0, N};

// tile: (n,) int32 arange, idx: (n,) int32 source index (the identity),
// out: (2n,) int32, the gathered row then the scattered tile; bad: (2,)
// int32 mismatch counts.  n = 32 * 32: the tile is one square of the
// scatter kernel, with the one-run table above.
extern "C" int dwt_engine_probe(const void* tile, const void* idx, void* out,
                                void* bad, int n, void* stream) {
  if (n != N) return (int)cudaErrorInvalidValue;
  void *sq_ptr = nullptr, *runs = nullptr;  // on the current device
  cudaError_t e = cudaGetSymbolAddress(&sq_ptr, dwt_probe_sq_ptr);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&runs, dwt_probe_runs);
  if (e != cudaSuccess) return (int)e;
  int rc = dwt_hilbert_gather(tile, idx, out, n, 1, 1, n, stream);
  if (rc) return rc;
  rc = dwt_hilbert_scatter(tile, idx, sq_ptr, runs, (int*)out + n,
                           SIDE, SIDE, n, 1, 1, 1, stream);
  if (rc) return rc;
  probe_compare_kernel<<<1, n, 0, (cudaStream_t)stream>>>((const int*)out, n,
                                                          (int*)bad);
  return (int)cudaGetLastError();
}
