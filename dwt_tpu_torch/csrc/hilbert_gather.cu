// Stage-1 linearization: (H, W, C) int32 coefficients -> (C, nlin) int32
// in the padded scan order of hilbert.padded_layout(pyr, ALIGN).
//
// Replaces dwt_tpu/ops/pallas_hilbert.py:hilbert_gather_pallas (kernel
// _gather_kernel), which permutes 32x32 tiles with constant one-hot MXU
// matmuls because a TPU gather costs ~8 ns an index.  On Hopper a gather
// through L2 is cheap, so the static permutation arrives as a precomputed
// int32 source index per output slot (-1 for pads and the root band,
// which write 0; the caller writes the root raster crop).
//
// Bound: bytes.  Each output slot reads its index (4 B) and C source
// values and writes C values; the C reads of one pixel share a sector.
// One thread per slot, consecutive threads on consecutive slots, so the
// index reads and the C output rows are coalesced; the source reads
// follow the Hilbert curve, which keeps them within a few 32x32 squares
// per warp and so in L2.
#include "common.cuh"

__global__ void hilbert_gather_kernel(const int* __restrict__ co,
                                      const int* __restrict__ src,
                                      int* __restrict__ out, int64_t nlin,
                                      int C) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nlin;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int s = __ldg(src + i);
    for (int c = 0; c < C; ++c)
      out[c * nlin + i] = s >= 0 ? __ldg(co + (int64_t)s * C + c) : 0;
  }
}

extern "C" int dwt_hilbert_gather(const void* co, const void* src, void* out,
                                  int64_t nlin, int C, void* stream) {
  const int threads = 256;
  hilbert_gather_kernel<<<grid_for(nlin, threads), threads, 0,
                          (cudaStream_t)stream>>>(
      (const int*)co, (const int*)src, (int*)out, nlin, C);
  return (int)cudaGetLastError();
}
