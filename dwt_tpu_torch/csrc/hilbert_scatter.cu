// Decoder's inverse linearization: (C, L) int32 scan-order coefficients
// -> (H, W, C) int32 image plane, out[y, x, c] = lin[c, src[y*W + x]],
// and 0 where src is outside [0, L) (-1 marks the root band, whose raster
// crop the caller writes).
//
// Replaces dwt_tpu/ops/pallas_hilbert.py:hilbert_scatter_pallas (kernel
// _scatter_kernel), which places 32x32 tiles with constant one-hot MXU
// matmuls, 128-lane read windows and "partial" tiles merged through an
// ownership mask, because a TPU gather costs ~8 ns an index.  On Hopper
// the static permutation arrives as a precomputed int32 source index per
// output pixel, and the scatter becomes a gather.
//
// Bound: bytes.  Each pixel reads its index (4 B) and C values of lin and
// writes C values.  One thread per pixel, consecutive threads on
// consecutive pixels, so the index reads and the C contiguous output
// writes are coalesced, every output element is written once (no
// zero-fill pass) and no two threads write one element.  The reads of lin
// follow the Hilbert curve: a warp's 32 pixels of one row lie in one or
// two 32x32 squares of a level, i.e. within ~1K curve positions, which
// the next rows of the square read again from L2.
#include "common.cuh"

__global__ void hilbert_scatter_kernel(const int* __restrict__ lin,
                                       const int* __restrict__ src,
                                       int* __restrict__ out, int64_t npix,
                                       int64_t L, int C) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < npix;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int s = __ldg(src + i);
    const bool ok = s >= 0 && s < L;
    for (int c = 0; c < C; ++c)
      out[i * C + c] = ok ? __ldg(lin + c * L + s) : 0;
  }
}

extern "C" int dwt_hilbert_scatter(const void* lin, const void* src,
                                   void* out, int64_t npix, int64_t L, int C,
                                   void* stream) {
  const int threads = 256;
  hilbert_scatter_kernel<<<grid_for(npix, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)lin, (const int*)src, (int*)out, npix, L, C);
  return (int)cudaGetLastError();
}
